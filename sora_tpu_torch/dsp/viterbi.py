"""K=7 (133,171) Viterbi decoding — torch (port of ``sora_tpu.dsp.viterbi``).

* :func:`decode_auto` is the receiver's entry point.  It makes the window
  choices of the JAX package's TPU branch (those choices change the output
  bits at low SNR) and runs the radix-4 decoder of ``ops.viterbi_cuda``:
  the Hopper kernel for a CUDA tensor, its plain PyTorch version for a CPU
  tensor.
* :func:`decode` (exact full-trellis) and :func:`decode_blocks` (overlapping
  blocks) are the float butterfly decoders of the JAX package's CPU branch,
  kept as a second oracle.  The two predecessors of state ``s`` are
  ``2*(s%32)`` and ``2*(s%32)+1`` and its input bit is ``s>>5``
  (``phy.common.BFLY_*``), so one add-compare-select step is strided
  slices, adds and a min over the batch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.ops import viterbi_cuda as vc
from sora_tpu_torch.phy import common as C

# (32, 2, 2) [u, pred j, input b] -> +1 where the emitted bit is 1, else -1
_SGN_A = (2.0 * C.BFLY_OUT_A - 1.0).astype(np.float32)
_SGN_B = (2.0 * C.BFLY_OUT_B - 1.0).astype(np.float32)


@lru_cache(maxsize=None)
def _signs(device: torch.device):
    """Per-(j, b) sign rows, shape (1, 32) each, on ``device``."""
    return {(j, b): (torch.as_tensor(_SGN_A[None, :, j, b], device=device),
                     torch.as_tensor(_SGN_B[None, :, j, b], device=device))
            for j in (0, 1) for b in (0, 1)}


def _acs_step(pm: torch.Tensor, soft_t: torch.Tensor, sgn: dict):
    """One add-compare-select step.

    pm: (B, 64) path metrics; soft_t: (B, 2) A/B soft values (positive =>
    coded bit 1).  Returns (pm_next, decisions (B, 64) bool, True = the
    odd predecessor won).
    """
    sa = soft_t[:, :1]
    sb = soft_t[:, 1:]
    pmA = pm[:, 0::2]                                   # pred 2u
    pmB = pm[:, 1::2]                                   # pred 2u+1
    outs = []
    decs = []
    for b in (0, 1):
        a0, b0 = sgn[(0, b)]
        a1, b1 = sgn[(1, b)]
        candA = pmA - (a0 * sa + b0 * sb)
        candB = pmB - (a1 * sa + b1 * sb)
        outs.append(torch.minimum(candA, candB))
        decs.append(candA > candB)
    pm_next = torch.cat(outs, dim=1)                    # states u+32b
    pm_next = pm_next - pm_next[:, :1]                  # cheap renorm
    return pm_next, torch.cat(decs, dim=1)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (int64)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    mn = x.min(dim=-1, keepdim=True).values
    return torch.where(x <= mn, idx, x.shape[-1]).min(dim=-1).values


def _walk(pm0: torch.Tensor, steps: torch.Tensor):
    """Forward ACS over steps (B, T, 2); returns (pm_final, decs (T, B, 64))."""
    sgn = _signs(steps.device)
    pm = pm0
    decs = []
    for t in range(steps.shape[1]):
        pm, d = _acs_step(pm, steps[:, t], sgn)
        decs.append(d)
    return pm, torch.stack(decs, dim=0)


def _traceback(s_end: torch.Tensor, decs: torch.Tensor) -> torch.Tensor:
    """Walk decisions (T, B, 64) back from s_end (B,); returns (B, T)."""
    state = s_end
    bits = []
    for t in range(decs.shape[0] - 1, -1, -1):
        bits.append((state >> 5).to(torch.uint8))
        d = decs[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = 2 * (state & 31) + d
    return torch.stack(bits[::-1], dim=1)


def decode(soft_ab: torch.Tensor, terminated: bool = True) -> torch.Tensor:
    """Exact Viterbi decode.

    soft_ab: (..., T, 2) float soft metrics (positive => coded bit 1;
    0 = erasure).  Returns (..., T) uint8 decoded input bits.
    ``terminated=True`` assumes the encoder ends in state 0 (the 802.11
    tail bits); otherwise the best end state is used.
    """
    lead = soft_ab.shape[:-2]
    T = soft_ab.shape[-2]
    s = soft_ab.reshape(-1, T, 2).float()
    B = s.shape[0]
    pm0 = torch.full((B, 64), 1e9, dtype=torch.float32, device=s.device)
    pm0[:, 0] = 0.0
    pm_final, decs = _walk(pm0, s)
    if terminated:
        s_end = torch.zeros(B, dtype=torch.int64, device=s.device)
    else:
        s_end = _first_argmin(pm_final)
    return _traceback(s_end, decs).reshape(*lead, T)


def decode_blocks(soft_ab: torch.Tensor, block: int = 512, overlap: int = 96,
                  terminated: bool = True) -> torch.Tensor:
    """Trellis-parallel float decode: batch over overlapping blocks.

    Equivalent to :func:`decode` except survivor paths are only tracked
    ``overlap`` steps across block boundaries.  soft_ab: (..., T, 2); T is
    padded up to a block multiple internally.
    """
    lead = soft_ab.shape[:-2]
    T = soft_ab.shape[-2]
    s = soft_ab.reshape(-1, T, 2).float()
    B = s.shape[0]
    nblk = -(-T // block)
    Tpad = nblk * block
    win = block + 2 * overlap
    # pad tail with erasures; pad overlap margins with erasures too
    s = torch.cat([s.new_zeros(B, overlap, 2), s,
                   s.new_zeros(B, Tpad - T + overlap, 2)], dim=1)
    # block i covers [i*block - overlap, (i+1)*block + overlap)
    wins = s.unfold(1, win, block).permute(0, 1, 3, 2).reshape(
        B * nblk, win, 2)
    R = B * nblk
    first = (torch.arange(R, device=s.device) % nblk) == 0
    known_start = torch.full((64,), 1e9, device=s.device)
    known_start[0] = 0.0
    pm0 = torch.where(first[:, None], known_start[None, :],
                      torch.zeros(R, 64, device=s.device))
    pm_final, decs = _walk(pm0, wins)
    s_end = _first_argmin(pm_final)
    if terminated:
        # only the last block ends in a known state
        last = (torch.arange(R, device=s.device) % nblk) == (nblk - 1)
        s_end = torch.where(last, 0, s_end)
    bits = _traceback(s_end, decs)                      # (R, win)
    bits = bits.reshape(B, nblk, win)[:, :, overlap: overlap + block]
    return bits.reshape(B, Tpad)[:, :T].reshape(*lead, T)


def decode_auto(soft_ab: torch.Tensor, terminated: bool = True,
                blockwise: bool = True) -> torch.Tensor:
    """The receiver's decoder: the radix-4 kernel with the JAX package's
    TPU-branch windows — T >= 4096: block 1024, overlap 64; 1024 < T <
    4096: block 512, overlap 64; otherwise (or without ``blockwise``) one
    window of ceil(T/8)*8 steps with no overlap.  Runs on the tensor's
    device (kernel on CUDA, plain version on the CPU)."""
    T = soft_ab.shape[-2]
    if blockwise and T > 1024:
        if T >= 4096:
            return vc.decode_blocks(soft_ab, block=1024, overlap=64,
                                    terminated=terminated)
        return vc.decode_blocks(soft_ab, block=512, overlap=64,
                                terminated=terminated)
    block = -(-T // 8) * 8
    return vc.decode_blocks(soft_ab, block=block, overlap=0,
                            terminated=terminated)


def encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 convolutional encode (batched): (..., T) -> (..., 2T) uint8.

    The two output streams are parities of sliding 7-bit windows: XORs
    over static shifts of the input, no scan.
    """
    lead = bits.shape[:-1]
    T = bits.shape[-1]
    b = bits.reshape(-1, T).to(torch.uint8)
    padded = torch.cat([b.new_zeros(b.shape[0], 6), b], dim=1)
    # window w[t] = [x_t, x_{t-1}, ..., x_{t-6}]; taps g MSB = newest bit
    outa = torch.zeros_like(b)
    outb = torch.zeros_like(b)
    for i in range(7):
        tap = padded[:, 6 - i: 6 - i + T]
        if (C.G0 >> (6 - i)) & 1:
            outa = outa ^ tap
        if (C.G1 >> (6 - i)) & 1:
            outb = outb ^ tap
    out = torch.stack([outa, outb], dim=-1).reshape(-1, 2 * T)
    return out.reshape(*lead, 2 * T)
