"""Block-parallel radix-4 K=7 Viterbi: the hand-written Hopper kernel, its
plain PyTorch version, the build and the launch counter.

Port of the Pallas TPU kernel ``sora_tpu/ops/viterbi_pallas.py::
decode_blocks`` (its ``pl.pallas_call`` of ``_kernel``), bit for bit:

* soft inputs are quantized to ``round(8 x)`` (half to even) clamped to
  +-7;
* each stream is cut into windows of ``block + 2*overlap`` steps (zero
  erasures outside the stream) and each window keeps its middle ``block``
  bits;
* start metrics are 0, except in a stream's first window, where every
  state but 0 starts at ``PM_CLAMP`` (a soft pin); with ``terminated``
  the last window ends in state 0;
* the forward walk advances 4 trellis steps per iteration: target state t
  has the sixteen 4-step predecessors s = 16*(t&3) + j, candidate
  ``16*(pm[s] - bm(t, j)) + j`` (bm the +-1-weighted sum of the step's
  eight quantized soft values), the minimum wins (so the lowest j on a
  tie), then the metrics are renormalized by their minimum and clamped at
  ``PM_CLAMP`` once per radix-4 step;
* the end state is the lowest-index minimum, and the traceback reads
  bits (state>>2)&1 .. state>>5 then steps to 16*(state&3) + d.

The kernel computes each radix-4 step as four radix-2 sub-steps on the
same packed keys (equal bit for bit, see the note at the head of
``csrc/viterbi.cu``); the plain version keeps the TPU's formulation.

The kernel is ``csrc/viterbi.cu``, built with nvcc for ``sm_90a`` into a
shared library with a C interface (loaded with ctypes) under ``_build/``
at first use, and rebuilt when the source is newer.  :func:`decode_blocks`
launches it for CUDA tensors and takes :func:`decode_blocks_reference`
only for CPU tensors; a CUDA call with no nvcc, a failed build or a
launch error raises.  ``LAUNCHES`` counts the kernel's launches; while
a span records (``util.spans``) the counter ``viterbi.steps_run`` adds
the trellis steps the windows compute, rows x windows x (block + 2 x
overlap).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from sora_tpu_torch.phy import common as C
from sora_tpu_torch.util import spans

SOFT_SCALE = 8.0
SOFT_CLAMP = 7.0
PM_CLAMP = 120

# Kernel launches made by decode_blocks (a plain integer; reset it to 0
# before a run to see how many launches that run made).
LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "viterbi.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libsora_viterbi.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# =============================================================================
# The radix-4 ACS constant and the plain PyTorch version
# =============================================================================


def _parity(v: np.ndarray, g: int) -> np.ndarray:
    p = np.zeros_like(v)
    for i in range(7):
        if (g >> i) & 1:
            p = p ^ ((v >> i) & 1)
    return p


@lru_cache(maxsize=None)
def _acs_matrix() -> np.ndarray:
    """The fused radix-4 ACS constant M (1024, 73) int8 of the TPU kernel.

    Row r = 64j + t: candidate for target state t via 4-step predecessor
    s = 16*(t&3) + j.  cand_packed = M @ [pm; s8; 1] =
    16*(pm[s] - bm(t, j)) + j, where bm is the +-1-weighted sum of the
    eight quantized soft values of the step (coded bits A/B at input
    times 4m..4m+3) and the trailing column carries the packed index j.
    """
    r = np.arange(1024)[:, None]
    j = r >> 6
    t = r & 63
    s = 16 * (t & 3) + j
    Mpm = 16 * (np.arange(64)[None, :] == s)
    # input bits b1..b4 at times 4m..4m+3: t = (b4 b3 b2 b1 | s>>4)
    cols = []
    st = s
    for b in [(t >> 2) & 1, (t >> 3) & 1, (t >> 4) & 1, t >> 5]:
        reg = (b << 6) | st
        cols.append(2 * _parity(reg, C.G0) - 1)
        cols.append(2 * _parity(reg, C.G1) - 1)
        st = (b << 5) | (st >> 1)
    Ms = np.concatenate(cols, axis=1)                     # (1024, 8)
    return np.concatenate([Mpm, -16 * Ms, j], axis=1).astype(np.int8)


@lru_cache(maxsize=None)
def _acs_matrix_t(device: torch.device) -> torch.Tensor:
    """(73, 1024) fp32 transpose of :func:`_acs_matrix` on ``device``.
    Every product in ``[pm; s8; 1] @ M.T`` is a small integer and every
    sum stays below 2^24, so the fp32 matmul is exact in any order (and
    under TF32 too: its operands are integers below 2^11)."""
    return torch.as_tensor(_acs_matrix().T.astype(np.float32), device=device)


def _check_geometry(block: int, overlap: int) -> None:
    if block <= 0 or block % 8 or overlap < 0 or overlap % 8:
        raise ValueError(
            f"block ({block}) and overlap ({overlap}) must be multiples of "
            "8, block > 0")


def _quantize(s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(s * SOFT_SCALE), -SOFT_CLAMP, SOFT_CLAMP)


def decode_blocks_reference(soft_ab: torch.Tensor, block: int = 512,
                            overlap: int = 64,
                            terminated: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, vectorized over all windows.

    It runs the TPU kernel's own formulation: per radix-4 step one fp32
    matmul of the window metrics and soft values against the ACS constant
    (exact, see :func:`_acs_matrix_t`), a min over the 16 packed
    candidates, renorm and clamp; then a vectorized traceback.
    soft_ab: (..., T, 2) float (positive => coded bit 1).  Returns
    (..., T) uint8 decoded bits on the input's device.
    """
    _check_geometry(block, overlap)
    lead = soft_ab.shape[:-2]
    T = soft_ab.shape[-2]
    dev = soft_ab.device
    s = _quantize(soft_ab.reshape(-1, T, 2).float())
    B = s.shape[0]
    nblk = -(-T // block)
    Tpad = nblk * block
    win = block + 2 * overlap
    nstep = win // 4
    s = torch.cat([s.new_zeros(B, overlap, 2), s,
                   s.new_zeros(B, Tpad - T + overlap, 2)], dim=1)
    wins = s.unfold(1, win, block)                      # (B, nblk, 2, win)
    R = B * nblk
    wk = wins.permute(0, 1, 3, 2).reshape(R, nstep, 8)  # step m: times 4m..
    row = torch.arange(R, device=dev)
    states = torch.arange(64, device=dev)
    first = (row % nblk == 0)[:, None]
    pm = torch.where(first & (states != 0)[None, :], PM_CLAMP, 0).to(
        torch.int32)
    Mt = _acs_matrix_t(dev)
    ones = torch.ones(R, 1, device=dev)
    dec = torch.empty(nstep, R, 64, dtype=torch.uint8, device=dev)
    for m in range(nstep):
        v = torch.cat([pm.float(), wk[:, m], ones], dim=1)     # (R, 73)
        cand = (v @ Mt).to(torch.int32).reshape(R, 16, 64)  # row 64j + t
        mm = cand.min(dim=1).values                          # j in bits 0-3
        dec[m] = (mm & 15).to(torch.uint8)
        p = mm >> 4                                     # arithmetic shift
        p = p - p.min(dim=1, keepdim=True).values
        pm = torch.clamp(p, max=PM_CLAMP)
    # best end state: lowest index among the minima; the last window of a
    # terminated stream ends in state 0
    mn = pm.min(dim=1, keepdim=True).values
    s_end = torch.where(pm <= mn, states[None, :], 64).min(dim=1).values
    if terminated:
        last = row % nblk == nblk - 1
        s_end = torch.where(last, 0, s_end)
    state = s_end.to(torch.int64)
    shifts = torch.arange(2, 6, device=dev)             # bits b1..b4
    bits = torch.zeros(R, nstep, 4, dtype=torch.uint8, device=dev)
    for m in range(nstep - 1, overlap // 4 - 1, -1):
        bits[:, m] = ((state[:, None] >> shifts) & 1).to(torch.uint8)
        d = dec[m].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = 16 * (state & 3) + d
    bits = bits.reshape(R, win)[:, overlap: overlap + block]
    bits = bits.reshape(B, Tpad)[:, :T]
    return bits.reshape(*lead, T)


# =============================================================================
# Build, load and launch the CUDA kernel
# =============================================================================


def _nvcc(source: Path = SOURCE) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(f"sora_tpu_torch: nvcc not found; the kernel "
                       f"({source}) cannot be built")


def build(force: bool = False, source: Path = SOURCE,
          library: Path = LIBRARY) -> str:
    """Compile ``source`` (csrc/viterbi.cu) into ``library``
    (_build/libsora_viterbi.so) when the library is missing or older than
    the source (or ``force``).  Returns nvcc's output (ptxas register and
    shared-memory report), or "" when the library was current.  Raises
    when nvcc is missing or fails.  ``ops/correlate_cuda.py`` builds its
    kernel through it too."""
    if (not force and library.exists()
            and library.stat().st_mtime >= source.stat().st_mtime):
        return ""
    nvcc = _nvcc(source)
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)          # atomic: concurrent builds stay safe
    return proc.stdout + proc.stderr


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.sora_viterbi_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.sora_viterbi_decode.restype = ctypes.c_int
    lib.sora_viterbi_error_string.argtypes = [ctypes.c_int]
    lib.sora_viterbi_error_string.restype = ctypes.c_char_p
    return lib


def decode_blocks(soft_ab: torch.Tensor, block: int = 512,
                  overlap: int = 64, terminated: bool = False
                  ) -> torch.Tensor:
    """Block-parallel radix-4 Viterbi decode (see the module docstring).

    soft_ab: (..., T, 2) float soft metrics (positive => coded bit 1).
    Returns (..., T) uint8 decoded bits.  A CUDA tensor launches the
    Hopper kernel (one launch per call); a CPU tensor runs
    :func:`decode_blocks_reference`; any other device raises.
    """
    global LAUNCHES
    _check_geometry(block, overlap)
    if soft_ab.dim() < 2 or soft_ab.shape[-1] != 2:
        raise ValueError(f"decode_blocks: soft_ab must be (..., T, 2), "
                         f"got {tuple(soft_ab.shape)}")
    if spans.recording():
        T = soft_ab.shape[-2]
        spans.count("viterbi.steps_run", soft_ab.shape[:-2].numel()
                    * -(-T // block) * (block + 2 * overlap))
    if soft_ab.device.type == "cpu":
        return decode_blocks_reference(soft_ab, block, overlap, terminated)
    if soft_ab.device.type != "cuda":
        raise ValueError(f"decode_blocks: unsupported device {soft_ab.device}")
    lead = soft_ab.shape[:-2]
    T = soft_ab.shape[-2]
    s = soft_ab.reshape(-1, T, 2).to(torch.float32).contiguous()
    if s.data_ptr() % 8:                 # the kernel reads (sA, sB) as float2
        s = s.clone()
    B = s.shape[0]
    out = torch.empty(B, T, dtype=torch.uint8, device=s.device)
    if B == 0 or T == 0:
        return out.reshape(*lead, T)
    lib = _library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = lib.sora_viterbi_decode(s.data_ptr(), out.data_ptr(), B, T,
                                     block, overlap, int(terminated), stream)
    if rc != 0:
        raise RuntimeError("sora_viterbi_decode launch failed: "
                           + lib.sora_viterbi_error_string(rc).decode())
    LAUNCHES += 1
    return out.reshape(*lead, T)
