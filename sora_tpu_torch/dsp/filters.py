"""Streaming filter/correlator primitives — torch, batched (port of
``sora_tpu.dsp.filters``).

The reference's FIR/decimation/correlation bricks (TDownSample2 in
samples.hpp, pulse shaping RRC in pulse.hpp, CCA correlators in cca.hpp)
become dense batched tensor ops: correlation against a short pattern is a
matmul over a window-unfolded view or, for long streams, a sum of
statically shifted scaled copies; decimation is a strided slice.  Every
function works over the last axis and computes on its input's device.
"""

from __future__ import annotations

import numpy as np
import torch


def _pad_last(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad the last axis by ``lo`` in front and ``hi`` behind."""
    parts = [x]
    if lo:
        parts.insert(0, x.new_zeros(x.shape[:-1] + (lo,)))
    if hi:
        parts.append(x.new_zeros(x.shape[:-1] + (hi,)))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def decimate2(x: torch.Tensor, phase: int = 0) -> torch.Tensor:
    """40 -> 20 Msps downsample (TDownSample2, samples.hpp:11-47)."""
    return x[..., phase::2]


def window_view(x: torch.Tensor, width: int, stride: int = 1) -> torch.Tensor:
    """(..., N) -> (..., nwin, width) sliding windows (a strided view)."""
    return x.unfold(-1, width, stride)


def correlate(x: torch.Tensor, pattern) -> torch.Tensor:
    """Cross-correlation sum_k x[n+k] * conj(p[k]) for every offset n.

    Returns (..., N - len(p) + 1), as 4 real matmuls over the unfolded
    windows: no FFT needed for short patterns.
    """
    p = torch.as_tensor(pattern, device=x.device).to(torch.complex64)
    v = window_view(x.to(torch.complex64), p.shape[-1])   # (..., nwin, w)
    rr = v.real @ p.real + v.imag @ p.imag
    ri = v.imag @ p.real - v.real @ p.imag
    return torch.complex(rr, ri)


def correlate_stream(x: torch.Tensor, pattern) -> torch.Tensor:
    """Like :func:`correlate` but O(N) memory: accumulates len(pattern)
    statically shifted scaled copies instead of unfolding windows.  Use for
    long streams (packet search over the whole RX buffer)."""
    pc = np.conj(np.asarray(pattern)).astype(np.complex64)
    w = len(pc)
    nwin = x.shape[-1] - w + 1
    acc = torch.zeros(x.shape[:-1] + (nwin,), dtype=x.dtype, device=x.device)
    for k in range(w):
        acc = acc + x[..., k: k + nwin] * complex(pc[k])
    return acc


def moving_sum(x: torch.Tensor, width: int) -> torch.Tensor:
    """Sliding-window sum over the last axis, output length N - width + 1.

    The CAccumulator/CMovingWindow analogue (dspalg.hpp:5-243).  Short
    power-of-two windows use a log2(width) doubling tree of shifted adds
    (the same summation order as the JAX package); others use a cumsum
    difference.
    """
    if width <= 256 and (width & (width - 1)) == 0:
        # doubling tree: after round k, acc[i] = sum x[i .. i+2^k)
        acc = x
        span = 1
        while span < width:
            acc = acc[..., : acc.shape[-1] - span] + acc[..., span:]
            span *= 2
        return acc
    c = _pad_last(torch.cumsum(x, dim=-1), 1, 0)
    return c[..., width:] - c[..., :-width]


def fir(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal FIR over the last axis, same length (zero prehistory)."""
    t = np.asarray(taps)
    xp = _pad_last(x, len(t) - 1, 0)
    return correlate(xp, np.conj(t[::-1]).copy())


def fir_centered(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Zero-phase FIR over the last axis (group-delay compensated), same
    length, as a static shifted-add accumulation: O(N) memory, the
    long-stream form (cf. correlate_stream)."""
    t = np.asarray(taps)
    half = (len(t) - 1) // 2
    xp = _pad_last(x, half, len(t) - 1 - half)
    acc = torch.zeros_like(x)
    for k in range(len(t)):
        if abs(complex(t[k])) < 1e-12:
            continue
        tk = complex(t[k]) if np.iscomplexobj(t) else float(t[k])
        acc = acc + xp[..., k: k + x.shape[-1]] * tk
    return acc


def frame_blocks(x: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """(..., N) -> (..., nblk, block + 2*halo) overlap-save view, zero
    padded.  Block i covers [i*block - halo, (i+1)*block + halo)."""
    n = x.shape[-1]
    nblk = -(-n // block)
    xp = _pad_last(x, halo, nblk * block - n + halo)
    return xp.unfold(-1, block + 2 * halo, block)


def resample_poly(x: torch.Tensor, up: int, down: int,
                  taps: np.ndarray) -> torch.Tensor:
    """Rational-rate polyphase resampler (TUpsample40MTo44M /
    TDownSample44_40 analogue, sampling.hpp).  taps: prototype low-pass
    designed at rate lcm.  Zero-phase: output sample k sits at input time
    k*down/up, so chained resamples stay aligned."""
    n = x.shape[-1]
    y = x.new_zeros(x.shape[:-1] + (n * up,))
    y[..., ::up] = x
    f = fir_centered(y, np.asarray(taps, dtype=np.float32))
    return f[..., ::down] * up
