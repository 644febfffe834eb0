"""Batched small FFTs as fp32 DFT matmuls (port of ``sora_tpu.dsp.fft``).

The reference computes 64/128-point fixed-point FFTs with a radix-4 SSE
kernel (kernel/core/inc/fft_r4dif.h).  Here, as in the JAX package, a
batch of symbols is contracted with a dense DFT matrix in two real fp32
matmuls per part.  The products must run in full fp32: TF32 (about three
decimal digits) costs tens of dB of effective SNR, fatal for 64-QAM
equalization.  PyTorch's default leaves TF32 off for matmuls
(``torch.backends.cuda.matmul.allow_tf32`` False); keep it so.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _dft_mats(n: int, inverse: bool, dtype=np.float32):
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    sgn = 1.0 if inverse else -1.0
    c = np.cos(ang).astype(dtype)
    s = (sgn * np.sin(ang)).astype(dtype)
    if inverse:
        c = c / n
        s = s / n
    return c, s


@lru_cache(maxsize=None)
def _dft_tensors(n: int, inverse: bool, device: torch.device):
    c, s = _dft_mats(n, inverse)
    return torch.as_tensor(c, device=device), torch.as_tensor(s, device=device)


def dft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """DFT over the last axis of a complex tensor via real fp32 matmuls.

    Forward matches ``np.fft.fft``; inverse matches ``np.fft.ifft``
    (1/N scaling).
    """
    c, s = _dft_tensors(x.shape[-1], inverse, x.device)
    xr = x.real.float()
    xi = x.imag.float()
    # (re + j im) @ (C + jS) = (re@C - im@S) + j(re@S + im@C)
    yr = xr @ c - xi @ s
    yi = xr @ s + xi @ c
    return torch.complex(yr, yi)


def fft64(x: torch.Tensor) -> torch.Tensor:
    """Batched 64-point FFT (last axis), the OFDM demod transform
    (reference: TFFT64, kernel/bb/Brick11/src/fft.hpp:110-140)."""
    if x.shape[-1] != 64:
        raise ValueError(f"fft64 needs a last axis of 64, got {x.shape}")
    return dft(x, inverse=False)


def ifft64(x: torch.Tensor) -> torch.Tensor:
    """Batched 64-point IFFT (reference: TIFFTx, fft.hpp:9-108)."""
    if x.shape[-1] != 64:
        raise ValueError(f"ifft64 needs a last axis of 64, got {x.shape}")
    return dft(x, inverse=True)
