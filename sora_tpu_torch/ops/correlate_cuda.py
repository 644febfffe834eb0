"""Sliding complex correlation against a short pattern: the hand-written
Hopper kernel, its build and the launch counter.

``out[..., n] = sum_k x[..., n + k] * conj(p[k])`` for every offset n <
N - w + 1, the function of ``dsp/filters.py::correlate_stream``, whose
plain version (``correlate_stream_reference``, a zero fill and w strided
multiplies and adds) stays beside it for CPU tensors.  The kernel
(``csrc/correlate.cu``, see the note at its head) equals that loop run on
the card bit for bit: the sum starts from 0 and adds the products for k =
0 .. w-1 in order, each product rounded as PyTorch's CUDA complex multiply
rounds it.  It replaces no TPU kernel: the JAX package computes this in
jnp code that XLA fuses.

The kernel takes complex64 rows of any number of leading dimensions and
the two pattern lengths of the receivers: 64 (the 802.11a/n LTS) and 11
(the 802.11b Barker).  It is built with nvcc for ``sm_90a`` into
``_build/libsora_correlate.so`` at first use (rebuilt when the source is
newer) through ``ops.viterbi_cuda.build``, and loaded with ctypes.
``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from sora_tpu_torch.ops import viterbi_cuda

# Kernel launches made by correlate (a plain integer; reset it to 0 before a
# run to see how many launches that run made).
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "correlate.cu"
LIBRARY = viterbi_cuda.BUILD_DIR / "libsora_correlate.so"
PATTERN_LENGTHS = (64, 11)


def build(force: bool = False) -> str:
    """Compile csrc/correlate.cu into _build/libsora_correlate.so when the
    library is missing or older than the source (or ``force``); nvcc's
    output, or "" when the library was current.  Raises when nvcc is
    missing or fails."""
    return viterbi_cuda.build(force, SOURCE, LIBRARY)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.sora_correlate.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.sora_correlate.restype = ctypes.c_int
    lib.sora_correlate_error_string.argtypes = [ctypes.c_int]
    lib.sora_correlate_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=8)
def _taps(pattern: bytes) -> ctypes.Array:
    """The conjugated complex64 pattern as 2w C floats (re, im), the
    kernel's by-value parameter."""
    pc = np.conj(np.frombuffer(pattern, np.complex64))
    return (ctypes.c_float * (2 * len(pc)))(*pc.view(np.float32).tolist())


def check(x: torch.Tensor, pattern) -> np.ndarray:
    """The complex64 pattern, after checking that the kernel takes x and
    it: complex64 input, a pattern of 64 or 11 values, at least one
    output.  Raises ValueError otherwise."""
    p = np.asarray(pattern)
    if p.ndim != 1 or len(p) not in PATTERN_LENGTHS:
        raise ValueError(f"correlate: the pattern must have one of "
                         f"{PATTERN_LENGTHS} values, got shape {p.shape}")
    if x.dtype != torch.complex64:
        raise ValueError(f"correlate: x must be complex64, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < len(p):
        raise ValueError(f"correlate: x {tuple(x.shape)} is shorter than "
                         f"the pattern ({len(p)})")
    return p.astype(np.complex64)


def correlate(x: torch.Tensor, pattern) -> torch.Tensor:
    """sum_k x[..., n + k] * conj(pattern[k]) on the card, one launch:
    (..., N - w + 1) complex64.  Raises for a tensor that is not on a CUDA
    device, for what :func:`check` refuses, and when the launch fails."""
    global LAUNCHES
    p = check(x, pattern)
    if x.device.type != "cuda":
        raise ValueError(f"correlate: x must be on a CUDA device, got "
                         f"{x.device}")
    n, w = x.shape[-1], len(p)
    rows = x.reshape(-1, n)
    if rows.stride(-1) != 1 or (rows.shape[0] > 1 and rows.stride(0) < n):
        rows = rows.contiguous()
    out = torch.empty(rows.shape[0], n - w + 1, dtype=torch.complex64,
                      device=x.device)
    if rows.shape[0]:
        lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.sora_correlate(
                rows.data_ptr(), out.data_ptr(), rows.shape[0],
                rows.stride(0) if rows.shape[0] > 1 else n, n, w,
                _taps(p.tobytes()), stream)
        if rc != 0:
            raise RuntimeError("sora_correlate launch failed: "
                               + lib.sora_correlate_error_string(rc).decode())
        LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n - w + 1)
