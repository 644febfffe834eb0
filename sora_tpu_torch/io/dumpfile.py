"""Sora dump-file I/O (numpy; the port's own copy of
``sora_tpu.io.dumpfile``).

A Sora dump file is an image of the RX DMA ring: a sequence of 128-byte
blocks, each a 16-byte slot descriptor followed by 28 COMPLEX16 samples
(112 bytes).  Reference: the loader semantics of
``kernel/brick/inc/brickutil.h:20-58`` (skip 16 bytes, read 28 samples,
repeat) and the ring layout of ``kernel/core/inc/_rx_manager.h:85-137``.

Sample encoding: the RCB ADC path stores each I/Q component in the low 14
bits of the int16, as an *unwrapped* 14-bit two's-complement value (negative
values appear as ``v + 16384``).  ``load_dump`` sign-extends from 14 bits by
default.
"""

from __future__ import annotations

import numpy as np

BLOCK_BYTES = 128
DESC_BYTES = 16
SAMPLES_PER_BLOCK = 28  # 7 x vcs = 28 COMPLEX16, _rx_manager.h:85


def raw_blocks(path: str) -> np.ndarray:
    """Return the (nblocks, 128) uint8 view of a dump file."""
    raw = np.fromfile(path, dtype=np.uint8)
    nblocks = len(raw) // BLOCK_BYTES
    return raw[: nblocks * BLOCK_BYTES].reshape(nblocks, BLOCK_BYTES)


def load_dump(path: str, sign_extend_14bit: bool = True) -> np.ndarray:
    """Load a Sora dump file into a complex64 sample array.

    Strips the 16-byte descriptor from every 128-byte block and concatenates
    the 28-sample payloads, mirroring ``LoadSoraDumpFile``
    (kernel/brick/inc/brickutil.h:20-58).  With ``sign_extend_14bit`` each
    int16 component is read as a 14-bit two's-complement value (the RCB ADC
    format); turn it off for dumps written with full 16-bit samples.
    """
    payload = raw_blocks(path)[:, DESC_BYTES:].reshape(-1)
    iq = payload.view("<i2").astype(np.int32).reshape(-1, 2)
    if sign_extend_14bit:
        iq = ((iq & 0x3FFF) ^ 0x2000) - 0x2000
    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)


def save_dump(path: str, samples: np.ndarray, bits: int = 16) -> int:
    """Write samples as a Sora dump file (inverse of :func:`load_dump`).

    Pads the tail with zeros to a whole 28-sample block.  Descriptors are
    written as the reference RX ring does: ``01 00 70 00`` (valid flag +
    0x70 = 112 payload bytes) followed by zeros.

    ``bits=14`` stores the low 14 bits without sign extension (the RCB ADC
    format); ``bits=16`` stores full int16.  Returns the number of samples
    written (including padding).
    """
    x = np.asarray(samples)
    n = len(x)
    npad = (-n) % SAMPLES_PER_BLOCK
    re = np.concatenate([np.real(x), np.zeros(npad)])
    im = np.concatenate([np.imag(x), np.zeros(npad)])
    iq = np.stack([re, im], axis=-1)
    lim = (1 << (bits - 1)) - 1
    iq = np.clip(np.round(iq), -lim - 1, lim).astype(np.int64)
    if bits == 14:
        iq = iq & 0x3FFF
    iq = iq.astype("<i2")
    nblocks = (n + npad) // SAMPLES_PER_BLOCK
    out = np.zeros((nblocks, BLOCK_BYTES), dtype=np.uint8)
    out[:, 0] = 0x01
    out[:, 2] = 0x70
    out[:, DESC_BYTES:] = iq.reshape(nblocks, -1).view(np.uint8)
    out.tofile(path)
    return n + npad
