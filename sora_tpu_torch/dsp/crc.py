"""CRC-32 on device — torch (port of ``sora_tpu.dsp.crc``), and the
802.11b PLCP header's CRC-16.

The reference checks the 802.11 FCS incrementally with byte LUTs
(kernel/core/inc/CRC32.h, used by TBB11aFrameSink, PHY_11a.hpp:607-702).
The batched checker uses the bit-matrix formulation instead: the CRC
register update is affine over GF(2)^32, so the CRC of a fixed-length
message is ``c0 XOR (bits @ V)`` for a precomputed (8N, 32) matrix V — one
fp32 matmul (column sums stay < 2^24, so fp32 carries the GF(2) arithmetic
exactly, reduced mod 2 afterwards).  Variable lengths are handled by
zero-padding every row to N and then *unwinding* the zero tail: appending
k zero bytes applies the linear map A^k to the register, so applying
(A^-1)^k — decomposed into log2(N) conditional 32x32 bit-matrix
multiplies keyed on the bits of k — recovers each row's true CRC.

uint32 has thin torch support, so register values are carried as int64
in [0, 2^32).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.mac.frame import crc32_table

_TBL = crc32_table().astype(np.uint32)


@lru_cache(maxsize=None)
def _table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TBL.astype(np.int64), device=device)


def crc32_bytes(data: torch.Tensor) -> torch.Tensor:
    """CRC-32 (IEEE, reflected) of a uint8 vector; 0-dim int64 result.
    A byte-LUT loop — fine for one-off checks; hot pipelines use
    :func:`crc32_batch`."""
    tbl = _table(data.device)
    crc = torch.tensor(0xFFFFFFFF, dtype=torch.int64, device=data.device)
    for b in data.to(torch.int64):
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _bits32(v: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(32)], np.uint8)


@lru_cache(maxsize=None)
def _crc32_mats(N: int):
    """Precompute the affine CRC machinery for length-N messages.

    Returns (V (8N, 32) f32 — bit j of byte t maps to row 8t+j;
    g0 (32,) uint8 — register after N zero bytes from init 0xFFFFFFFF;
    inv_pows (ceil(log2(N+1)), 32, 32) f32 — (A^-1)^(2^i) bit matrices).
    """
    # A: one zero-byte register step crc' = TBL[crc & 0xFF] ^ (crc >> 8);
    # columns are the images of unit register bits
    A = np.zeros((32, 32), np.uint8)
    for i in range(32):
        v = 1 << i
        img = int(_TBL[v & 0xFF]) ^ (v >> 8)
        A[:, i] = _bits32(img)
    # D: data-byte injection (register 0): crc' = TBL[b]
    D = np.zeros((32, 8), np.uint8)
    for j in range(8):
        D[:, j] = _bits32(int(_TBL[1 << j]))
    # W_t = A^(N-1-t) . D, built back to front
    V = np.zeros((N, 8, 32), np.uint8)
    W = D.copy()
    for t in range(N - 1, -1, -1):
        V[t] = W.T
        W = (A @ W) % 2
    # register after N zero bytes from init (no final xor)
    g = 0xFFFFFFFF
    for _ in range(N):
        g = int(_TBL[g & 0xFF]) ^ (g >> 8)
    # A^-1 over GF(2) and its power-of-two powers
    Ainv = _gf2_inv(A)
    nbits = max(1, int(np.ceil(np.log2(N + 1))))
    inv_pows = np.zeros((nbits, 32, 32), np.uint8)
    P = Ainv
    for i in range(nbits):
        inv_pows[i] = P
        P = (P @ P) % 2
    return (V.reshape(8 * N, 32).astype(np.float32), _bits32(g),
            inv_pows.astype(np.float32))


def _gf2_inv(A: np.ndarray) -> np.ndarray:
    """Invert a GF(2) matrix by Gauss-Jordan."""
    n = A.shape[0]
    M = np.concatenate([A.astype(np.uint8) % 2, np.eye(n, dtype=np.uint8)],
                       axis=1)
    r = 0
    for c in range(n):
        piv = next(i for i in range(r, n) if M[i, c])
        M[[r, piv]] = M[[piv, r]]
        for i in range(n):
            if i != r and M[i, c]:
                M[i] ^= M[r]
        r += 1
    return M[:, n:]


@lru_cache(maxsize=None)
def _crc32_tensors(N: int, device: torch.device):
    V, g0, inv_pows = _crc32_mats(N)
    return (torch.as_tensor(V, device=device),
            torch.as_tensor(g0.astype(np.int64), device=device),
            torch.as_tensor(np.ascontiguousarray(
                np.swapaxes(inv_pows, 1, 2)), device=device))


def crc32_batch(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Batched variable-length CRC-32 with no scan.

    data: (B, N) uint8, each row a frame padded to N; lengths: (B,) valid
    byte counts.  Bytes at or beyond a row's length do not affect its CRC.
    Returns (B,) int64 CRC values in [0, 2^32).
    """
    B, N = data.shape
    V, g0, inv_pows_t = _crc32_tensors(N, data.device)
    lengths = lengths.to(torch.int64)
    ts = torch.arange(N, device=data.device)[None, :]
    masked = torch.where(ts < lengths[:, None], data.to(torch.int64), 0)
    shifts = torch.arange(8, device=data.device)
    bits = ((masked[:, :, None] >> shifts) & 1).reshape(B, 8 * N).float()
    # register after the zero-padded message (linear part + zero-message
    # register); the fp32 matmul is exact (column sums < 2^24), reduce mod 2
    reg = ((bits @ V).to(torch.int64) & 1) ^ g0[None, :]
    # unwind the (N - length) zero tail: apply (A^-1)^k via k's bits
    k = N - lengths
    for i in range(inv_pows_t.shape[0]):
        stepped = ((reg.float() @ inv_pows_t[i]).to(torch.int64) & 1)
        take = ((k >> i) & 1).bool()[:, None]
        reg = torch.where(take, stepped, reg)
    weights = torch.ones(32, dtype=torch.int64, device=data.device) << \
        torch.arange(32, device=data.device)
    crc = torch.sum(reg * weights, dim=1)
    return crc ^ 0xFFFFFFFF


def crc16_bits(bits: np.ndarray) -> int:
    """CRC-16 of the 802.11b PLCP header (Clause 18.2.3.6; the reference
    computes it at PHY_11b.hpp:126): poly x^16+x^12+x^5+1, init 0xFFFF,
    ones-complement result, input is the LSB-first PLCP bit stream."""
    crc = 0xFFFF
    for bit in np.asarray(bits, dtype=np.uint8):
        c15 = (crc >> 15) & 1
        crc = (crc << 1) & 0xFFFF
        if c15 ^ int(bit):
            crc ^= 0x1021
    return (~crc) & 0xFFFF
