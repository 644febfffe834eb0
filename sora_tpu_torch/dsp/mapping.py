"""Constellation mapping / soft demapping — torch, batched (port of
``sora_tpu.dsp.mapping``).

Replaces the reference's per-byte mapper LUTs (mapper11a.hpp + mapa_*.c)
and clamped soft-demap LUTs (demapper11a.hpp + dsp_demap.h) with direct
elementwise arithmetic: the piecewise-linear max-log LLRs are a handful of
abs/sub ops.

Bit convention matches ``phy.common`` (LSB-first groups per axis, I bits
then Q bits); soft outputs are positive for bit 1.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.phy import common as C

_LVL = {"bpsk": C._BPSK_LVL, "qpsk": C._QPSK_LVL, "qam16": C._QAM16_LVL,
        "qam64": C._QAM64_LVL}

NBPSC = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}


@lru_cache(maxsize=None)
def _map_tables(modulation: str, device: torch.device):
    """(levels, bit weights of one axis) on ``device``: made once, so a
    call on the card copies nothing from the host."""
    h = NBPSC[modulation] // 2
    return (torch.as_tensor(_LVL[modulation].astype(np.float32),
                            device=device),
            torch.tensor([1 << (h - 1 - i) for i in range(h)],
                         device=device))


def map_bits(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """(..., n*nbpsc) bits -> (..., n) complex64 unit-power symbols."""
    lv, weights = _map_tables(modulation, bits.device)
    b = bits.long()
    if modulation == "bpsk":
        return lv[b].to(torch.complex64)
    n = NBPSC[modulation]
    g = b.reshape(*b.shape[:-1], -1, n)
    h = n // 2
    i_idx = torch.sum(g[..., :h] * weights, dim=-1)
    q_idx = torch.sum(g[..., h:] * weights, dim=-1)
    return torch.complex(lv[i_idx], lv[q_idx])


def demap_soft(sym: torch.Tensor, modulation: str) -> torch.Tensor:
    """(..., n) symbols -> (..., n*nbpsc) soft metrics (positive => 1)."""
    I = sym.real.float()
    Q = sym.imag.float()
    if modulation == "bpsk":
        return I[..., None].reshape(*sym.shape[:-1], -1)
    if modulation == "qpsk":
        out = torch.stack([I, Q], dim=-1) * float(np.float32(np.sqrt(2.0)))
    elif modulation == "qam16":
        f = float(np.float32(np.sqrt(10.0)))
        a = float(np.float32(2 / np.float32(f)))
        out = torch.stack([I, a - I.abs(), Q, a - Q.abs()], dim=-1) * f
    elif modulation == "qam64":
        f = float(np.float32(np.sqrt(42.0)))
        a4 = float(np.float32(4 / np.float32(f)))
        a2 = float(np.float32(2 / np.float32(f)))
        out = torch.stack(
            [I, a4 - I.abs(), a2 - (I.abs() - a4).abs(),
             Q, a4 - Q.abs(), a2 - (Q.abs() - a4).abs()], dim=-1) * f
    else:
        raise ValueError(modulation)
    return out.reshape(*sym.shape[:-1], -1)
