"""802.11b DSSS transmitter — torch, batched (port of
``sora_tpu.phy.dot11b.tx``: DBPSK, DQPSK, CCK 5.5 and 11, long or short
preamble).

Reference graph (kernel/bb/demod11/fb11bmod_config.hpp; bricks TBB11bSrc
-> TSc741 -> {TBB11bDBPSKSpread | TBB11bDQPSKSpread | TCCK5Encode |
TCCK11Encode}): a byte-at-a-time LUT scrambler feeding per-symbol
spreaders.  Here every stage is batch-parallel:

* the self-synchronizing scrambler 1/(1+z^-4+z^-7) is linear, and its
  impulse response is the 127-periodic m-sequence of x^7+x^4+1, so
  scrambling is a stride-127 prefix XOR followed by a 127-tap XOR
  correlation with that sequence (integer sums, exact on any device);
* the differential phase chains (DBPSK, DQPSK, CCK phi1) are integer
  cumulative sums of quarter turns mod 4, looked up in {1, j, -1, -j}:
  the phasors are exact, where the JAX package's float32 phase cumsum
  drifts from the golden model with the frame's length;
* Barker spreading is an outer product; CCK encoding is a codebook gather
  times the phi1 phasor.

The PLCP preamble and header depend only on (rate, psdu_len, preamble),
so they are built once (``phy.dot11b.preamble``) and kept as constants on
the PSDU tensor's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.phy import dot11b_common as B
from sora_tpu_torch.phy.dot11b import preamble as P


@lru_cache(maxsize=None)
def _impulse_response_period() -> np.ndarray:
    """127-periodic impulse response hp of the TX scrambler 1/(1+z^-4+z^-7).

    h_0 = 1 (feed-through); h_i = h_{i-4} ^ h_{i-7}.  x^7+x^4+1 is
    primitive, so h is exactly 127-periodic from index 0 (checked)."""
    n = 4 * 127
    h = np.zeros(n, np.uint8)
    h[0] = 1
    for i in range(1, n):
        a = h[i - 4] if i >= 4 else 0
        b = h[i - 7] if i >= 7 else 0
        h[i] = a ^ b
    if not np.array_equal(h[:127], h[127:254]):
        raise AssertionError("the scrambler response must be 127-periodic")
    return h[:127]


def _seed_bits(seed: int) -> np.ndarray:
    """7 'previously transmitted' bits whose register image equals seed
    (reg[i] = bit transmitted i+1 steps ago)."""
    return np.array([(seed >> i) & 1 for i in range(7)][::-1], np.uint8)


@lru_cache(maxsize=None)
def _zero_input_response(seed: int, n: int) -> np.ndarray:
    """The scrambler's output on n zero bits from register state seed."""
    return P._scramble_continue(_seed_bits(seed), np.zeros(n, np.uint8))


@lru_cache(maxsize=None)
def _scramble_tables(seed: int, n: int, device: torch.device) -> dict:
    hp = _impulse_response_period()[::-1].copy()
    return {"hp_rev": torch.as_tensor(hp, device=device),
            "c": torch.as_tensor(_zero_input_response(seed, n),
                                 device=device)}


def scramble_tx(bits: torch.Tensor, seed: int) -> torch.Tensor:
    """Batched feedback scrambler: (B, n) uint8 -> (B, n) uint8.

    s = (h (*) b) xor c, where (*) is GF(2) convolution with the periodic
    impulse response and c is the zero-input response from ``seed``."""
    Bsz, n = bits.shape
    k = _scramble_tables(seed, n, bits.device)
    # G_t = b_t ^ G_{t-127}: the stride-127 prefix XOR, a cumsum over rows
    ncols = -(-n // 127)
    bp = torch.zeros(Bsz, ncols * 127, dtype=torch.int32, device=bits.device)
    bp[:, :n] = bits
    g = (torch.cumsum(bp.reshape(Bsz, ncols, 127), dim=1) & 1).to(
        torch.uint8).reshape(Bsz, ncols * 127)[:, :n]
    # s_i = XOR_p hp[p] & G_{i-p}: a 127-tap correlation, summed in int32
    gp = torch.cat([g.new_zeros(Bsz, 126), g], dim=1)
    acc = torch.sum(gp.unfold(1, 127, 1) * k["hp_rev"], dim=2,
                    dtype=torch.int32)
    return (acc & 1).to(torch.uint8) ^ k["c"]


@lru_cache(maxsize=None)
def _plcp_const(rate_mbps: float, psdu_len: int, preamble: str = "long"):
    """(plcp chips complex64, q0 = the PLCP's last phase in quarter turns,
    data scrambler seed = the last 7 scrambled PLCP bits)."""
    quarters, plcp = P.plcp_quarters(rate_mbps, psdu_len, preamble)
    chips = (P.PHASOR[quarters][:, None]
             * B.BARKER.astype(np.complex64)[None, :]).reshape(-1)
    seed = 0
    for i in range(7):
        seed |= int(plcp[-1 - i]) << i
    return chips.astype(np.complex64), int(quarters[-1]), seed


@lru_cache(maxsize=None)
def _tables(rate_mbps: float, psdu_len: int, preamble: str,
            device: torch.device) -> dict:
    """The constants of one (rate, length, preamble) class on ``device``."""
    chips, q0, seed = _plcp_const(rate_mbps, psdu_len, preamble)
    book = {5.5: B.cck55_codebook, 11: B.cck11_codebook}.get(rate_mbps)
    t = lambda a, **kw: torch.as_tensor(np.asarray(a, **kw), device=device)
    return {"plcp": t(chips), "q0": q0, "seed": seed,
            "phasor": t(P.PHASOR),
            "barker": t(B.BARKER, dtype=np.complex64),
            "dqpsk": t(P.DQPSK_QUARTERS),
            "book": None if book is None else t(book(), dtype=np.complex64),
            "shifts": t(np.arange(8), dtype=np.uint8),
            # CCK's extra pi (two quarters) on odd symbols
            "odd": t(2 * (np.arange(2 * psdu_len) % 2))}


def _bits_device(psdu: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 -> (B, 8L) bits, LSB first."""
    Bsz, L = psdu.shape
    return ((psdu.to(torch.uint8)[:, :, None] >> shifts) & 1).reshape(
        Bsz, 8 * L)


def _modulate_data(s: torch.Tensor, rate_mbps: float, k: dict
                   ) -> torch.Tensor:
    """Scrambled data bits (B, n) -> chips (B, nchips) complex64."""
    Bsz, n = s.shape
    if rate_mbps in (1, 2):
        if rate_mbps == 1:
            dq = 2 * s.to(torch.int64)                       # pi per 1 bit
        else:
            di = s.reshape(Bsz, -1, 2).to(torch.int64)
            dq = k["dqpsk"][2 * di[:, :, 0] + di[:, :, 1]]
        q = (k["q0"] + torch.cumsum(dq, dim=1)) & 3
        chips = k["phasor"][q][:, :, None] * k["barker"]
        return chips.reshape(Bsz, -1)
    nbps = 4 if rate_mbps == 5.5 else 8
    g = s.reshape(Bsz, -1, nbps).to(torch.int64)
    nsym = g.shape[1]
    # phi1: DQPSK on (d0, d1) with an extra pi on odd symbols
    dq = k["dqpsk"][2 * g[:, :, 0] + g[:, :, 1]] + k["odd"][:nsym]
    q = (k["q0"] + torch.cumsum(dq, dim=1)) & 3                # (B, nsym)
    iw = g[:, :, 2] + 2 * g[:, :, 3]
    if rate_mbps == 11:
        iw = (iw + 4 * g[:, :, 4] + 8 * g[:, :, 5] + 16 * g[:, :, 6]
              + 32 * g[:, :, 7])
    chips = k["book"][iw] * k["phasor"][q][:, :, None]         # (B, nsym, 8)
    return chips.reshape(Bsz, -1)


def waveform_len(rate_mbps: float, psdu_len: int,
                 preamble: str = "long") -> int:
    """Chips @ 11 Mcps of one frame: PLCP preamble + header, then the
    PSDU at 1 / 2 Mbps (Barker, 11 chips per symbol) or 5.5 / 11 Mbps
    (CCK, 8 chips per symbol)."""
    nbits = psdu_len * 8
    if preamble == "short":
        plcp = (B.SYNC_BITS_SHORT + 16 + 24) * 11
    else:
        plcp = (B.SYNC_BITS + 16 + 48) * 11
    if rate_mbps == 1:
        return plcp + nbits * 11
    if rate_mbps == 2:
        return plcp + (nbits // 2) * 11
    nbps = 4 if rate_mbps == 5.5 else 8
    return plcp + (nbits // nbps) * 8


def modulate(psdu: torch.Tensor, rate_mbps: float, psdu_len: int,
             preamble: str = "long") -> torch.Tensor:
    """Batched 802.11b modulator: (B, psdu_len) uint8 -> (B, nchips)
    complex64 at the 11 Msps chip rate, long or short preamble, on the
    PSDU tensor's device.  All rows share one length class."""
    if rate_mbps not in B.SIGNAL_BYTE:
        raise ValueError(f"no 802.11b rate {rate_mbps!r}")
    k = _tables(rate_mbps, psdu_len, preamble, psdu.device)
    s = scramble_tx(_bits_device(psdu, k["shifts"]), k["seed"])
    data = _modulate_data(s, rate_mbps, k)
    pre = k["plcp"].expand(psdu.shape[0], -1)
    return torch.cat([pre, data], dim=1)
