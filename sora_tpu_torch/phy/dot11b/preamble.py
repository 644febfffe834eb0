"""The 802.11b PLCP in numpy — the port's own copy of the helpers of the
JAX package's golden model (``sora_tpu/golden/dot11b_np.py``) that its TX
bakes into constants.

The PLCP preamble and header depend only on (rate, PSDU length, preamble
format), so ``phy.dot11b.tx`` builds them once here, like the reference's
precomputed preamble tables.  Every 11b phase is a whole number of
quarter turns (DBPSK steps by 0 or pi, DQPSK by multiples of pi/2, the
PLCP starts at 0), so the phases are kept as integer quarter-turn counts
mod 4 — the golden model's ``_dbpsk_phases`` / ``_dqpsk_phases`` in units
of pi/2 — and the chips are exact phasors from {1, j, -1, -j}.
"""

from __future__ import annotations

import numpy as np

from sora_tpu_torch.phy import dot11b_common as B

# exp(1j * q * pi / 2) for q = 0..3, exact
PHASOR = np.array([1, 1j, -1, -1j], np.complex64)

# DQPSK quarter turns per dibit (d0, d1), indexed by d0 * 2 + d1
# (B.DQPSK_PHASE: 00 -> 0, 01 -> pi/2, 10 -> 3pi/2, 11 -> pi)
DQPSK_QUARTERS = np.array([0, 1, 3, 2], np.int64)


def _dbpsk_quarters(bits: np.ndarray, q0: int = 0) -> np.ndarray:
    """Differential BPSK: bit 1 turns the phase by pi (two quarters)."""
    return (q0 + np.cumsum(2 * np.asarray(bits, np.int64))) % 4


def _dqpsk_quarters(dibits: np.ndarray, q0: int = 0) -> np.ndarray:
    d = np.asarray(dibits, np.int64)
    return (q0 + np.cumsum(DQPSK_QUARTERS[2 * d[:, 0] + d[:, 1]])) % 4


def plcp_header_bits(rate_mbps: float, psdu_len: int) -> np.ndarray:
    """SIGNAL, SERVICE, LENGTH, CRC16 — 48 bits, LSB-first fields."""
    signal = B.SIGNAL_BYTE[rate_mbps]
    length_us = int(np.ceil(psdu_len * 8 / rate_mbps))
    service = 0x04                        # locked clocks
    if rate_mbps == 11:
        le = int(np.ceil(psdu_len * 8 / 11)) * 11 - psdu_len * 8 >= 8
        if le:
            service |= 0x80
    hdr = np.zeros(48, dtype=np.uint8)
    hdr[0:8] = [(signal >> i) & 1 for i in range(8)]
    hdr[8:16] = [(service >> i) & 1 for i in range(8)]
    hdr[16:32] = [(length_us >> i) & 1 for i in range(16)]
    crc = B.crc16_plcp(hdr[:32])
    hdr[32:48] = [(crc >> i) & 1 for i in range(16)]
    return hdr


def _scramble_continue(prev_scrambled: np.ndarray, bits: np.ndarray
                       ) -> np.ndarray:
    """Continue the self-sync scrambler with register state = the last 7
    scrambler *output* bits already transmitted."""
    reg_seed = 0
    for i in range(7):
        reg_seed |= int(prev_scrambled[-1 - i]) << i
    return B.scramble_11b(bits, reg_seed)


def plcp_quarters(rate_mbps: float, psdu_len: int, preamble: str = "long"):
    """The PLCP (preamble + header) of one length class: (quarter turns
    of its 1 Mbps / 2 Mbps symbols, the scrambled PLCP bits).

    Long: 128 scrambled ones + SFD + 48 header bits from seed 0x6C, DBPSK
    (Clause 18.2.3).  Short: 56 scrambled zeros + the reversed SFD at
    1 Mbps DBPSK, then the header at 2 Mbps DQPSK from seed 0x1B (Clause
    18.2.5; the preamble_type contract of PHY_11b.hpp:26)."""
    hdr = plcp_header_bits(rate_mbps, psdu_len)
    if preamble == "short":
        if rate_mbps == 1:
            raise ValueError("short preamble excludes 1 Mbps data")
        pre = np.concatenate([
            np.zeros(B.SYNC_BITS_SHORT, np.uint8),
            np.array([(B.SFD_SHORT >> i) & 1 for i in range(16)], np.uint8)])
        plcp = B.scramble_11b(np.concatenate([pre, hdr]),
                              seed=B.SCRAMBLER_SEED_SHORT)
        q_pre = _dbpsk_quarters(plcp[: len(pre)])
        q_hdr = _dqpsk_quarters(plcp[len(pre):].reshape(-1, 2), q_pre[-1])
        return np.concatenate([q_pre, q_hdr]), plcp
    if preamble != "long":
        raise ValueError(f"preamble must be long|short, got {preamble!r}")
    pre = np.concatenate([
        np.ones(B.SYNC_BITS, np.uint8),
        np.array([(B.SFD_LONG >> i) & 1 for i in range(16)], np.uint8)])
    plcp = B.scramble_11b(np.concatenate([pre, hdr]))
    return _dbpsk_quarters(plcp), plcp
