"""802.11n HT (20 MHz, 2x2 MIMO) constants — IEEE 802.11-2012 Clause 20.

Reference equivalents: kernel/bb/Brick11/src/PHY_11n.hpp (graphs),
channel_11n.hpp (TMimoChannelEst 2x2 estimation / inversion),
deinterleaver_11n.hpp (per-stream S0/S1 tables), streamparser.hpp,
pilot_11n.hpp, csd.hpp, preamble tables _b_htltf.h/_b_htstf.h/_b_htsig.h.
Like phy/common.py we recompute every table at import instead of shipping
generated LUT headers.

Numpy only (the port's own copy of ``sora_tpu.phy.dot11n_common``).
"""

from __future__ import annotations

import numpy as np

from sora_tpu_torch.phy import common as C

NFFT = 64
# HT 20 MHz occupies -28..28 (56 carriers + DC): 52 data + 4 pilots
HT_SC_IDX = np.arange(-28, 29)
HT_PILOT_SC = np.array([-21, -7, 7, 21])
HT_DATA_SC = np.array([s for s in HT_SC_IDX
                       if s != 0 and s not in HT_PILOT_SC])
HT_DATA_BINS = HT_DATA_SC % NFFT
HT_PILOT_BINS = HT_PILOT_SC % NFFT
HT_OCC_BINS = HT_SC_IDX % NFFT
NSD = 52                                   # data subcarriers per symbol

# HT-LTF 20 MHz sequence on -28..28 (Clause 20.3.9.4.6): the L-LTF
# extended by {1,1} on the left and {-1,-1} on the right edges.
HTLTF_FREQ = np.concatenate([[1.0, 1.0], C.LTS_FREQ, [-1.0, -1.0]])

# Spatial mapping of the 2 HT-LTFs over 2 space-time streams:
# P_HTLTF (Clause 20.3.9.4.6 eq 20-27, upper-left 2x2 of P_4x4).
P2 = np.array([[1.0, -1.0],
               [1.0, 1.0]])
P2_INV = np.linalg.inv(P2)

# Per-stream pilot patterns Psi for Nsts = 2 (Table 20-19); pilot m of
# symbol n on stream i is PSI2[i, (m + n) % 4] * p_{3+n}.
PSI2 = np.array([[1.0, 1.0, -1.0, -1.0],
                 [1.0, -1.0, -1.0, 1.0]])

# Cyclic shifts (ns -> samples @ 20 Msps).  Legacy portion: Table 20-8;
# HT portion: Table 20-9 (Nsts = 2).
CSD_LEGACY = np.array([0, -4])             # 0, -200 ns
CSD_HT = np.array([0, -8])                 # 0, -400 ns

# ----------------------------------------------------------------------------
# MCS table: 2 spatial streams, 20 MHz (Table 20-34, MCS 8..15)
# ----------------------------------------------------------------------------


class McsParam:
    __slots__ = ("mcs", "modulation", "nbpsc", "num", "den", "nss",
                 "ncbpss", "ndbps", "mbps")

    def __init__(self, mcs, modulation, nbpsc, num, den, nss=2):
        self.mcs = mcs
        self.modulation = modulation
        self.nbpsc = nbpsc
        self.num, self.den = num, den
        self.nss = nss
        self.ncbpss = NSD * nbpsc                  # coded bits/sym/stream
        self.ndbps = nss * self.ncbpss * num // den
        self.mbps = self.ndbps / 4.0               # 800 ns GI, 4 us symbol


MCS = {
    8:  McsParam(8,  "bpsk",  1, 1, 2),
    9:  McsParam(9,  "qpsk",  2, 1, 2),
    10: McsParam(10, "qpsk",  2, 3, 4),
    11: McsParam(11, "qam16", 4, 1, 2),
    12: McsParam(12, "qam16", 4, 3, 4),
    13: McsParam(13, "qam64", 6, 2, 3),
    14: McsParam(14, "qam64", 6, 3, 4),
    15: McsParam(15, "qam64", 6, 5, 6),
}

# Single-spatial-stream MCS 0..7 (Table 20-30) — kept in a separate
# table so `sorted(MCS)` users (the 2-stream mixed-MCS decode tables)
# keep their 8..15 domain; `mcs_param` spans both.
MCS1 = {
    0: McsParam(0, "bpsk",  1, 1, 2, nss=1),
    1: McsParam(1, "qpsk",  2, 1, 2, nss=1),
    2: McsParam(2, "qpsk",  2, 3, 4, nss=1),
    3: McsParam(3, "qam16", 4, 1, 2, nss=1),
    4: McsParam(4, "qam16", 4, 3, 4, nss=1),
    5: McsParam(5, "qam64", 6, 2, 3, nss=1),
    6: McsParam(6, "qam64", 6, 3, 4, nss=1),
    7: McsParam(7, "qam64", 6, 5, 6, nss=1),
}


def mcs_param(mcs: int) -> McsParam:
    """MCS 0..7 (1 spatial stream) or 8..15 (2 streams)."""
    return MCS[mcs] if mcs in MCS else MCS1[mcs]


# Per-stream pilot pattern for Nsts = 1 (Table 20-19 first row); pilot
# m of symbol n is PSI1[(m + n) % 4] * p_{3+n} (eq 20-59).
PSI1 = np.array([1.0, 1.0, 1.0, -1.0])

# rate-5/6 puncturing (Clause 20.3.9.4.4 fig 20-11): of each 5 (A,B)
# pairs transmit A0 B0 A1 B2 A3 B4
PUNCTURE_56 = (np.array([True, True, False, True, False]),
               np.array([True, False, True, False, True]))


def puncture_pattern(num: int, den: int):
    if (num, den) == (5, 6):
        return PUNCTURE_56
    return C.PUNCTURE[(num, den)]


# ----------------------------------------------------------------------------
# HT interleaver (Clause 20.3.9.4.6, 20 MHz: Ncol=13, Nrow=4*Nbpsc,
# Nrot=11) with the frequency-rotation third permutation per stream.
# ----------------------------------------------------------------------------


def ht_interleaver_permutation(nbpsc: int, iss: int) -> np.ndarray:
    """perm such that interleaved[perm[k]] = coded[k] for stream iss
    (0-based).  Inverse of the reference's per-stream deinterleave tables
    (deinterleaver_11n.hpp S0/S1)."""
    ncbpss = NSD * nbpsc
    ncol, nrow, nrot = 13, 4 * nbpsc, 11
    s = max(nbpsc // 2, 1)
    k = np.arange(ncbpss)
    i = nrow * (k % ncol) + k // ncol
    j = s * (i // s) + (i + ncbpss - (ncol * i // ncbpss)) % s
    rot = ((iss * 2) % 3 + 3 * (iss // 3)) * nrot * nbpsc
    r = (j - rot) % ncbpss
    return r


# ----------------------------------------------------------------------------
# Stream parser (Clause 20.3.9.4.5): round-robin s-bit groups
# ----------------------------------------------------------------------------


def stream_parse_indices(nbits_total: int, nbpsc: int, nss: int = 2):
    """Index arrays (nss, nbits_total // nss): bits of the single encoded
    stream assigned to each spatial stream (streamparser.hpp:7-139)."""
    s = max(nbpsc // 2, 1)
    per = nbits_total // nss
    k = np.arange(per)
    grp, off = k // s, k % s
    return np.stack([grp * (nss * s) + i * s + off for i in range(nss)])


# ----------------------------------------------------------------------------
# HT-SIG (Clause 20.3.9.4.3): 48 bits, CRC-8, QBPSK
# ----------------------------------------------------------------------------


def crc8_htsig(bits: np.ndarray) -> np.ndarray:
    """CRC-8 (x^8+x^2+x+1, init all-ones, complemented) over the first 34
    HT-SIG bits; returned MSB (c7) first as transmitted."""
    crc = 0xFF
    for b in np.asarray(bits, np.uint8):
        fb = ((crc >> 7) & 1) ^ int(b)
        crc = ((crc << 1) & 0xFF) ^ (0x07 if fb else 0)
    crc ^= 0xFF
    return np.array([(crc >> (7 - i)) & 1 for i in range(8)], np.uint8)


def htsig_bits(mcs: int, length: int,
               short_gi: bool = False) -> np.ndarray:
    """48-bit HT-SIG for 20 MHz, no STBC/LDPC/aggregation/ESS; bit 31
    carries the short-GI flag."""
    b = np.zeros(48, np.uint8)
    for i in range(7):
        b[i] = (mcs >> i) & 1
    # b7: CBW 20/40 = 0
    for i in range(16):
        b[8 + i] = (length >> i) & 1
    b[24] = 1        # smoothing
    b[25] = 1        # not sounding
    b[26] = 1        # reserved (one)
    # b27 aggregation=0, b28-29 STBC=0, b30 FEC=0 (BCC), b32-33 Ness=0
    b[31] = 1 if short_gi else 0
    b[34:42] = crc8_htsig(b[:34])
    return b


def parse_htsig(bits: np.ndarray):
    """-> (mcs, length, crc_ok) from 48 decoded HT-SIG bits."""
    mcs = int(np.sum(bits[:7].astype(np.int64) << np.arange(7)))
    length = int(np.sum(bits[8:24].astype(np.int64) << np.arange(16)))
    crc_ok = bool(np.array_equal(crc8_htsig(bits[:34]), bits[34:42]))
    return mcs, length, crc_ok


# ----------------------------------------------------------------------------
# Time-domain building blocks
# ----------------------------------------------------------------------------


def ht_time_symbol(freq_on_sc: np.ndarray) -> np.ndarray:
    """64-pt IFFT of values on HT_SC_IDX, scaled to unit average power for
    a 56-carrier unit-amplitude symbol."""
    X = np.zeros(NFFT, dtype=np.complex128)
    X[HT_OCC_BINS] = freq_on_sc
    return np.fft.ifft(X) * NFFT / np.sqrt(56.0)


def cyclic_shift(x: np.ndarray, shift: int) -> np.ndarray:
    """Apply a cyclic shift within each 64-sample symbol body; for
    time-domain full waveforms use np.roll on the symbol before GI."""
    return np.roll(x, shift)


HTLTF_TIME = ht_time_symbol(HTLTF_FREQ)       # 64 samples
