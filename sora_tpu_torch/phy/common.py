"""802.11 OFDM PHY constants and pure-numpy reference tables.

Everything here is derived from IEEE 802.11-2007 Clause 17 (and Clause 18
for DSSS); the reference implementation keeps the equivalent data in
generated LUT stock (``kernel/bb/dot11a/lutst/*.c``) and
``kernel/bb/Brick11/src/ieee80211const.h``.  We recompute the tables at
import time instead of checking in megabytes of generated headers.

Numpy only: the torch chains convert the arrays they need to tensors on
the device they run on.  This is the port's own copy of
``sora_tpu.phy.common`` (the port imports nothing of ``sora_tpu``);
tests/test_torch_dsp.py holds every table equal to the original.
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------------
# Subcarrier layout (Clause 17.3.5.9)
# ----------------------------------------------------------------------------
NFFT = 64
SC_IDX = np.arange(-26, 27)                      # occupied subcarriers
PILOT_SC = np.array([-21, -7, 7, 21])
DATA_SC = np.array([s for s in SC_IDX if s != 0 and s not in PILOT_SC])
PILOT_VAL = np.array([1.0, 1.0, 1.0, -1.0])      # pilot BPSK values x p_n
DATA_BINS = DATA_SC % NFFT                       # FFT bin index per data sc
PILOT_BINS = PILOT_SC % NFFT
OCC_BINS = SC_IDX % NFFT

# Long training symbol, frequency domain, on SC_IDX (-26..26), DC = 0.
# Matches ieee80211const.h:22 (LTS_Positive_table).
LTS_FREQ = np.array(
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1,
     1, -1, 1, 1, 1, 1,               # -26..-1
     0,                               # DC
     1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1,
     -1, 1, -1, 1, 1, 1, 1],          # +1..+26
    dtype=np.float64)

# Short training symbol, frequency domain: subcarriers ±{4,8,12,16,20,24}
# with values sqrt(13/6)*(±1±j) (Clause 17.3.5.4; preamble11a.hpp:30-44).
STS_FREQ = np.zeros(53, dtype=np.complex128)
_sts_map = {-24: 1 + 1j, -20: -1 - 1j, -16: 1 + 1j, -12: -1 - 1j,
            -8: -1 - 1j, -4: 1 + 1j, 4: -1 - 1j, 8: -1 - 1j, 12: 1 + 1j,
            16: 1 + 1j, 20: 1 + 1j, 24: 1 + 1j}
for _sc, _v in _sts_map.items():
    STS_FREQ[_sc + 26] = np.sqrt(13.0 / 6.0) * _v


def _time_symbol(freq_on_sc: np.ndarray, nfft: int = NFFT) -> np.ndarray:
    """64-point IFFT of values given on SC_IDX, natural time order.

    Scaled by nfft/sqrt(52) so a unit-amplitude 52-carrier symbol has unit
    average time-domain power; preamble and data use the same scale (the
    standard requires equal per-carrier power so channel estimates from the
    LTS apply to data symbols without renormalization)."""
    X = np.zeros(nfft, dtype=np.complex128)
    X[SC_IDX % nfft] = freq_on_sc
    return np.fft.ifft(X) * nfft / np.sqrt(52.0)


# Canonical 20 Msps preamble (unit carrier amplitude, no windowing):
# STS: 10 repeats of a 16-sample period (160 samples);
# LTS: 32-sample GI2 + two 64-sample repeats (160 samples).
_sts64 = _time_symbol(STS_FREQ)
STS_TIME_PERIOD = _sts64[:16]                      # 16-sample STS period
STS_TIME = np.tile(STS_TIME_PERIOD, 10)
LTS_TIME_SYM = _time_symbol(LTS_FREQ)
LTS_TIME = np.concatenate([LTS_TIME_SYM[-32:], LTS_TIME_SYM, LTS_TIME_SYM])
PREAMBLE_TIME = np.concatenate([STS_TIME, LTS_TIME])   # 320 samples @20Msps

# ----------------------------------------------------------------------------
# Rate parameters (Clause 17.3.2.2; fb11amod_config.hpp rate select)
# ----------------------------------------------------------------------------
# SIGNAL RATE bits (R1 R2 R3 R4, R1 transmitted first) keyed MSB-first.
class RateParam:
    __slots__ = ("mbps", "modulation", "nbpsc", "ncbps", "ndbps",
                 "num", "den", "rate_bits")

    def __init__(self, mbps, modulation, nbpsc, num, den, rate_bits):
        self.mbps = mbps
        self.modulation = modulation
        self.nbpsc = nbpsc
        self.ncbps = 48 * nbpsc
        self.num, self.den = num, den          # code rate num/den
        self.ndbps = self.ncbps * num // den
        self.rate_bits = rate_bits


RATES = {
    6:  RateParam(6,  "bpsk",  1, 1, 2, 0b1101),
    9:  RateParam(9,  "bpsk",  1, 3, 4, 0b1111),
    12: RateParam(12, "qpsk",  2, 1, 2, 0b0101),
    18: RateParam(18, "qpsk",  2, 3, 4, 0b0111),
    24: RateParam(24, "qam16", 4, 1, 2, 0b1001),
    36: RateParam(36, "qam16", 4, 3, 4, 0b1011),
    48: RateParam(48, "qam64", 6, 2, 3, 0b0001),
    54: RateParam(54, "qam64", 6, 3, 4, 0b0011),
}
RATE_BY_BITS = {r.rate_bits: r for r in RATES.values()}

# ----------------------------------------------------------------------------
# Scrambler x^7 + x^4 + 1 (Clause 17.3.5.4; scramble.hpp:9-355)
# ----------------------------------------------------------------------------


def scrambler_sequence(n: int, seed: int) -> np.ndarray:
    """First n output bits of the 127-periodic scrambler for a 7-bit seed.

    State convention: bit i of ``seed`` is x_{i+1}; feedback/output is
    x7 xor x4, which becomes the new x1.
    """
    period = np.zeros(127, dtype=np.uint8)
    x = [(seed >> i) & 1 for i in range(7)]
    for i in range(127):
        fb = x[6] ^ x[3]
        period[i] = fb
        x = [fb] + x[:6]
    reps = -(-n // 127)
    return np.tile(period, reps)[:n]


# Pilot polarity p_0..p_126: the scrambler run from the all-ones seed,
# mapped 0 -> +1, 1 -> -1 (Clause 17.3.5.9; lutst/pilotsgn.c).
PILOT_POLARITY = (1 - 2 * scrambler_sequence(127, 0x7F).astype(np.int64))

# ----------------------------------------------------------------------------
# Convolutional code K=7, g0=133, g1=171 octal (Clause 17.3.5.5)
# ----------------------------------------------------------------------------
G0, G1 = 0o133, 0o171


def _build_trellis():
    """State = 6 most recent input bits, newest at MSB.

    Transition: from state s with input b the 7-bit register is
    (b<<6)|s; outputs are parity(reg & G); the next state is reg >> 1.
    This matches the generator tap layout of lutst/conv_encoder_1_2.c.
    """
    out_a = np.zeros((64, 2), np.uint8)
    out_b = np.zeros((64, 2), np.uint8)
    nxt = np.zeros((64, 2), np.int64)
    for s in range(64):
        for b in (0, 1):
            reg = (b << 6) | s
            out_a[s, b] = bin(reg & G0).count("1") & 1
            out_b[s, b] = bin(reg & G1).count("1") & 1
            nxt[s, b] = reg >> 1
    return out_a, out_b, nxt


CONV_OUT_A, CONV_OUT_B, CONV_NEXT = _build_trellis()

# Butterfly view used by the vectorized float ACS (dsp.viterbi):
# the two predecessors of state s are p = 2*(s % 32) + {0,1} and the input
# bit that caused the transition is s >> 5.  Emitted coded bits depend only
# on (p, b): tabulate per (u = s % 32, j = pred LSB, b = s >> 5).
_u = np.arange(32)
BFLY_PRED = np.stack([2 * _u, 2 * _u + 1], axis=1)               # (32, 2)
# out bits for transition pred -> (u + 32*b): (32, 2, 2) = [u, j, b]
BFLY_OUT_A = CONV_OUT_A[BFLY_PRED[:, :, None], np.arange(2)[None, None, :]]
BFLY_OUT_B = CONV_OUT_B[BFLY_PRED[:, :, None], np.arange(2)[None, None, :]]

# Puncturing patterns over (A, B) streams (Clause 17.3.5.6).
# True = transmitted.  Period is in input bit pairs.
PUNCTURE = {
    (1, 2): (np.array([True]), np.array([True])),
    (2, 3): (np.array([True, True]), np.array([True, False])),
    (3, 4): (np.array([True, True, False]), np.array([True, False, True])),
}

# ----------------------------------------------------------------------------
# Interleaver (Clause 17.3.5.6; lutst/interleave_*.c equivalents)
# ----------------------------------------------------------------------------


def interleaver_permutation(ncbps: int, nbpsc: int) -> np.ndarray:
    """perm such that interleaved[perm[k]] = coded[k]."""
    s = max(nbpsc // 2, 1)
    k = np.arange(ncbps)
    i = (ncbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + ncbps - (16 * i // ncbps)) % s
    return j


# NOTE on usage: with fwd = interleaver_permutation, TX does
#   interleaved[fwd] = coded        (scatter)
# and RX recovers
#   coded = interleaved[fwd]        (gather with the same index vector)

# ----------------------------------------------------------------------------
# Constellations (Clause 17.3.5.7; lutst/mapa_*.c equivalents)
# ----------------------------------------------------------------------------
# Bit-to-level Gray mapping per axis, LSB-first within each axis group.
_BPSK_LVL = np.array([-1.0, 1.0])
_QPSK_LVL = np.array([-1.0, 1.0]) / np.sqrt(2.0)
_QAM16_LVL = np.array([-3.0, -1.0, 1.0, 3.0])[[0, 1, 3, 2]] / np.sqrt(10.0)
# b0b1: 00->-3 01->-1 11->+1 10->+3
_QAM64_LVL = (np.array([-7.0, -5.0, -3.0, -1.0, 1.0, 3.0, 5.0, 7.0])
              [[0, 1, 3, 2, 7, 6, 4, 5]] / np.sqrt(42.0))
# b0b1b2: 000->-7 001->-5 011->-3 010->-1 110->1 111->3 101->5 100->7

KMOD = {"bpsk": 1.0, "qpsk": np.sqrt(2.0), "qam16": np.sqrt(10.0),
        "qam64": np.sqrt(42.0)}


def map_bits(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Map bits (n*nbpsc,) -> complex symbols (n,), unit average power."""
    if modulation == "bpsk":
        return _BPSK_LVL[bits].astype(np.complex128)
    if modulation == "qpsk":
        b = bits.reshape(-1, 2)
        return _QPSK_LVL[b[:, 0]] + 1j * _QPSK_LVL[b[:, 1]]
    if modulation == "qam16":
        b = bits.reshape(-1, 4)
        return (_QAM16_LVL[2 * b[:, 0] + b[:, 1]]
                + 1j * _QAM16_LVL[2 * b[:, 2] + b[:, 3]])
    if modulation == "qam64":
        b = bits.reshape(-1, 6)
        return (_QAM64_LVL[4 * b[:, 0] + 2 * b[:, 1] + b[:, 2]]
                + 1j * _QAM64_LVL[4 * b[:, 3] + 2 * b[:, 4] + b[:, 5]])
    raise ValueError(modulation)


def demap_soft(sym: np.ndarray, modulation: str) -> np.ndarray:
    """Per-bit soft metrics (positive => bit 1), shape (n, nbpsc).

    Piecewise-linear max-log LLR approximations, scaled by KMOD so the
    metric magnitude is in "distance between adjacent levels" units — the
    same normalization the reference demapper LUTs bake in
    (kernel/bb/Brick11/src/demapper11a.hpp + dsp_demap.h).
    """
    I, Q = np.real(sym), np.imag(sym)
    if modulation == "bpsk":
        return I[:, None]
    if modulation == "qpsk":
        return np.stack([I, Q], -1) * np.sqrt(2.0)
    if modulation == "qam16":
        f = np.sqrt(10.0)
        return np.stack(
            [I, 2 / f - np.abs(I), Q, 2 / f - np.abs(Q)], -1) * f
    if modulation == "qam64":
        f = np.sqrt(42.0)
        return np.stack(
            [I, 4 / f - np.abs(I), 2 / f - np.abs(np.abs(I) - 4 / f),
             Q, 4 / f - np.abs(Q), 2 / f - np.abs(np.abs(Q) - 4 / f)],
            -1) * f
    raise ValueError(modulation)
