"""The 802.11n HT mixed-mode preamble in float64 numpy — the port's own
copy of the symbol builders of the JAX package's golden model
(``sora_tpu/golden/dot11n_np.py``) that its TX bakes into constants.

L-STF / L-LTF / L-SIG / HT-SIG1-2 / HT-STF / HT-LTF(s) depend only on
(MCS, PSDU length, guard interval), so ``phy.dot11n.tx`` computes them
once here and casts them to complex64, like the reference's preamble
tables (_b_htltf.h / _b_htstf.h / _b_htsig.h).  The convolutional code
is the port's numpy encoder of ``phy.dot11a.rx``.
"""

from __future__ import annotations

import numpy as np

from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy import dot11n_common as N
from sora_tpu_torch.phy.dot11a.rx import _conv_encode_np


def _csd_factor(shift: int, sc: np.ndarray) -> np.ndarray:
    """Frequency-domain cyclic-shift phasor for a shift of `shift` samples
    (negative = delayed), on subcarrier set sc."""
    return np.exp(-2j * np.pi * sc * shift / N.NFFT)


def _legacy_symbol(freq_on_legacy_sc: np.ndarray, ant: int) -> np.ndarray:
    """One 80-sample legacy-numerology symbol on TX chain `ant` (CSD + GI),
    1/sqrt(2) per-chain scaling."""
    f = freq_on_legacy_sc * _csd_factor(N.CSD_LEGACY[ant], C.SC_IDX)
    x = np.zeros(N.NFFT, dtype=np.complex128)
    x[C.OCC_BINS] = f
    t = np.fft.ifft(x) * N.NFFT / np.sqrt(52.0) / np.sqrt(2.0)
    return np.concatenate([t[-16:], t])


def _ht_symbol(freq_on_ht_sc: np.ndarray, stream: int,
               gi: int = 16) -> np.ndarray:
    """One (64+gi)-sample HT-numerology symbol for spatial stream
    `stream` (gi = 16 for the 800 ns guard, 8 for short GI)."""
    f = freq_on_ht_sc * _csd_factor(N.CSD_HT[stream], N.HT_SC_IDX)
    t = N.ht_time_symbol(f) / np.sqrt(2.0)
    return np.concatenate([t[-gi:], t])


def _legacy_preamble(ant: int) -> np.ndarray:
    """L-STF + L-LTF (320 samples) for TX chain `ant`: the canonical
    preamble cyclically shifted per symbol period."""
    d = N.CSD_LEGACY[ant]
    sts = np.tile(np.roll(C.STS_TIME_PERIOD, d), 10)
    lts = np.roll(C.LTS_TIME_SYM, d)
    pre = np.concatenate([sts, lts[-32:], lts, lts])
    return pre / np.sqrt(2.0)


def _lsig_bits(mcs: int, length: int, nsym: int,
               n_ltf: int = 2) -> np.ndarray:
    """Spoofed legacy SIGNAL for HT mixed mode: rate 6 Mbps, L-LENGTH
    covering the HT part duration (Clause 20.3.9.3.5)."""
    txtime_after = 8 + 4 + 4 * n_ltf + 4 * nsym  # HT-SIG+STF+LTFs+data, us
    llen = max(1, min(4095, 3 * ((txtime_after + 3) // 4) - 3))
    sig = np.zeros(24, np.uint8)
    rate_bits = C.RATES[6].rate_bits
    for i in range(4):
        sig[i] = (rate_bits >> (3 - i)) & 1
    for i in range(12):
        sig[5 + i] = (llen >> i) & 1
    sig[17] = sig[:17].sum() & 1
    return sig


def _encode_legacy_symbolbits(bits24: np.ndarray) -> np.ndarray:
    """24 bits -> 48 interleaved coded bits (one legacy BPSK symbol)."""
    coded = _conv_encode_np(np.asarray(bits24, np.uint8)[None])[0]
    inter = np.zeros(48, np.uint8)
    inter[C.interleaver_permutation(48, 1)] = coded.reshape(48)
    return inter


def _legacy_data_freq(bits48: np.ndarray, pol_idx: int,
                      qbpsk: bool = False) -> np.ndarray:
    """Legacy-carrier-set frequency symbol from 48 BPSK bits."""
    f = np.zeros(53, dtype=np.complex128)
    vals = C.map_bits(bits48, "bpsk")
    if qbpsk:
        vals = 1j * vals
    f[(C.DATA_SC + 26)] = vals
    f[(C.PILOT_SC + 26)] = C.PILOT_VAL * C.PILOT_POLARITY[pol_idx % 127]
    return f


def _leg_sym_1ss(freq):
    x = np.zeros(N.NFFT, dtype=np.complex128)
    x[C.OCC_BINS] = freq
    t = np.fft.ifft(x) * N.NFFT / np.sqrt(52.0)
    return np.concatenate([t[-16:], t])


def _ht_sym_1ss(freq, gi: int = 16):
    t = N.ht_time_symbol(freq)
    return np.concatenate([t[-gi:], t])


def _preamble_1ss(mcs_idx: int, length: int, nsym: int,
                  short_gi: bool = False) -> np.ndarray:
    """(720,) single-chain preamble: L-STF/L-LTF/L-SIG/HT-SIG x2/HT-STF/
    one HT-LTF — full scale, no CSD."""
    lsig = _lsig_bits(mcs_idx, length, nsym, n_ltf=1)
    htsig = N.htsig_bits(mcs_idx, length, short_gi=short_gi)
    sts = np.tile(C.STS_TIME_PERIOD, 10)
    lts = np.asarray(C.LTS_TIME_SYM)
    parts = [np.concatenate([sts, lts[-32:], lts, lts])]
    parts.append(_leg_sym_1ss(_legacy_data_freq(
        _encode_legacy_symbolbits(lsig), 0)))
    parts.append(_leg_sym_1ss(_legacy_data_freq(
        _encode_legacy_symbolbits(htsig[:24]), 1, qbpsk=True)))
    parts.append(_leg_sym_1ss(_legacy_data_freq(
        _encode_legacy_symbolbits(htsig[24:]), 2, qbpsk=True)))
    fstf = np.zeros(len(N.HT_SC_IDX), np.complex128)
    fstf[(C.SC_IDX + 28)] = C.STS_FREQ
    parts.append(_ht_sym_1ss(fstf))
    parts.append(_ht_sym_1ss(N.HTLTF_FREQ))   # single HT-LTF, P = [1]
    return np.concatenate(parts)


def preamble_2ss(mcs: int, psdu_len: int, nsym: int,
                 short_gi: bool = False) -> np.ndarray:
    """(2, 800) complex128 two-chain preamble: everything before the first
    data symbol of a 2-stream frame (legacy part with the legacy CSD, two
    P-mapped HT-LTFs)."""
    lsig = _lsig_bits(mcs, psdu_len, nsym)
    htsig = N.htsig_bits(mcs, psdu_len, short_gi=short_gi)
    chains = []
    for ant in range(2):
        parts = [_legacy_preamble(ant)]
        parts.append(_legacy_symbol(
            _legacy_data_freq(_encode_legacy_symbolbits(lsig), 0), ant))
        parts.append(_legacy_symbol(_legacy_data_freq(
            _encode_legacy_symbolbits(htsig[:24]), 1, qbpsk=True), ant))
        parts.append(_legacy_symbol(_legacy_data_freq(
            _encode_legacy_symbolbits(htsig[24:]), 2, qbpsk=True), ant))
        fstf = np.zeros(len(N.HT_SC_IDX), np.complex128)
        fstf[(C.SC_IDX + 28)] = C.STS_FREQ
        parts.append(_ht_symbol(fstf, ant))
        for n in range(2):
            parts.append(_ht_symbol(N.P2[ant, n] * N.HTLTF_FREQ, ant))
        chains.append(np.concatenate(parts))
    return np.stack(chains)
