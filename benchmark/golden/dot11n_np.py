"""Pure-numpy golden model of the 802.11n HT 2x2 MIMO PHY (TX + RX).

The benchmark's frozen copy of ``sora_tpu_torch/golden/dot11n_np.py``.
Functional
equivalent of the reference brick graphs (kernel/bb/demod11/fb11nmod_config.hpp /
fb11ndemod_config.hpp:142-206): HT mixed-mode 20 MHz, 2 spatial streams,
direct spatial mapping, BCC coding, long GI.

TX: scramble -> BCC encode -> puncture -> stream parse -> per-stream HT
interleave -> map -> pilots -> IFFT/GI, with legacy+HT preambles and
per-chain cyclic shift (TCSD, csd.hpp).
RX: sync -> legacy chanest -> L-SIG check -> HT-SIG (QBPSK, CRC8) ->
2x2 MIMO channel est from the P-mapped HT-LTFs (TMimoChannelEst,
channel_11n.hpp:331-445) -> per-subcarrier ZF -> common pilot phase
track -> per-stream demap/deinterleave -> stream deparse -> depuncture ->
Viterbi -> descramble -> FCS.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.golden.dot11a_np import conv_encode, viterbi_decode
from benchmark.golden.frame import fcs32
from benchmark.golden import common as C
from benchmark.golden import n_common as N

# =============================================================================
# Coding helpers (generalized to the 5/6 rate)
# =============================================================================


def puncture(coded: np.ndarray, num: int, den: int) -> np.ndarray:
    pa, pb = N.puncture_pattern(num, den)
    ab = coded.reshape(-1, 2)
    keep = np.tile(np.stack([pa, pb], -1),
                   (len(ab) // len(pa) + 1, 1))[: len(ab)]
    return ab.reshape(-1)[keep.reshape(-1)]


def depuncture(soft: np.ndarray, num: int, den: int) -> np.ndarray:
    pa, pb = N.puncture_pattern(num, den)
    period = len(pa)
    ntx = int(pa.sum() + pb.sum())
    nper = len(soft) // ntx
    keep = np.tile(np.stack([pa, pb], -1).reshape(-1), nper).astype(bool)
    full = np.zeros(2 * period * nper, dtype=soft.dtype)
    full[keep] = soft[: int(keep.sum())]
    return full.reshape(-1, 2)


# =============================================================================
# Symbol builders
# =============================================================================


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
    coded = conv_encode(bits24)
    inter = np.zeros(48, np.uint8)
    inter[C.interleaver_permutation(48, 1)] = coded
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


# =============================================================================
# Transmitter
# =============================================================================


def num_symbols(mcs_idx: int, psdu_len: int) -> int:
    m = N.mcs_param(mcs_idx)
    return -(-(16 + 8 * psdu_len + 6) // m.ndbps)


def _modulate_1ss(psdu: bytes, mcs_idx: int,
                  scrambler_seed: int = 0x5D,
                  short_gi: bool = False) -> np.ndarray:
    """Single-spatial-stream HT TX (MCS 0-7, Table 20-30): one TX chain,
    no CSD, one HT-LTF, full-scale symbols.  -> (1, nsamples)."""
    m = N.MCS1[mcs_idx]
    length = len(psdu)
    nsym = num_symbols(mcs_idx, length)
    nbits = nsym * m.ndbps
    data = np.zeros(nbits, np.uint8)
    data[16: 16 + 8 * length] = np.unpackbits(
        np.frombuffer(psdu, np.uint8), bitorder="little")
    scrambled = data ^ C.scrambler_sequence(nbits, scrambler_seed)
    scrambled[16 + 8 * length: 16 + 8 * length + 6] = 0
    coded = puncture(conv_encode(scrambled), m.num, m.den)
    perm = N.ht_interleaver_permutation(m.nbpsc, 0)
    sym_freq = np.zeros((nsym, len(N.HT_SC_IDX)), np.complex128)
    for k in range(nsym):
        blk = coded[k * m.ncbpss: (k + 1) * m.ncbpss]
        inter = np.zeros(m.ncbpss, np.uint8)
        inter[perm] = blk
        f = np.zeros(len(N.HT_SC_IDX), np.complex128)
        f[(N.HT_DATA_SC + 28)] = C.map_bits(inter, m.modulation)
        f[(N.HT_PILOT_SC + 28)] = (N.PSI1[(np.arange(4) + k) % 4]
                                   * C.PILOT_POLARITY[(3 + k) % 127])
        sym_freq[k] = f
    parts = [_preamble_1ss(mcs_idx, length, nsym, short_gi)]
    for k in range(nsym):
        parts.append(_ht_sym_1ss(sym_freq[k], gi=8 if short_gi else 16))
    return np.concatenate(parts)[None, :]


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


def modulate(psdu: bytes, mcs_idx: int, scrambler_seed: int = 0x5D,
             short_gi: bool = False) -> np.ndarray:
    """PSDU -> (nss_tx, nsamples) 20 Msps waveform, one row per TX
    chain: (2, n) for MCS 8-15, (1, n) for single-stream MCS 0-7.
    ``short_gi`` uses the 400 ns data-symbol guard (HT-SIG bit 31)."""
    if mcs_idx in N.MCS1:
        return _modulate_1ss(psdu, mcs_idx, scrambler_seed, short_gi)
    m = N.MCS[mcs_idx]
    length = len(psdu)
    nsym = num_symbols(mcs_idx, length)

    # --- scramble + encode + puncture (one stream) --------------------------
    nbits = nsym * m.ndbps
    data = np.zeros(nbits, np.uint8)
    data[16: 16 + 8 * length] = np.unpackbits(
        np.frombuffer(psdu, np.uint8), bitorder="little")
    scrambled = data ^ C.scrambler_sequence(nbits, scrambler_seed)
    scrambled[16 + 8 * length: 16 + 8 * length + 6] = 0
    coded = puncture(conv_encode(scrambled), m.num, m.den)

    # --- stream parse + per-stream interleave + map -------------------------
    ncbps = 2 * m.ncbpss
    sp = N.stream_parse_indices(ncbps, m.nbpsc)            # (2, ncbpss)
    perms = [N.ht_interleaver_permutation(m.nbpsc, i) for i in range(2)]
    sym_freq = np.zeros((nsym, 2, len(N.HT_SC_IDX)), np.complex128)
    for k in range(nsym):
        blk = coded[k * ncbps: (k + 1) * ncbps]
        pol = C.PILOT_POLARITY[(3 + k) % 127]
        for i in range(2):
            sbits = blk[sp[i]]
            inter = np.zeros(m.ncbpss, np.uint8)
            inter[perms[i]] = sbits
            dsym = C.map_bits(inter, m.modulation)
            f = np.zeros(len(N.HT_SC_IDX), np.complex128)
            f[(N.HT_DATA_SC + 28)] = dsym
            f[(N.HT_PILOT_SC + 28)] = \
                N.PSI2[i, (np.arange(4) + k) % 4] * pol
            sym_freq[k, i] = f

    # --- assemble per-chain waveform -----------------------------------------
    lsig = _lsig_bits(mcs_idx, length, nsym)
    htsig = N.htsig_bits(mcs_idx, length, short_gi=short_gi)
    chains = []
    for ant in range(2):
        parts = [_legacy_preamble(ant)]
        parts.append(_legacy_symbol(
            _legacy_data_freq(_encode_legacy_symbolbits(lsig), 0), ant))
        parts.append(_legacy_symbol(_legacy_data_freq(
            _encode_legacy_symbolbits(htsig[:24]), 1, qbpsk=True), ant))
        parts.append(_legacy_symbol(_legacy_data_freq(
            _encode_legacy_symbolbits(htsig[24:]), 2, qbpsk=True), ant))
        # HT-STF (one 80-sample symbol of the legacy STS pattern, HT CSD)
        fstf = np.zeros(len(N.HT_SC_IDX), np.complex128)
        fstf[(C.SC_IDX + 28)] = C.STS_FREQ
        parts.append(_ht_symbol(fstf, ant))
        # 2 HT-LTFs with P mapping (this chain carries stream `ant`)
        for n in range(2):
            parts.append(_ht_symbol(N.P2[ant, n] * N.HTLTF_FREQ, ant))
        for k in range(nsym):
            parts.append(_ht_symbol(sym_freq[k, ant], ant,
                                    gi=8 if short_gi else 16))
        chains.append(np.concatenate(parts))
    return np.stack(chains)


def _demod_data_1ss(res, y, mcs_idx, length, per, gi):
    """Single-spatial-stream data section: (A x 1) channel from the one
    HT-LTF, MRC combine, PSI1 pilot rotation (the numpy oracle of
    phy.dot11n.rx.extract_symbols_1ss + decode_data_1ss)."""
    m = N.MCS1[mcs_idx]
    nsym = num_symbols(mcs_idx, length)
    ltf0 = 128 + 80 * 3 + 80
    data0 = ltf0 + 80                        # one HT-LTF
    if y.shape[1] < data0 + per * nsym:
        res.reason = "truncated"
        return res
    Y1 = _fft_sym(y, ltf0)                                # (A, 64)
    lseq = np.where(N.HTLTF_FREQ == 0, 1.0, N.HTLTF_FREQ)
    Hs = np.zeros((y.shape[0], 64), np.complex128)
    Hs[:, N.HT_OCC_BINS] = Y1[:, N.HT_OCC_BINS] / lseq[None, :]
    perm = N.ht_interleaver_permutation(m.nbpsc, 0)
    all_soft = np.zeros(nsym * m.ncbpss)
    den = (np.abs(Hs) ** 2).sum(0) + 1e-12
    for k in range(nsym):
        S = _fft_sym(y, data0 + per * k, gi)
        E = (np.conj(Hs) * S).sum(0) / den
        xp = E[N.HT_PILOT_BINS]
        pol = C.PILOT_POLARITY[(3 + k) % 127]
        expect = N.PSI1[(np.arange(4) + k) % 4] * pol
        ph = np.angle(np.sum(xp * expect))
        xd = E[N.HT_DATA_BINS] * np.exp(-1j * ph)
        sm = C.demap_soft(xd, m.modulation).reshape(-1)
        all_soft[k * m.ncbpss: (k + 1) * m.ncbpss] = sm[perm]

    bits = viterbi_decode(depuncture(all_soft, m.num, m.den))
    from benchmark.golden.dot11a_np import _seed_from_prefix
    seed = _seed_from_prefix(bits[:7])
    desc = bits ^ C.scrambler_sequence(len(bits), seed)
    psdu = np.packbits(desc[16: 16 + 8 * length],
                       bitorder="little").tobytes()
    res.psdu = psdu
    res.fcs_ok = len(psdu) >= 4 and fcs32(psdu[:-4]) == int.from_bytes(
        psdu[-4:], "little")
    res.ok = res.fcs_ok
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    return res


# =============================================================================
# Receiver
# =============================================================================


@dataclass
class RxResult:
    ok: bool = False
    reason: str = "no_frame"
    mcs: int = -1
    length: int = 0
    psdu: bytes = b""
    fcs_ok: bool = False
    start: int = -1
    cfo: float = 0.0
    _debug: dict = field(default_factory=dict)


def sync(x: np.ndarray, search: int = 4000):
    """2-antenna packet detect: antenna-summed autocorrelation metric
    (TCCA11n, cca_11n.hpp), LTS position from summed cross-correlation."""
    n = min(x.shape[1], search)
    seg = x[:, :n]
    ac = (seg[:, 16:] * np.conj(seg[:, :-16]))
    w = np.stack([np.convolve(a, np.ones(64), "valid") for a in ac])
    en = np.stack([np.convolve(np.abs(a) ** 2, np.ones(64), "valid")
                   for a in seg[:, :-16]])
    m = np.abs(w).sum(0) / (en.sum(0) + 1e-9)
    mm = m[: max(1, n - 500)]
    # CFO window: the plateau argmax can land at the STS/LTS boundary where
    # the 64-wide window straddles both and the lag-16 phase is garbage;
    # measure just after the plateau onset instead (strictly inside STS).
    onset = int(np.argmax(mm > 0.9 * float(mm.max())))
    sts = min(onset + 16, len(mm) - 1)
    cfo = float(np.angle(w[:, sts].sum())) / 16.0
    y = seg * np.exp(-1j * cfo * np.arange(n))[None, :]
    c = np.stack([np.abs(np.correlate(a, C.LTS_TIME_SYM, "valid"))
                  for a in y])
    cs = c.sum(0)
    c2 = cs[:-64] + cs[64:]
    return int(np.argmax(c2)), cfo


def _fft_sym(y: np.ndarray, start: int, gi: int = 16) -> np.ndarray:
    """(ants, 64) FFT of the symbol whose GI starts at `start`."""
    return np.fft.fft(y[:, start + gi: start + gi + 64], axis=1)


def demodulate(x: np.ndarray, expect_mcs: int | None = None) -> RxResult:
    """Full HT frame RX; x: (n_rx_ant, nsamples) at 20 Msps.  Handles
    2-stream MCS 8-15 (2x2 ZF), single-stream MCS 0-7 (MRC over the RX
    antennas), and the short guard interval, routed by HT-SIG."""
    res = RxResult()
    if x.ndim != 2 or x.shape[0] not in (1, 2) or x.shape[1] < 900:
        return res
    lts1, cfo = sync(x)
    res.start, res.cfo = lts1, cfo
    y = x[:, lts1:] * np.exp(
        -1j * cfo * np.arange(x.shape[1] - lts1))[None, :]
    if y.shape[1] < 700:
        return res
    fine = float(np.angle(np.vdot(y[:, :64], y[:, 64:128]))) / 64.0
    res.cfo = cfo + fine
    y = y * np.exp(-1j * fine * np.arange(y.shape[1]))[None, :]

    # legacy channel estimate per RX antenna (T11aLTS analogue)
    L = 0.5 * (np.fft.fft(y[:, :64], axis=1)
               + np.fft.fft(y[:, 64:128], axis=1))
    Xk = np.zeros(64)
    Xk[C.OCC_BINS] = C.LTS_FREQ
    occ = Xk != 0
    Hleg = np.zeros((x.shape[0], 64), np.complex128)
    Hleg[:, occ] = L[:, occ] / Xk[occ][None, :]

    def mrc_equalize(start: int, pol_idx: int) -> np.ndarray:
        """Legacy-set symbol -> (52,) MRC-combined equalized carriers
        (TMrcCombine, PHY_11n.hpp:364)."""
        S = _fft_sym(y, start)
        num = (np.conj(Hleg) * S).sum(0)
        den = (np.abs(Hleg) ** 2).sum(0) + 1e-12
        E = np.zeros(64, np.complex128)
        E[occ] = num[occ] / den[occ]
        pv = E[C.PILOT_BINS] * (C.PILOT_VAL * C.PILOT_POLARITY[pol_idx])
        return E * np.exp(-1j * np.angle(pv.sum()))

    # --- L-SIG gate ----------------------------------------------------------
    sig = mrc_equalize(128, 0)[C.DATA_BINS]
    gain = float(np.mean(np.abs(sig))) + 1e-12
    soft = (np.real(sig) / gain)[C.interleaver_permutation(48, 1)]
    lsig = viterbi_decode(np.stack([soft[0::2], soft[1::2]], -1))
    if (lsig[:17].sum() & 1) != lsig[17]:
        res.reason = "plcp_header_fail"
        return res

    # --- HT-SIG (QBPSK: constellation on the imaginary axis) ---------------
    softs = []
    for s, pol in ((208, 1), (288, 2)):
        E = mrc_equalize(s, pol)[C.DATA_BINS] / gain
        softs.append(np.imag(E)[C.interleaver_permutation(48, 1)])
    hs = np.concatenate(softs)
    htsig = viterbi_decode(np.stack([hs[0::2], hs[1::2]], -1))
    mcs_idx, length, crc_ok = N.parse_htsig(htsig)
    if not crc_ok or (mcs_idx not in N.MCS and mcs_idx not in N.MCS1):
        res.reason = "htsig_fail"
        return res
    res.mcs, res.length = mcs_idx, length
    if expect_mcs is not None and mcs_idx != expect_mcs:
        res.reason = "unexpected_mcs"
        return res
    sgi = bool(htsig[31])
    per = 72 if sgi else 80
    gi = per - 64
    if mcs_idx in N.MCS1:
        return _demod_data_1ss(res, y, mcs_idx, length, per, gi)
    m = N.MCS[mcs_idx]
    nsym = num_symbols(mcs_idx, length)
    data0 = 128 + 80 * 3 + 80 + 160          # L-SIG+HT-SIG(2)+HT-STF+2 LTF
    if y.shape[1] < data0 + per * nsym:
        res.reason = "truncated"
        return res

    # --- 2x2 MIMO channel estimate from the HT-LTFs -------------------------
    ltf0 = 128 + 80 * 3 + 80
    Y = np.stack([_fft_sym(y, ltf0), _fft_sym(y, ltf0 + 80)], axis=2)
    # Y[ant, bin, ltf] = sum_i H[ant, i, bin] * P2[i, ltf] * Lseq[bin]
    occ_ht = N.HT_OCC_BINS
    H = np.zeros((64, 2, 2), np.complex128)
    Yo = Y[:, occ_ht, :]                                  # (2, 57, 2)
    Ht = np.einsum("abn,nm->bam", Yo, N.P2_INV)           # (57, 2ant, 2sts)
    lseq = np.where(N.HTLTF_FREQ == 0, 1.0, N.HTLTF_FREQ)
    H[occ_ht] = Ht / lseq[:, None, None]
    # zero-subcarrier guard (DC has no LTF energy)
    H[occ_ht[N.HTLTF_FREQ == 0]] = np.eye(2)

    # --- per-symbol ZF detection + pilot phase track ------------------------
    dbins = (N.HT_DATA_SC + 28)
    pbins = (N.HT_PILOT_SC + 28)
    Hd = H[N.HT_DATA_BINS]                                # (52, 2, 2)
    Hp = H[N.HT_PILOT_BINS]
    perms = [N.ht_interleaver_permutation(m.nbpsc, i) for i in range(2)]
    sp = N.stream_parse_indices(2 * m.ncbpss, m.nbpsc)
    all_soft = np.zeros(nsym * 2 * m.ncbpss)
    for k in range(nsym):
        S = _fft_sym(y, data0 + per * k, gi)
        xd = np.linalg.solve(Hd, S[:, N.HT_DATA_BINS].T[:, :, None])[..., 0]
        xp = np.linalg.solve(Hp, S[:, N.HT_PILOT_BINS].T[:, :, None])[..., 0]
        pol = C.PILOT_POLARITY[(3 + k) % 127]
        expect = N.PSI2[:, (np.arange(4) + k) % 4].T * pol    # (4, 2)
        ph = np.angle(np.sum(xp * np.conj(expect)))
        xd = xd * np.exp(-1j * ph)
        merged = np.zeros(2 * m.ncbpss)
        for i in range(2):
            sm = C.demap_soft(xd[:, i], m.modulation).reshape(-1)
            merged[sp[i]] = sm[perms[i]]
        all_soft[k * 2 * m.ncbpss: (k + 1) * 2 * m.ncbpss] = merged

    bits = viterbi_decode(depuncture(all_soft, m.num, m.den))
    from benchmark.golden.dot11a_np import _seed_from_prefix
    seed = _seed_from_prefix(bits[:7])
    desc = bits ^ C.scrambler_sequence(len(bits), seed)
    psdu = np.packbits(desc[16: 16 + 8 * length],
                       bitorder="little").tobytes()
    res.psdu = psdu
    res.fcs_ok = len(psdu) >= 4 and fcs32(psdu[:-4]) == int.from_bytes(
        psdu[-4:], "little")
    res.ok = res.fcs_ok
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    return res
