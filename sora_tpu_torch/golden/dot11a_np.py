"""Pure-numpy golden model of the 802.11a PHY (TX + RX).

The port's own copy of ``sora_tpu.golden.dot11a_np``: slow, simple, and
verified end-to-end against the reference capture
``kernel/test-data/fsample-6.dmp`` (the 6 Mbps frame decodes with a valid
FCS).  Functionally equivalent to the reference brick graphs:

* TX: kernel/bb/demod11/fb11amod_config.hpp:75-112
  (TBB11aSrc -> scramble -> conv-encode -> interleave -> map -> pilots ->
   IFFT -> GI, plus the TTS11aSrc preamble)
* RX: kernel/bb/demod11/fb11ademod_config.hpp:148-218
  (CCA/sync -> LTS channel est -> CFO comp -> FFT -> equalize -> pilot
   track -> demap -> deinterleave -> depuncture -> Viterbi -> descramble ->
   CRC32 frame sink)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from sora_tpu_torch.phy import common as C
from sora_tpu_torch.mac.frame import fcs32

# =============================================================================
# Convolutional encode / Viterbi decode
# =============================================================================


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 encode; returns interleaved A,B stream (2n,)."""
    out = np.zeros(2 * len(bits), dtype=np.uint8)
    s = 0
    for i, b in enumerate(bits):
        out[2 * i] = C.CONV_OUT_A[s, b]
        out[2 * i + 1] = C.CONV_OUT_B[s, b]
        s = C.CONV_NEXT[s, b]
    return out


def puncture(coded: np.ndarray, num: int, den: int) -> np.ndarray:
    pa, pb = C.PUNCTURE[(num, den)]
    ab = coded.reshape(-1, 2)
    period = len(pa)
    keep = np.tile(np.stack([pa, pb], -1), (len(ab) // period + 1, 1))[: len(ab)]
    return ab.reshape(-1)[keep.reshape(-1)]


def depuncture(soft: np.ndarray, num: int, den: int) -> np.ndarray:
    """Insert 0-confidence erasures; returns (n, 2) A/B soft pairs."""
    pa, pb = C.PUNCTURE[(num, den)]
    period = len(pa)
    ntx_per_period = int(pa.sum() + pb.sum())
    nper = len(soft) // ntx_per_period
    keep = np.tile(np.stack([pa, pb], -1).reshape(-1), nper).astype(bool)
    full = np.zeros(2 * period * nper, dtype=soft.dtype)
    full[keep] = soft[: int(keep.sum())]
    return full.reshape(-1, 2)


def viterbi_decode(soft_ab: np.ndarray) -> np.ndarray:
    """64-state soft Viterbi over (T, 2) A/B metrics (positive => bit 1).

    Vectorized over states using the butterfly structure (see
    sora_tpu_torch.phy.common.BFLY_*); functional equivalent of the reference
    SIMD trellis (kernel/bb/Brick11/src/viterbicore.h:269-556) without the
    int8 saturation or bounded traceback — this is the oracle, exact over
    the full trellis.
    """
    T = len(soft_ab)
    # branch cost of emitting bit c given soft metric m: c ? -m : +m
    sa = soft_ab[:, 0]
    sb = soft_ab[:, 1]
    # (T, 32, 2, 2): cost for [u, pred j, input b]
    cost = (np.where(C.BFLY_OUT_A[None], -sa[:, None, None, None],
                     sa[:, None, None, None])
            + np.where(C.BFLY_OUT_B[None], -sb[:, None, None, None],
                       sb[:, None, None, None]))
    pm = np.full(64, 1e30)
    pm[0] = 0.0
    decisions = np.zeros((T, 64), dtype=np.uint8)
    for t in range(T):
        pairs = pm.reshape(32, 2)                       # [u, j]
        cand = pairs[:, :, None] + cost[t]              # (32, 2, 2)
        dec = np.argmin(cand, axis=1).astype(np.uint8)  # (32, 2) over j
        best = np.min(cand, axis=1)                     # (32, 2) [u, b]
        # next state s = u + 32*b  ->  order (b, u) flattened
        pm = best.T.reshape(64)
        pm -= pm.min()
        decisions[t] = dec.T.reshape(64)
    s = int(np.argmin(pm))
    bits = np.zeros(T, dtype=np.uint8)
    for t in range(T - 1, -1, -1):
        bits[t] = s >> 5
        s = 2 * (s & 31) + decisions[t, s]
    return bits


# =============================================================================
# Transmitter
# =============================================================================


def _symbolize(interleaved: np.ndarray, rate: C.RateParam) -> np.ndarray:
    """interleaved bits -> time-domain symbols (nsym, 80) @20 Msps."""
    nsym = len(interleaved) // rate.ncbps
    pilots_pol = C.PILOT_POLARITY[(1 + np.arange(nsym)) % 127]
    syms = np.zeros((nsym, 80), dtype=np.complex128)
    for k in range(nsym):
        chunk = interleaved[k * rate.ncbps: (k + 1) * rate.ncbps]
        data = C.map_bits(chunk, rate.modulation)
        X = np.zeros(64, dtype=np.complex128)
        X[C.DATA_BINS] = data
        X[C.PILOT_BINS] = C.PILOT_VAL * pilots_pol[k]
        x = np.fft.ifft(X) * 64 / np.sqrt(52.0)
        syms[k] = np.concatenate([x[-16:], x])
    return syms


def modulate(psdu: bytes, rate_mbps: int, scrambler_seed: int = 0x5D
             ) -> np.ndarray:
    """Full 802.11a TX: PSDU bytes -> 20 Msps complex baseband.

    Mirrors TBB11aSrc + the mod graph (fb11amod_config.hpp:75-112):
    SIGNAL symbol at 6 Mbps, then DATA = SERVICE(16) | PSDU | tail | pad,
    scrambled (tail bits cleared), convolutionally encoded, punctured,
    interleaved, mapped, piloted, IFFT'd with 16-sample GI, preceded by the
    320-sample preamble.
    """
    rate = C.RATES[rate_mbps]
    length = len(psdu)

    # --- SIGNAL (always BPSK rate 1/2, own symbol) -------------------------
    sig = np.zeros(24, dtype=np.uint8)
    for i in range(4):
        sig[i] = (rate.rate_bits >> (3 - i)) & 1
    for i in range(12):
        sig[5 + i] = (length >> i) & 1
    sig[17] = sig[:17].sum() & 1
    sig_coded = conv_encode(sig)
    sig_inter = np.zeros(48, dtype=np.uint8)
    sig_inter[C.interleaver_permutation(48, 1)] = sig_coded
    sig_sym = _symbolize_signal(sig_inter)

    # --- DATA --------------------------------------------------------------
    psdu_bits = np.unpackbits(np.frombuffer(psdu, np.uint8), bitorder="little")
    ndata = 16 + 8 * length + 6
    nsym = -(-ndata // rate.ndbps)
    nbits = nsym * rate.ndbps
    data = np.zeros(nbits, dtype=np.uint8)
    data[16: 16 + 8 * length] = psdu_bits
    scr = C.scrambler_sequence(nbits, scrambler_seed)
    scrambled = data ^ scr
    scrambled[16 + 8 * length: 16 + 8 * length + 6] = 0   # tail stays zero
    coded = puncture(conv_encode(scrambled), rate.num, rate.den)
    perm = C.interleaver_permutation(rate.ncbps, rate.nbpsc)
    inter = np.zeros_like(coded)
    for k in range(nsym):
        blk = coded[k * rate.ncbps: (k + 1) * rate.ncbps]
        out = np.zeros(rate.ncbps, dtype=np.uint8)
        out[perm] = blk
        inter[k * rate.ncbps: (k + 1) * rate.ncbps] = out
    data_syms = _symbolize(inter, rate)

    body = np.concatenate([sig_sym.reshape(-1), data_syms.reshape(-1)])
    return np.concatenate([C.PREAMBLE_TIME, body]).astype(np.complex128)


def _symbolize_signal(inter48: np.ndarray) -> np.ndarray:
    X = np.zeros(64, dtype=np.complex128)
    X[C.DATA_BINS] = C.map_bits(inter48, "bpsk")
    X[C.PILOT_BINS] = C.PILOT_VAL * C.PILOT_POLARITY[0]
    x = np.fft.ifft(X) * 64 / np.sqrt(52.0)
    return np.concatenate([x[-16:], x])


# =============================================================================
# Receiver
# =============================================================================


@dataclass
class RxResult:
    ok: bool = False
    reason: str = "no_frame"
    rate_mbps: int = 0
    length: int = 0
    psdu: bytes = b""
    fcs_ok: bool = False
    start: int = -1           # LTS1 start (sample index @20 Msps)
    cfo: float = 0.0          # rad/sample
    evm_db: float = 0.0
    nsym: int = 0
    snr_est_db: float = 0.0
    _debug: dict = field(default_factory=dict)


def sync(x: np.ndarray, search: int = 4000) -> tuple[int, float]:
    """Packet detect + symbol timing: coarse CFO from STS autocorrelation,
    LTS position from cross-correlation.  Returns (lts1_start, coarse_cfo).

    Vectorized replacement for the per-sample TCCA11a state machine
    (kernel/bb/Brick11/src/cca.hpp:106-441): correlation scores for all
    offsets at once, then argmax."""
    n = min(len(x), search)
    seg = x[:n]
    # coarse CFO: lag-16 autocorrelation over the strongest STS window
    ac = seg[16:] * np.conj(seg[:-16])
    w = np.convolve(ac, np.ones(64), "valid")
    en = np.convolve(np.abs(seg[:-16]) ** 2, np.ones(64), "valid")
    m = np.abs(w) / (en + 1e-9)
    sts_pos = int(np.argmax(m[: max(1, n - 400)]))
    coarse_cfo = float(np.angle(w[sts_pos])) / 16.0
    # LTS cross-correlation after coarse CFO removal
    y = seg * np.exp(-1j * coarse_cfo * np.arange(n))
    c = np.abs(np.correlate(y, C.LTS_TIME_SYM, "valid"))
    c2 = c[:-64] + c[64:]                   # two repeats 64 apart
    lts1 = int(np.argmax(c2))
    return lts1, coarse_cfo


def demodulate(x: np.ndarray, expect_rate: int | None = None) -> RxResult:
    """Full frame RX on a 20 Msps stream containing one frame."""
    res = RxResult()
    if len(x) < 400:
        return res
    lts1, coarse_cfo = sync(x)
    res.start = lts1
    y = x[lts1:] * np.exp(-1j * coarse_cfo * np.arange(len(x) - lts1))
    if len(y) < 240:
        return res
    # fine CFO from the two LTS repeats
    fine = float(np.angle(np.vdot(y[:64], y[64:128]))) / 64.0
    res.cfo = coarse_cfo + fine
    y = y * np.exp(-1j * fine * np.arange(len(y)))
    # channel estimate (T11aLTS: channel_11a.hpp:34-233)
    L = 0.5 * (np.fft.fft(y[:64]) + np.fft.fft(y[64:128]))
    Xk = np.zeros(64)
    Xk[C.OCC_BINS] = C.LTS_FREQ
    H = np.zeros(64, dtype=np.complex128)
    occ = Xk != 0
    H[occ] = L[occ] / Xk[occ]
    res._debug["H"] = H
    # noise estimate from LTS repeat difference
    nvar = np.mean(np.abs(y[:64] - y[64:128]) ** 2) / 2 + 1e-12
    sig_p = np.mean(np.abs(H[occ]) ** 2)
    res.snr_est_db = float(10 * np.log10(sig_p / nvar))

    def equalize(k: int, pol_idx: int) -> np.ndarray:
        """Symbol k (0 = SIGNAL): CP-skip, FFT, equalize, pilot phase fix."""
        s = y[128 + 80 * k + 16: 128 + 80 * k + 80]
        S = np.fft.fft(s)
        E = np.zeros(64, dtype=np.complex128)
        E[occ] = S[occ] / H[occ]
        pv = E[C.PILOT_BINS] * (C.PILOT_VAL * C.PILOT_POLARITY[pol_idx % 127])
        ph = np.angle(pv.sum())
        return E * np.exp(-1j * ph)

    # --- SIGNAL ------------------------------------------------------------
    if len(y) < 208:
        return res
    sig = equalize(0, 0)[C.DATA_BINS]
    # gain reference: SIGNAL is BPSK at |E| == 1 for a standard transmitter;
    # normalizing here makes the QAM demap robust to TX scale conventions
    # (the reference bakes the equivalent into its demap LUT fixed point).
    gain = float(np.mean(np.abs(sig))) + 1e-12
    sig = sig / gain
    soft = C.demap_soft(sig, "bpsk").reshape(-1)
    de = soft[C.interleaver_permutation(48, 1)]
    sig_bits = viterbi_decode(de.reshape(-1, 2))
    rate_bits = (sig_bits[0] << 3) | (sig_bits[1] << 2) | \
        (sig_bits[2] << 1) | sig_bits[3]
    parity_ok = (sig_bits[:17].sum() & 1) == sig_bits[17]
    length = int(np.sum(sig_bits[5:17].astype(np.int64) << np.arange(12)))
    if not parity_ok or rate_bits not in C.RATE_BY_BITS or length == 0:
        res.reason = "plcp_header_fail"
        return res
    rate = C.RATE_BY_BITS[rate_bits]
    res.rate_mbps = rate.mbps
    res.length = length
    if expect_rate is not None and rate.mbps != expect_rate:
        res.reason = "unexpected_rate"
        return res

    # --- DATA --------------------------------------------------------------
    nsym = -(-(16 + 8 * length + 6) // rate.ndbps)
    res.nsym = nsym
    if len(y) < 128 + 80 * (nsym + 1):
        res.reason = "truncated"
        return res
    perm = C.interleaver_permutation(rate.ncbps, rate.nbpsc)
    softs = np.zeros(nsym * rate.ncbps)
    evm = 0.0
    for k in range(1, nsym + 1):
        E = equalize(k, k)[C.DATA_BINS] / gain
        sm = C.demap_soft(E, rate.modulation).reshape(-1)
        softs[(k - 1) * rate.ncbps: k * rate.ncbps] = sm[perm]
        evm += float(np.mean(np.abs(E - _hard(E, rate.modulation)) ** 2))
    res.evm_db = float(10 * np.log10(evm / nsym + 1e-12))
    ab = depuncture(softs, rate.num, rate.den)
    bits = viterbi_decode(ab)
    # descramble: the first 7 SERVICE bits are zero pre-scrambling, so the
    # received bits[:7] are the raw scrambler output; invert the LFSR.
    seed = _seed_from_prefix(bits[:7])
    desc = bits ^ C.scrambler_sequence(len(bits), seed)
    psdu_bits = desc[16: 16 + 8 * length]
    psdu = np.packbits(psdu_bits, bitorder="little").tobytes()
    res.psdu = psdu
    res.fcs_ok = len(psdu) >= 4 and fcs32(psdu[:-4]) == int.from_bytes(
        psdu[-4:], "little")
    res.ok = res.fcs_ok
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    res._debug["scrambler_seed"] = seed
    return res


def _seed_from_prefix(prefix7: np.ndarray) -> int:
    """Recover the scrambler seed whose first 7 outputs equal prefix7.

    Output b_i becomes state x1 and future outputs depend linearly; running
    the LFSR backwards: the state before emitting b_0..b_6 is recovered by
    noting output = x7^x4 and the shift direction.  Simplest correct route:
    the 7 outputs are themselves the next 7 state bits, so reconstruct the
    initial state from them by reversing the recurrence.
    """
    # after 7 steps the state is [b6 b5 b4 b3 b2 b1 b0] (newest first).
    # Step the LFSR backwards 7 times: oldest bit x7_prev = out ^ x4_prev...
    x = list(prefix7[::-1].astype(int))   # x1..x7 = b6..b0
    for _ in range(7):
        # forward: fb = x7^x4 -> new state [fb, x1..x6]
        # backward: previous state = [x2..x7, x7_prev] with x7_prev = x1 ^ x4
        #   because fb(prev) = x7_prev ^ x4_prev = x1(cur); x4_prev = x5(cur)
        x7p = x[0] ^ x[4]
        x = x[1:] + [x7p]
    seed = 0
    for i in range(7):
        seed |= x[i] << i
    return seed


def _hard(sym: np.ndarray, modulation: str) -> np.ndarray:
    lv = {"bpsk": C._BPSK_LVL, "qpsk": C._QPSK_LVL,
          "qam16": np.sort(C._QAM16_LVL), "qam64": np.sort(C._QAM64_LVL)}
    if modulation == "bpsk":
        return np.sign(np.real(sym)) + 0j
    levels = lv[modulation]
    def q(v):
        return levels[np.argmin(np.abs(v[:, None] - levels[None, :]), axis=1)]
    return q(np.real(sym)) + 1j * q(np.imag(sym))
