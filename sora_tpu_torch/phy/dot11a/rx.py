"""802.11a OFDM receiver — torch, batched (port of
``sora_tpu.phy.dot11a.rx``: the fixed-rate and the mixed-rate,
multi-frame paths).

The reference RX brick graph (kernel/bb/demod11/fb11ademod_config.hpp:
148-218) becomes a batched tensor program over a leading axis of
frame-bearing sample streams:

* TCCA11a's per-sample carrier sense (cca.hpp:106-441) becomes vectorized
  detection: correlation scores for every offset at once, then argmax;
* TFreqCompensation -> TFFT64 -> TChannelEqualization -> TPilotTrack
  (channel_11a.hpp, pilot.hpp) is one batched pass over all OFDM symbols
  of the frame, the FFT an fp32 DFT matmul;
* the SIGNAL decode is exact maximum likelihood over the 32768 valid
  SIGNAL codewords (one matmul + argmax);
* T11aViterbi (viterbicore.h) becomes the block-parallel radix-4 decoder,
  a hand-written CUDA kernel on the card (``ops.viterbi_cuda``).

Every function computes on its input tensor's device; :func:`demodulate`,
which takes host samples, defaults to CUDA and raises without it.
``input_rate`` "40m" / "44m" runs the sample-rate front end
(``phy/frontend.py``) first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.dsp import crc as dcrc
from sora_tpu_torch.dsp import fft as dfft
from sora_tpu_torch.dsp import filters as df
from sora_tpu_torch.dsp import mapping as dmap
from sora_tpu_torch.dsp import scramble as dscr
from sora_tpu_torch.dsp import viterbi as dvit
from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy import frontend as fe
from sora_tpu_torch.util.xfer import device_complex

_LTS_SYM = np.asarray(C.LTS_TIME_SYM, dtype=np.complex64)
_LTS_SIGN = np.zeros(64, dtype=np.float32)
_LTS_SIGN[C.OCC_BINS] = C.LTS_FREQ

MAX_PSDU = 2500           # bytes; reference MTU parity (PHY_11a.hpp:571)

# STS autocorrelation plateau quality below which the air is considered
# idle — the vectorized analogue of TCCA11a's no-energy early exit
# (cca.hpp:165-230, E_ERROR_CS_TIMEOUT).
CS_DET_THRESHOLD = 0.6

# SIGNAL deinterleave (BPSK, 48 coded bits)
_SIG_PERM = C.interleaver_permutation(48, 1)

# hard-decision disagreement bound for accepting the ML SIGNAL winner: a
# genuine frame flips <= 2-3 of the 48 coded bits at any SNR where its
# payload can decode; noise sits >= 8 flips from the closest codeword.
_SIG_MAX_DIST = 6


def max_symbols(rate: C.RateParam, max_psdu: int = MAX_PSDU) -> int:
    return -(-(16 + 8 * max_psdu + 6) // rate.ndbps)


@lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The receiver's constant tables as tensors on ``device``."""
    t = lambda a, **kw: torch.as_tensor(np.asarray(a, **kw), device=device)
    tmpl, rb = _signal_ml_tables()
    return {
        "lts_sign": t(_LTS_SIGN),
        "pilot_bins": t(C.PILOT_BINS, dtype=np.int64),
        "pilot_val": t(C.PILOT_VAL, dtype=np.float32),
        "pilot_pol": t(C.PILOT_POLARITY, dtype=np.float32),
        "pilot_sc": t(C.PILOT_SC, dtype=np.float32),
        "kbin": t(((np.arange(64) + 32) % 64 - 32), dtype=np.float32),
        "data_bins": t(C.DATA_BINS, dtype=np.int64),
        "sig_perm": t(_SIG_PERM, dtype=np.int64),
        "sig_tmpl_t": t(np.ascontiguousarray(tmpl.T)),
        "sig_rate_bits": t(rb),
        "sig_code": t((tmpl > 0).astype(np.uint8)),
        "phases": t(dscr._PHASES_TABLE),
    }


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none) — JAX's
    argmax on a bool array."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _rotate(phase: torch.Tensor) -> torch.Tensor:
    """exp(-1j * phase) for a float32 phase tensor (complex64)."""
    return torch.exp(-1j * phase)


# =============================================================================
# Synchronization (vectorized TCCA11a + T11aLTS front half)
# =============================================================================


def _sts_metric(x: torch.Tensor):
    """The STS plateau metric of every offset: (w, en, m) — the lag-16
    autocorrelation moving sum (complex), the 64-sample moving energy and
    the energy-gated normalized metric m = |w| / en."""
    ac = x[:, 16:] * torch.conj(x[:, :-16])
    w = df.moving_sum(ac, 64)
    en = df.moving_sum(torch.abs(x[:, :-16]) ** 2, 64).float()
    # energy gate (the vectorized cca_pwr_threshold, cca.hpp:165-230)
    gate = en > 0.05 * en.max(dim=-1, keepdim=True).values
    m = torch.where(gate, torch.abs(w) / (en + 1e-9), 0.0)
    return w, en, m


def synchronize(x: torch.Tensor):
    """Packet detect + timing + coarse CFO for a batch of streams.

    x: (B, N) complex64.  Returns (lts1, coarse_cfo, detect_metric):
    lts1 (B,) int32 start of the first LTS repeat, coarse_cfo (B,) float32
    rad/sample, detect_metric (B,) float32 in [0, 1] (STS autocorrelation
    plateau quality — the CCA decision statistic).
    """
    c2, cfo, det = lts_metric(x)
    lts1 = torch.argmax(c2, dim=-1).to(torch.int32)
    return lts1, cfo, det


def lts_metric(x: torch.Tensor):
    """The LTS metric that :func:`synchronize` takes the argmax of: (B, L)
    float32, zero outside each stream's window [sts, sts + 512); with the
    coarse CFO and the detect metric."""
    B, N = x.shape
    w, _, m = _sts_metric(x)
    # restrict the STS search so a full preamble+SIGNAL still fits
    valid = m[:, : max(1, N - 480)]
    # first-plateau selection: lock to the EARLIEST preamble whose plateau
    # reaches 90% of the window max (the reference's CCA fires on the first)
    mx = valid.max(dim=-1, keepdim=True).values
    sts = _first_true(valid >= 0.9 * mx)
    det = valid.gather(1, sts[:, None])[:, 0]
    wsel = w.gather(1, sts[:, None])[:, 0]
    cfo = torch.angle(wsel).float() / 16.0
    # de-rotate and LTS cross-correlate
    n = torch.arange(N, dtype=torch.float32, device=x.device)
    y = x * _rotate(cfo[:, None] * n)
    c = torch.abs(df.correlate_stream(y, _LTS_SYM))
    c2 = c[:, :-64] + c[:, 64:]
    # only accept the LTS of THIS frame: within [sts, sts + 512)
    pos = torch.arange(c2.shape[-1], device=x.device)[None, :]
    in_range = (pos >= sts[:, None]) & (pos < sts[:, None] + 512)
    return torch.where(in_range, c2, 0.0), cfo, det


def _prior_hits(hit: torch.Tensor, span: int) -> torch.Tensor:
    """Number of hits in [t - span, t - 1] for every t: the difference of
    the hit cumsum padded in front by 1 and by span + 1."""
    cs = torch.cumsum(hit.to(torch.int32), dim=-1)
    n = cs.shape[-1]
    pad = lambda k: torch.cat([cs.new_zeros(cs.shape[0], k), cs],
                              dim=-1)[:, :n]
    return pad(1) - pad(span + 1)


def synchronize_multi(x: torch.Tensor, n_frames: int,
                      det_threshold: float = CS_DET_THRESHOLD):
    """Packet detect for up to ``n_frames`` frames per stream — the
    re-arming RX loop of the reference (MAC11a_Receive decodes frame after
    frame from one stream, mac.cpp:190-280) recast as batched top-K
    detection: every preamble onset in the window becomes an independent
    decode candidate.

    Onsets are rising edges of the STS plateau metric over an absolute
    threshold ``det_threshold``, with edges within 240 samples of a prior
    hit suppressed (a plateau is ~100 samples of jittery highs; two real
    preambles are >= 320 samples apart).

    x: (B, N) complex64.  Returns (lts1, cfo, det), each (B*n_frames,)
    candidate-major within stream (row b*n_frames + k = k-th onset of
    stream b); missing candidates have det = 0.
    """
    B, N = x.shape
    K = n_frames
    w, _, m = _sts_metric(x)
    valid = m[:, : max(1, N - 480)]
    hit = valid >= det_threshold
    edge = hit & (_prior_hits(hit, 240) == 0)
    eidx = torch.cumsum(edge.to(torch.int32), dim=-1)
    total = eidx[:, -1]                                   # (B,)
    ks = torch.arange(1, K + 1, device=x.device, dtype=torch.int32)
    sts = _first_true(eidx[:, None, :] == ks[None, :, None])    # (B, K)
    have = total[:, None] >= ks[None, :]
    det = torch.where(have, valid.gather(1, sts), 0.0)
    cfo = torch.angle(w.gather(1, sts)).float() / 16.0    # (B, K)
    # per-candidate LTS lock on a sliced 768-sample segment: the LTS
    # repeat of candidate k lies within [sts_k, sts_k + 512)
    seg = 768
    stsf = sts.reshape(B * K)
    cfof = cfo.reshape(B * K)
    xpad = torch.cat([x, x.new_zeros(B, seg)], dim=1)
    # a slice start is clamped into the padded row, as lax.dynamic_slice does
    idx = (sts.clamp(0, N)[:, :, None]
           + torch.arange(seg, device=x.device)).reshape(B, K * seg)
    segs = xpad.gather(1, idx).reshape(B * K, seg)
    y = segs * _rotate(cfof[:, None]
                       * torch.arange(seg, dtype=torch.float32,
                                      device=x.device))
    c = torch.abs(df.correlate_stream(y, _LTS_SYM))
    c2 = (c[:, :-64] + c[:, 64:])[:, :512]
    lts1 = (stsf + torch.argmax(c2, dim=-1)).to(torch.int32)
    return lts1, cfof, det.reshape(B * K)


def detect_only(x: torch.Tensor):
    """Cheap carrier-sense pass: STS plateau metric + peak mean power per
    stream, without the LTS cross-correlation of :func:`synchronize` —
    the batched analogue of TCCA11a's no-energy early exit
    (cca.hpp:165-230).

    x: (B, N) complex64.  Returns (det (B,) float32, power (B,) float32):
    the metric's maximum and the peak 64-sample mean power (not the window
    mean, which on a sparsely occupied window underestimates the frame's
    amplitude by the occupancy factor).
    """
    _, en, m = _sts_metric(x)
    det = m[:, : max(1, x.shape[1] - 480)].max(dim=-1).values
    power = (en.max(dim=-1).values * (1.0 / 64.0)).float()
    return det, power


# =============================================================================
# Symbol extraction + equalization (LTS chanest, CFO comp, FFT, pilots)
# =============================================================================


def _pilot_slope(pv: torch.Tensor, window: int = 8) -> torch.Tensor:
    """Per-symbol subcarrier phase SLOPE (rad/subcarrier) from the
    polarity-corrected pilot values — the delta half of TPilotTrack's
    "subcarrier rotation = const_rotate + i * delta_rotate"
    (pilot.hpp:142-236).

    pv: (B, S, 4) pilots at subcarriers (-21, -7, 7, 21).  The per-pilot
    phases are unwrapped along the symbol axis, the slope is a
    least-squares fit over the 4 pilot positions, then a causal
    ``window``-symbol moving average smooths it (the SFO tracker's IIR).
    """
    theta = torch.angle(pv)                                 # (B, S, 4)
    d = theta[:, 1:] - theta[:, :-1]
    d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi   # floor-mod
    theta_u = torch.cumsum(torch.cat([theta[:, :1], d], dim=1), dim=1)
    ksc = _consts(pv.device)["pilot_sc"]
    slope = torch.sum(theta_u * ksc, dim=-1) / float(
        np.sum(C.PILOT_SC.astype(np.float64) ** 2))         # (B, S)
    S = slope.shape[1]
    w = min(window, S)
    cs = torch.cat([slope.new_zeros(slope.shape[0], 1),
                    torch.cumsum(slope, dim=1)], dim=1)
    # indices made on the device: a host index would copy (and sync) per call
    s_idx = torch.arange(S, device=pv.device)
    lo = torch.clamp(s_idx + 1 - w, min=0)
    tot = cs[:, s_idx + 1] - cs[:, lo]
    return tot / (s_idx + 1 - lo).to(torch.float32)


def extract_symbols(x: torch.Tensor, lts1: torch.Tensor, cfo: torch.Tensor,
                    nsym: int, return_weights: bool = False):
    """Equalized data carriers for SIGNAL + nsym data symbols.

    x: (B, N); lts1/cfo from :func:`synchronize`.  Returns
    (eq (B, nsym+1, 48) complex64, snr_db (B,) float32) and, with
    ``return_weights``, the (B, 48) per-subcarrier LLR confidence
    |H_k|^2 (unit-mean normalized).  Index 0 of axis 1 is the SIGNAL
    symbol.
    """
    B, N = x.shape
    k = _consts(x.device)
    need = 128 + 80 * (nsym + 1)
    xp = torch.cat([x, x.new_zeros(B, need)], dim=1)
    # a slice start is clamped into the padded row, as lax.dynamic_slice does
    start = lts1.to(torch.int64).clamp(0, N)
    idx = start[:, None] + torch.arange(need, device=x.device)[None, :]
    y = xp.gather(1, idx)                             # (B, need)
    # coarse CFO first, then fine CFO from the LTS repeats
    n_idx = torch.arange(need, dtype=torch.float32, device=x.device)
    y = y * _rotate(cfo[:, None] * n_idx)
    fine = torch.angle(torch.sum(torch.conj(y[:, :64]) * y[:, 64:128],
                                 dim=-1)).float() / 64.0
    y = y * _rotate(fine[:, None] * n_idx)
    # channel estimate from the two LTS repeats
    L = 0.5 * (dfft.fft64(y[:, :64]) + dfft.fft64(y[:, 64:128]))
    H = L * k["lts_sign"]                             # sign * |.| == /(±1)
    nvar = torch.mean(torch.abs(y[:, :64] - y[:, 64:128]) ** 2, dim=-1) / 2
    sig_p = torch.mean(torch.abs(H) ** 2, dim=-1) * (64.0 / 52.0)
    snr_db = 10.0 * torch.log10(sig_p / (nvar + 1e-12) + 1e-12)
    # symbols: skip the 16-sample CP of each
    sym = y[:, 128:].reshape(B, nsym + 1, 80)[:, :, 16:]
    S = dfft.fft64(sym)                               # (B, nsym+1, 64)
    Hc = torch.conj(H)[:, None, :]
    E = S * Hc / (torch.abs(H[:, None, :]) ** 2 + 1e-12)
    # pilot-driven common phase + slope (SFO) tracking per symbol — the
    # TPilotTrack const + i*delta subcarrier rotation (pilot.hpp:142-236)
    pol = k["pilot_pol"][torch.arange(nsym + 1, device=x.device) % 127]
    pv = E[:, :, k["pilot_bins"]] * (k["pilot_val"][None, None, :]
                                     * pol[None, :, None])
    slope = _pilot_slope(pv)
    # de-ramp BEFORE the common-phase sum (at large drift the raw pilot
    # sum crosses zero and its angle would flip by pi)
    pvc = pv * _rotate(slope[:, :, None] * k["pilot_sc"][None, None, :])
    ph = torch.angle(torch.sum(pvc, dim=-1))
    E = E * _rotate(ph[:, :, None]
                    + slope[:, :, None] * k["kbin"][None, None, :])
    eq = E[:, :, k["data_bins"]]
    # gain-normalize so demap soft scaling holds for any TX amplitude
    gain = torch.mean(torch.abs(eq[:, 0, :]), dim=-1) + 1e-12
    eq = eq / gain[:, None, None]
    if return_weights:
        # per-subcarrier LLR confidence: the ZF output's inverse noise
        # amplification is |H_k|^2, so crushed subcarriers contribute
        # near-erasures instead of full-confidence garbage
        wgt = torch.abs(H[:, k["data_bins"]]) ** 2
        wgt = wgt / (torch.mean(wgt, dim=-1, keepdim=True) + 1e-20)
        return eq, snr_db, wgt.float()
    return eq, snr_db


# =============================================================================
# SIGNAL decode
# =============================================================================


def _conv_encode_np(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 (133,171) encode, numpy, matching dsp.viterbi.encode:
    (M, T) -> (M, T, 2)."""
    M, T = bits.shape
    padded = np.pad(bits, ((0, 0), (6, 0)))
    outa = np.zeros_like(bits)
    outb = np.zeros_like(bits)
    for i in range(7):
        tap = padded[:, 6 - i: 6 - i + T]
        if (C.G0 >> (6 - i)) & 1:
            outa = outa ^ tap
        if (C.G1 >> (6 - i)) & 1:
            outb = outb ^ tap
    return np.stack([outa, outb], axis=-1)


@lru_cache(maxsize=None)
def _signal_ml_tables():
    """The complete valid-SIGNAL codebook: 8 rates x 4096 lengths =
    32768 messages, each conv-encoded to 48 coded bits.

    The SIGNAL symbol's whole information content is (rate, length) —
    reserved, parity and tail are determined — so its maximum-likelihood
    decode is a correlation against all 32768 codewords: one
    (B, 48) x (48, 32768) matmul + argmax, exact ML over the valid
    message set.

    Returns (templates (32768, 48) float32 +-1 in deinterleaved soft
    order, rate_bits (32768,) int32; message m = rate_index * 4096 +
    length with rate_index over sorted RATES)."""
    n_len = 4096
    rates = sorted(C.RATES)
    rb = np.array([C.RATES[m].rate_bits for m in rates], np.int32)
    Mn = len(rates) * n_len
    bits = np.zeros((Mn, 24), np.uint8)
    ridx = np.arange(Mn) // n_len
    length = np.arange(Mn) % n_len
    rbits = rb[ridx]
    for i in range(4):                       # b0..b3: rate, MSB first
        bits[:, i] = (rbits >> (3 - i)) & 1
    for i in range(12):                      # b5..b16: length, LSB first
        bits[:, 5 + i] = (length >> i) & 1
    bits[:, 17] = bits[:, :17].sum(axis=1) & 1     # even parity
    coded = _conv_encode_np(bits).reshape(Mn, 48)
    return ((2.0 * coded - 1.0).astype(np.float32),
            rbits.astype(np.int32))


def decode_signal(eq_sig: torch.Tensor):
    """(B, 48) equalized SIGNAL carriers -> (rate_bits int32, length int32,
    ok bool) by exact ML over the valid-SIGNAL codebook (an fp32 matmul;
    near-ties of the argmax can differ from another backend's sum
    order only where the SIGNAL is at the noise floor)."""
    k = _consts(eq_sig.device)
    soft = dmap.demap_soft(eq_sig, "bpsk")            # (B, 48)
    de = soft[:, k["sig_perm"]]
    score = de @ k["sig_tmpl_t"]                      # (B, 32768)
    m = torch.argmax(score, dim=-1)                   # first maximum
    rate_bits = k["sig_rate_bits"][m]
    length = (m % 4096).to(torch.int32)
    hard = (de > 0).to(torch.uint8)
    dist = torch.sum(hard ^ k["sig_code"][m], dim=-1)
    ok = (dist <= _SIG_MAX_DIST) & (length > 0)
    return rate_bits, length, ok


def decode_signal_viterbi(eq_sig: torch.Tensor):
    """The sequential-trellis SIGNAL decode (kept as the cross-check for
    the ML codebook path; same contract).  Runs the radix-4 decoder over
    one 24-step window."""
    soft = dmap.demap_soft(eq_sig, "bpsk")            # (B, 48)
    de = soft[:, _consts(eq_sig.device)["sig_perm"]]
    b = dvit.decode_auto(de.reshape(-1, 24, 2), terminated=True,
                         blockwise=False).to(torch.int32)
    rate_bits = (b[:, 0] << 3) | (b[:, 1] << 2) | (b[:, 2] << 1) | b[:, 3]
    parity_ok = (torch.sum(b[:, :17], dim=-1) & 1) == b[:, 17]
    shifts = torch.arange(12, device=b.device, dtype=torch.int32)
    length = torch.sum(b[:, 5:17] << shifts[None, :], dim=-1).to(torch.int32)
    tail_ok = torch.sum(b[:, 18:24], dim=-1) == 0
    valid = torch.tensor([r.rate_bits for r in C.RATES.values()],
                         dtype=torch.int32, device=b.device)
    known = torch.isin(rate_bits, valid)
    ok = parity_ok & tail_ok & known & (length > 0)
    return rate_bits, length, ok


# =============================================================================
# DATA decode (per-rate, shape-static)
# =============================================================================

_RATE_LIST = sorted(C.RATES)                       # mbps, idx 0..7
_MOD_ORDER = ("bpsk", "qpsk", "qam16", "qam64")
_MOD_NBPSC = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}
_MOD_OFF = {"bpsk": 0, "qpsk": 48, "qam16": 144, "qam64": 336}
_MOD_W = 624                                       # 48+96+192+288

# SIGNAL rate_bits (4 bits) -> rate index, 0 for invalid patterns
_BITS_TO_IDX = np.zeros(16, np.int32)
for _i, _m in enumerate(_RATE_LIST):
    _BITS_TO_IDX[C.RATES[_m].rate_bits] = _i


@lru_cache(maxsize=None)
def _auto_tables(max_psdu: int, nsym_cap: int = 1 << 30):
    """Static per-rate one-hot deinterleave+depuncture matrices: symbol
    boundaries align with puncture-period boundaries for every rate, so
    deinterleave + depuncture + modulation select is the SAME (624 ->
    2*ndbps) linear map for every symbol; punctured slots are all-zero
    columns (erasures).  ``nsym_cap`` bounds the per-rate symbol count.

    Returns (mats tuple of (624, 2*ndbps_r) float32; nsym (8,) int per-rate
    symbol counts; ndbps (8,) int32; nsym_max int; T_max int)."""
    nsyms = tuple(min(max_symbols(C.RATES[m], max_psdu), nsym_cap)
                  for m in _RATE_LIST)
    nsym_max = max(nsyms)
    t_max = max(n * C.RATES[m].ndbps for n, m in zip(nsyms, _RATE_LIST))
    mats = []
    for m in _RATE_LIST:
        rate = C.RATES[m]
        perm = C.interleaver_permutation(rate.ncbps, rate.nbpsc)
        pa, pb = C.PUNCTURE[(rate.num, rate.den)]
        keep = np.stack([pa, pb], -1).reshape(-1)          # period (2p,)
        keepf = np.tile(keep, -(-2 * rate.ndbps // len(keep)))
        keepf = keepf[: 2 * rate.ndbps]
        # transmitted (A,B) slot j of one symbol holds punctured-stream
        # position q = rank of j among kept slots; it reads the demapped
        # soft value at interleaved position perm[q] of its modulation
        tx_slots = np.flatnonzero(keepf)                   # (ncbps,)
        P = np.zeros((_MOD_W, 2 * rate.ndbps), np.float32)
        P[_MOD_OFF[rate.modulation] + perm[np.arange(rate.ncbps)],
          tx_slots] = 1.0
        mats.append(P)
    return (tuple(mats), nsyms,
            np.array([C.RATES[m].ndbps for m in _RATE_LIST], np.int32),
            nsym_max, t_max)


@lru_cache(maxsize=None)
def _rate_symbol_matrix(rate_mbps: int) -> np.ndarray:
    """(ncbps, 2*ndbps) per-symbol deinterleave+depuncture one-hot: the
    fixed-rate slice of the _auto_tables construction."""
    rate = C.RATES[rate_mbps]
    mats, _, _, _, _ = _auto_tables(1 << 20, 1 << 20)
    off = _MOD_OFF[rate.modulation]
    return np.asarray(mats[_RATE_LIST.index(rate_mbps)][off: off + rate.ncbps])


@lru_cache(maxsize=None)
def _rate_gather(rate_mbps: int, device: torch.device):
    """The one-hot matrix as a gather: for each (A, B) slot of a symbol,
    the demapped soft position it reads and whether it was transmitted.
    Selecting through the index reproduces the one-hot product exactly."""
    P = _rate_symbol_matrix(rate_mbps)
    return (torch.as_tensor(P.argmax(axis=0), device=device),
            torch.as_tensor(P.sum(axis=0) > 0, device=device))


def data_soft(eq: torch.Tensor, length: torch.Tensor, rate_mbps: int,
              weights: torch.Tensor = None) -> torch.Tensor:
    """Demapped, weighted, length-masked, deinterleaved and depunctured
    soft pairs of the data symbols: the Viterbi input of
    :func:`decode_data`, (B, nsym_max * ndbps, 2) float32."""
    rate = C.RATES[rate_mbps]
    B, nsym_max, _ = eq.shape
    soft = dmap.demap_soft(eq, rate.modulation)       # (B, nsym, ncbps)
    if weights is not None:
        soft = soft * torch.repeat_interleave(
            weights, rate.nbpsc, dim=-1)[:, None, :]
    # mask symbols beyond each frame's actual extent -> erasures
    nbits = 16 + 8 * length.to(torch.int64) + 6
    nsym_actual = -(-nbits // rate.ndbps)
    symi = torch.arange(nsym_max, device=eq.device)[None, :, None]
    soft = torch.where(symi < nsym_actual[:, None, None], soft, 0.0)
    src, sent = _rate_gather(rate_mbps, eq.device)
    ab = torch.where(sent, soft[..., src], 0.0)       # (B, nsym, 2*ndbps)
    return ab.reshape(B, nsym_max * rate.ndbps, 2)


def decode_data(eq: torch.Tensor, length: torch.Tensor, rate_mbps: int,
                weights: torch.Tensor = None):
    """Decode data symbols for one rate.

    eq: (B, nsym_max, 48) equalized data carriers (SIGNAL already removed);
    length: (B,) PSDU byte counts from SIGNAL; weights: optional (B, 48)
    per-subcarrier LLR confidence from extract_symbols(return_weights=True).
    Returns (psdu (B, MAX_PSDU) uint8, fcs_ok (B,) bool, nbits_used (B,)).
    """
    rate = C.RATES[rate_mbps]
    t_steps = eq.shape[1] * rate.ndbps
    ab = data_soft(eq, length, rate_mbps, weights)
    bits = dvit.decode_auto(ab, terminated=True)
    psdu, fcs_ok = _finish_frame(bits, length, t_steps)
    nbits = 16 + 8 * length.to(torch.int32) + 6
    return psdu, fcs_ok, nbits


def _finish_frame(bits: torch.Tensor, length: torch.Tensor, t_steps: int,
                  max_psdu: int = MAX_PSDU):
    """Shared frame tail (of the 11a and 11n receivers): descramble (seed
    phase from the first 7 bits), pack PSDU bytes LSB-first, check the FCS
    on device.

    bits: (B, t_steps) decoded data bits; length: (B,) PSDU byte counts.
    Returns (psdu (B, max_psdu) uint8, fcs_ok (B,) bool)."""
    B = bits.shape[0]
    phases = _consts(bits.device)["phases"]            # (127, 127) uint8
    bits = bits.to(torch.uint8)
    match = torch.all(phases[None, :, :7] == bits[:, None, :7], dim=-1)
    seq = phases[_first_true(match)]                   # (B, 127)
    reps = -(-t_steps // 127)
    seq = seq.repeat(1, reps)[:, :t_steps]             # jnp.tile
    desc = bits ^ seq
    # PSDU bytes, LSB-first
    nbytes_max = (t_steps - 22) // 8
    payload = desc[:, 16: 16 + 8 * nbytes_max].reshape(B, nbytes_max, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    psdu = torch.sum(payload.to(torch.int32) * weights, dim=-1).to(
        torch.uint8)
    if nbytes_max < max_psdu:
        psdu = torch.cat([psdu, psdu.new_zeros(B, max_psdu - nbytes_max)],
                         dim=1)
    psdu = psdu[:, :max_psdu]
    # FCS check on device (int64 registers: no uint32 arithmetic in torch)
    length = length.to(torch.int64)
    body_crc = dcrc.crc32_batch(psdu, length - 4)
    idx = (length[:, None] - 4 + torch.arange(4, device=bits.device)[None, :]
           ).clamp(0, max_psdu - 1)
    fb = psdu.gather(1, idx).to(torch.int64)
    rx_fcs = fb[:, 0] | (fb[:, 1] << 8) | (fb[:, 2] << 16) | (fb[:, 3] << 24)
    fcs_ok = (body_crc == rx_fcs) & (length >= 4) & (length <= max_psdu)
    return psdu, fcs_ok


# =============================================================================
# Mixed-rate batched decode (runtime rate dispatch)
# =============================================================================
#
# The reference demuxes per frame at runtime through TBB11aRxRateSel
# (PHY_11a.hpp:704-814).  Here, as in the JAX package, one program serves
# all rates: every symbol is demapped under all four modulations (624
# soft values per symbol), and deinterleave + depuncture + modulation
# select is one gather per row through its rate's index table.  The JAX
# package applies the same tables as eight one-hot matmuls; each output
# is one soft value or an erasure either way, so the two are equal.  The
# trellis length nsym(rate) * ndbps(rate) is within one symbol of the
# payload bit count for every rate, so one Viterbi call (padded with
# erasures) decodes the whole mixed batch.


@lru_cache(maxsize=None)
def _auto_gather(max_psdu: int, nsym_cap: int, device: torch.device) -> dict:
    """The :func:`_auto_tables` matrices as gather tables on ``device``:
    for rate index r and output slot q of the flattened (t_max, 2)
    trellis input, ``src[r, q]`` = s * 624 + column of the soft value it
    reads (symbol s of the 624-wide demap) and ``sent[r, q]`` whether it
    was transmitted (False: an erasure, as are slots past the rate's
    nsym * ndbps steps)."""
    mats, nsyms, ndbps, _, t_max = _auto_tables(max_psdu, nsym_cap)
    src = np.zeros((len(mats), 2 * t_max), np.int64)
    sent = np.zeros((len(mats), 2 * t_max), bool)
    for ri, P in enumerate(mats):
        width = P.shape[1]                           # 2 * ndbps
        q = np.arange(nsyms[ri] * width)
        src[ri, : q.size] = (q // width) * _MOD_W + P.argmax(axis=0)[q % width]
        sent[ri, : q.size] = P.sum(axis=0)[q % width] > 0
    # weights column of each of the 624 demapped values: jnp.repeat of the
    # 48 subcarrier weights by nbpsc, per modulation
    wcol = np.concatenate([np.repeat(np.arange(48), _MOD_NBPSC[m])
                           for m in _MOD_ORDER])
    known = np.zeros(16, bool)
    known[[r.rate_bits for r in C.RATES.values()]] = True
    t = lambda a: torch.as_tensor(a, device=device)
    return {"src": t(src), "sent": t(sent), "wcol": t(wcol),
            "ndbps": t(ndbps), "t_max": t_max,
            "mbps": t(np.array(_RATE_LIST, np.int32)),
            "bits_to_idx": t(_BITS_TO_IDX.astype(np.int64)),
            "known": t(known)}


def _nsym_actual(length: torch.Tensor, ndbps: torch.Tensor) -> torch.Tensor:
    nbits = 16 + 8 * length + 6
    return (nbits + ndbps - 1) // ndbps


def auto_soft(data: torch.Tensor, length: torch.Tensor,
              rate_idx: torch.Tensor, max_psdu: int, nsym_cap: int,
              weights: torch.Tensor = None) -> torch.Tensor:
    """The mixed-rate Viterbi input: demap every data symbol under all
    four modulations, weight, erase symbols past each frame's extent,
    then deinterleave/depuncture/select through each row's rate table.

    data: (B, nsym, 48) equalized data carriers (SIGNAL removed, nsym at
    least the table's largest per-rate symbol count); length: (B,) int32
    PSDU bytes; rate_idx: (B,) int64 index into the sorted rates;
    weights: optional (B, 48).  Returns (B, t_max, 2) float32.
    """
    k = _auto_gather(max_psdu, nsym_cap, data.device)
    B, nsym, _ = data.shape
    soft_cat = torch.cat([dmap.demap_soft(data, m) for m in _MOD_ORDER],
                         dim=-1)                     # (B, nsym, 624)
    if weights is not None:
        soft_cat = soft_cat * weights[:, k["wcol"]][:, None, :]
    nsym_actual = _nsym_actual(length, k["ndbps"][rate_idx])
    symi = torch.arange(nsym, device=data.device)[None, :, None]
    soft_cat = torch.where(symi < nsym_actual[:, None, None], soft_cat, 0.0)
    ab = soft_cat.reshape(B, nsym * _MOD_W).gather(1, k["src"][rate_idx])
    ab = torch.where(k["sent"][rate_idx], ab, 0.0)
    return ab.reshape(B, k["t_max"], 2)


def auto_tail(eq: torch.Tensor, det: torch.Tensor, max_psdu: int,
              nsym_cap: int, det_threshold: float = CS_DET_THRESHOLD,
              lts1: torch.Tensor = None, n_samples: int = 0,
              weights: torch.Tensor = None) -> dict:
    """SIGNAL parse + mixed-rate data decode from equalized carriers — the
    back half of :func:`rx_pipeline_auto`.

    eq: (B, nsym_max+1, 48) equalized carriers (row 0 = SIGNAL); det:
    (B,) carrier-sense metric.  With ``lts1`` and ``n_samples`` the dict
    also holds ``truncated``: the frame runs past the window's end (it
    decodes from the next overlapping window).
    """
    k = _auto_gather(max_psdu, nsym_cap, eq.device)
    rate_bits, length, sig_ok = decode_signal(eq[:, 0, :])
    length = torch.clamp(length, 0, max_psdu).to(torch.int32)
    # the ML SIGNAL decode returns 4-bit rate patterns, so the 16-entry
    # tables below are the JAX package's clip + lookup and isin
    rb = rate_bits.to(torch.int64).clamp(0, 15)
    rate_idx = k["bits_to_idx"][rb]
    ab = auto_soft(eq[:, 1:, :], length, rate_idx, max_psdu, nsym_cap,
                   weights)
    bits = dvit.decode_auto(ab, terminated=True)
    psdu, fcs_ok = _finish_frame(bits, length, k["t_max"])
    cs_ok = det >= det_threshold
    ok = cs_ok & sig_ok & k["known"][rb] & fcs_ok
    u8 = lambda v: v.to(torch.uint8)
    out = {"psdu": psdu, "fcs_ok": u8(fcs_ok), "sig_ok": u8(sig_ok),
           "ok": u8(ok), "cs_ok": u8(cs_ok), "det": det,
           "rate_mbps": k["mbps"][rate_idx], "length": length}
    if lts1 is not None and n_samples > 0:
        nsym_actual = _nsym_actual(length, k["ndbps"][rate_idx])
        out["truncated"] = u8(lts1 + 128 + 80 * (nsym_actual + 1)
                              > n_samples)
    return out


def rx_pipeline_auto(x: torch.Tensor, max_psdu: int = MAX_PSDU,
                     input_rate: str = "20m", n_frames: int = 1,
                     n_decode: int = 0,
                     det_threshold: float = CS_DET_THRESHOLD,
                     min_rate_mbps: int = 6) -> dict:
    """Complete batched RX with per-frame runtime rate dispatch: a batch
    mixing all eight 802.11a rates decodes in one pass, with one Viterbi
    launch.

    With ``n_frames > 1`` every stream yields up to that many decode
    candidates (one per detected preamble onset — the re-arming RX loop
    of mac.cpp:190-280), and the output rows number B*n_frames,
    candidate-major within stream.  ``n_decode`` (with ``n_frames > 1``)
    keeps only the ``n_decode`` highest-det candidates of the whole batch
    for the expensive tail; the rows then carry ``src`` (the candidate row
    b*n_frames + k each came from).  With ``n_frames > 1`` the dict holds
    ``n_cand``, the int32 count of candidates at or over the threshold
    before compaction.  ``min_rate_mbps`` is the slowest rate expected on
    the air: the per-rate symbol tables are capped at that rate's
    ``max_psdu`` airtime (slower, longer frames truncate).

    x: (B, N) complex64 streams (raw 40 or 44 Msps with ``input_rate``
    "40m" or "44m").  Returns the :func:`rx_pipeline` dict plus rate_mbps
    int32 per row.  Makes no host sync.
    """
    x = fe.ofdm_frontend(x, input_rate)
    # static window capacity bound: extract_symbols needs lts1 + 128 +
    # 80*(nsym+1) <= N, taken at the earliest anchor lts1 = 0
    nsym_win = max(1, (int(x.shape[1]) - 208) // 80)
    mr = max([r for r in _RATE_LIST if r <= min_rate_mbps] or [6])
    nsym_cap = min(nsym_win, max_symbols(C.RATES[mr], max_psdu))
    nsym_max = _auto_tables(max_psdu, nsym_cap)[3]
    src = None
    n_cand = None
    if n_frames > 1:
        B = x.shape[0]
        lts1, cfo, det = synchronize_multi(x, n_frames, det_threshold)
        n_cand = (det >= det_threshold).sum().to(torch.int32)
        if 0 < n_decode < B * n_frames:
            det, idx = torch.topk(det, n_decode)
            src = idx.to(torch.int32)
            lts1 = lts1[idx]
            cfo = cfo[idx]
            x = x[idx // n_frames]
        else:
            rows = torch.arange(B * n_frames, device=x.device) // n_frames
            x = x[rows]
    else:
        lts1, cfo, det = synchronize(x)
    eq, snr_db, wgt = extract_symbols(x, lts1, cfo, nsym_max,
                                      return_weights=True)
    out = auto_tail(eq, det, max_psdu, nsym_cap, det_threshold, lts1=lts1,
                    n_samples=int(x.shape[1]), weights=wgt)
    out.update({"snr_db": snr_db, "lts1": lts1, "cfo": cfo})
    if src is not None:
        out["src"] = src
    if n_cand is not None:
        out["n_cand"] = n_cand
    return out


# =============================================================================
# Whole-chain pipeline (the unit a receiver batch runs through)
# =============================================================================


def rx_pipeline(x: torch.Tensor, rate_mbps: int, max_psdu: int = MAX_PSDU,
                input_rate: str = "20m"):
    """Complete batched RX for a known rate: sync -> chanest/equalize ->
    SIGNAL -> data decode -> FCS.

    x: (B, N) complex64 streams, one frame each, on the device the chain
    should run on: 20 Msps, or raw 40 / 44 Msps radio-rate samples with
    ``input_rate="40m"`` / ``"44m"`` (the front end, DC removal and
    decimation, runs first — the reference graph starts at TDownSample2
    -> TDCRemoveEx, fb11ademod_config.hpp:148-218).  Returns a dict with
    psdu (B, MAX_PSDU) uint8, fcs_ok/sig_ok/ok/cs_ok/truncated (B,) uint8,
    length (B,) int32, det/snr_db/cfo (B,) float32 and lts1 (B,) int32 —
    the analogue of the reference's MAC11a_Receive poll loop body
    (mac.cpp:190-280).
    """
    x = fe.ofdm_frontend(x, input_rate)
    rate = C.RATES[rate_mbps]
    # cap the trellis at what the window can physically hold (the
    # lts1 = 0 upper bound (N - 208) // 80): longer frames cannot decode
    # from this window anyway
    N = int(x.shape[1])
    nsym_win = max(1, (N - 208) // 80)
    nsym = min(max_symbols(rate, max_psdu), nsym_win)
    lts1, cfo, det = synchronize(x)
    eq, snr_db, wgt = extract_symbols(x, lts1, cfo, nsym,
                                      return_weights=True)
    rate_bits, length, sig_ok = decode_signal(eq[:, 0, :])
    length = torch.clamp(length, 0, max_psdu).to(torch.int32)
    psdu, fcs_ok, nbits = decode_data(eq[:, 1:, :], length, rate_mbps, wgt)
    cs_ok = det > CS_DET_THRESHOLD
    ok = cs_ok & sig_ok & (rate_bits == rate.rate_bits) & fcs_ok
    nsym_actual = (nbits + rate.ndbps - 1) // rate.ndbps
    truncated = (lts1 + 128 + 80 * (nsym_actual + 1)) > N
    u8 = lambda v: v.to(torch.uint8)
    return {"psdu": psdu, "fcs_ok": u8(fcs_ok), "sig_ok": u8(sig_ok),
            "ok": u8(ok), "cs_ok": u8(cs_ok), "det": det,
            "truncated": u8(truncated), "length": length,
            "snr_db": snr_db, "lts1": lts1, "cfo": cfo}


# =============================================================================
# Host-facing API
# =============================================================================


@dataclass
class RxResult:
    ok: bool = False
    reason: str = "no_frame"
    rate_mbps: int = 0
    length: int = 0
    psdu: bytes = b""
    fcs_ok: bool = False
    start: int = -1
    cfo: float = 0.0
    snr_est_db: float = 0.0
    _debug: dict = field(default_factory=dict)


def demodulate(x, expect_rate: int | None = None, input_rate: str = "20m",
               device=None) -> RxResult:
    """Single-stream convenience wrapper (API-compatible with the golden
    model): host samples in, an :class:`RxResult` out.  Runs on ``device``
    (default cuda; raises without CUDA unless ``device="cpu"``).
    ``input_rate="40m"`` / ``"44m"`` takes raw radio-rate samples (e.g.
    the untouched ``load_dump`` payload) and runs the front end first."""
    xb = device_complex(np.asarray(x, dtype=np.complex64)[None, :], device)
    xb = fe.ofdm_frontend(xb, input_rate)
    res = RxResult()
    lts1, cfo, det = synchronize(xb)
    res.start = int(lts1[0])
    res.cfo = float(cfo[0])
    if float(det[0]) < CS_DET_THRESHOLD:
        res.reason = "cs_timeout"       # E_ERROR_CS_TIMEOUT analogue
        return res
    # SIGNAL first (cheap, fixed shape)
    eq1, snr = extract_symbols(xb, lts1, cfo, 0)
    res.snr_est_db = float(snr[0])
    rate_bits, length, sig_ok = decode_signal(eq1[:, 0, :])
    if not bool(sig_ok[0]):
        res.reason = "plcp_header_fail"
        return res
    rate = C.RATE_BY_BITS[int(rate_bits[0])]
    res.rate_mbps = rate.mbps
    res.length = int(length[0])
    if expect_rate is not None and rate.mbps != expect_rate:
        res.reason = "unexpected_rate"
        return res
    if res.length > MAX_PSDU:
        res.reason = "oversize"
        return res
    nsym_actual = -(-(16 + 8 * res.length + 6) // rate.ndbps)
    if xb.shape[1] < res.start + 128 + 80 * (nsym_actual + 1):
        res.reason = "truncated"
        return res
    # decode at the smallest power-of-two symbol count covering this
    # frame (the JAX package's shape buckets; kept so both decode the
    # same trellis length and so make the same window choices)
    nsym = 32
    while nsym < nsym_actual:
        nsym *= 2
    nsym = min(nsym, max_symbols(rate))
    eq, _, wgt = extract_symbols(xb, lts1, cfo, nsym, return_weights=True)
    psdu, fcs_ok, _ = decode_data(eq[:, 1:, :], length, rate.mbps, wgt)
    res.psdu = bytes(psdu[0, : res.length].cpu().numpy())
    res.fcs_ok = bool(fcs_ok[0])
    res.ok = res.fcs_ok
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    return res
