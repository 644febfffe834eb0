"""802.11n HT receiver — torch, batched (port of ``sora_tpu.phy.dot11n.rx``:
the 2x2 MIMO chain for MCS 8-15, the single-stream chain for MCS 0-7,
short GI, and the mixed-MCS pipelines).

The reference 11n RX brick graph (kernel/bb/demod11/fb11ndemod_config.hpp:
142-206) as one batched tensor program per call:

* TCCA11n's antenna-summed carrier sense (cca_11n.hpp:7) is vectorized
  detection over all offsets at once, as in the 11a chain;
* TMimoChannelEst (channel_11n.hpp:331-445), the per-subcarrier 2x2 H from
  the P-mapped HT-LTFs, and its inversion (CSoraMatrix::inverse_scale,
  sora_matrix.h:53-444) are closed-form elementwise 2x2 algebra in
  complex64 over (frame, subcarrier) — MMSE detection with LLR weights,
  or plain ZF with ``mmse=False``;
* TMrcCombine (PHY_11n.hpp:364) for the legacy-coded L-SIG / HT-SIG is a
  conj(H)-weighted sum over the two antennas;
* the stream parser and the per-stream deinterleave / depuncture
  (T11nDeinterleave*_S0/_S1, streamparser.hpp:7-139) are one gather per
  row through a static index table: where the JAX package multiplies by
  one-hot matrices, every trellis slot here reads its one source soft
  value or an erasure (0.0), which is the same number;
* the HT-SIG and data Viterbi decodes are ``dsp.viterbi.decode_auto``: the
  hand-written Hopper kernel on the card (two launches per pipeline call,
  HT-SIG and data).

Batch convention: x is (B, 2, N) — B frames, 2 RX antennas each.  Every
function computes on its input tensor's device; :func:`demodulate`, which
takes host samples, defaults to CUDA and raises without it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.dsp import fft as dfft
from sora_tpu_torch.dsp import filters as df
from sora_tpu_torch.dsp import mapping as dmap
from sora_tpu_torch.dsp import viterbi as dvit
from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy import dot11n_common as N
from sora_tpu_torch.phy.dot11a import rx as arx
from sora_tpu_torch.phy.dot11a.rx import (CS_DET_THRESHOLD, MAX_PSDU,
                                          _finish_frame, _first_true,
                                          _pilot_slope, _rotate)
from sora_tpu_torch.phy.dot11n.tx import _pilot_table, _pilot_table_1ss
from sora_tpu_torch.util.xfer import device_complex

_LTS_SYM = np.asarray(C.LTS_TIME_SYM, dtype=np.complex64)
_LTS_SIGN = np.zeros(64, dtype=np.float32)
_LTS_SIGN[C.OCC_BINS] = C.LTS_FREQ

# window layout after the first LTS repeat (20 Msps samples)
_OFF_LSIG, _OFF_HTSIG1, _OFF_HTSIG2 = 128, 208, 288
_OFF_HTLTF1, _OFF_HTLTF2, _OFF_DATA = 448, 528, 608
_OFF_DATA_1SS = 528               # single HT-LTF: data starts 80 earlier

_SIG_PERM = C.interleaver_permutation(48, 1)

# HT-SIG CRC-8 as an affine map over GF(2): crc(b) = _CRC8_CONST ^ (M @ b)
# (dot11n_common.crc8_htsig is linear in the message given the all-ones
# init), so the check is one (8, 34) product on the device
_CRC8_CONST = N.crc8_htsig(np.zeros(34, np.uint8))
_CRC8_MAT = np.stack([
    N.crc8_htsig(np.eye(34, dtype=np.uint8)[i]) ^ _CRC8_CONST
    for i in range(34)], axis=1)                              # (8, 34)

# HT-LTF sequence on the 64 bins (1 outside the occupied set, the DC 0
# read as 1), the divisor of the channel estimate
_LSEQ_FULL = np.ones(64, np.float32)
_LSEQ_FULL[N.HT_OCC_BINS] = np.where(N.HTLTF_FREQ == 0, 1.0, N.HTLTF_FREQ)


def num_symbols(mcs: int, psdu_len: int) -> int:
    return -(-(16 + 8 * psdu_len + 6) // N.mcs_param(mcs).ndbps)


def max_symbols(mcs: int, max_psdu: int = MAX_PSDU) -> int:
    return num_symbols(mcs, max_psdu)


@lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The receiver's constant tables as tensors on ``device``."""
    t = lambda a, **kw: torch.as_tensor(np.asarray(a, **kw), device=device)
    pol = C.PILOT_VAL[None, :] * C.PILOT_POLARITY[:3, None]  # SIG symbols
    return {
        "lts_sign": t(_LTS_SIGN),
        "pilot_bins": t(C.PILOT_BINS, dtype=np.int64),
        "sig_pilots": t(pol, dtype=np.float32),                # (3, 4)
        "data_bins": t(C.DATA_BINS, dtype=np.int64),
        "ht_data_bins": t(N.HT_DATA_BINS, dtype=np.int64),
        "ht_pilot_bins": t(N.HT_PILOT_BINS, dtype=np.int64),
        "lseq": t(_LSEQ_FULL),
        "k4": t(N.HT_PILOT_SC, dtype=np.float32),
        "k52": t(N.HT_DATA_SC, dtype=np.float32),
        "sig_perm": t(_SIG_PERM, dtype=np.int64),
        "crc8_mat": t(_CRC8_MAT, dtype=np.int32),
        "crc8_const": t(_CRC8_CONST, dtype=np.int32),
        "pow7": t(np.arange(7), dtype=np.int32),
        "pow16": t(np.arange(16), dtype=np.int32),
    }


@lru_cache(maxsize=None)
def _pilot_expect(nsym: int, one_ss: bool, device: torch.device):
    """The expected HT pilots of nsym data symbols on ``device``: (nsym,
    2, 4) per stream, or (nsym, 4) for a single stream."""
    tab = _pilot_table_1ss(nsym) if one_ss else _pilot_table(nsym)
    return torch.as_tensor(tab, device=device)


# =============================================================================
# Synchronization (vectorized TCCA11n front end)
# =============================================================================


def synchronize(x: torch.Tensor):
    """Packet detect + timing + coarse CFO for a batch of 2-antenna streams.

    x: (B, 2, N) complex64.  Returns (lts1 (B,) int32 — start of the first
    legacy LTS repeat, cfo (B,) float32 rad/sample, det (B,) float32).
    """
    c2, cfo, det = lts_metric(x)
    lts1 = torch.argmax(c2, dim=-1).to(torch.int32)
    return lts1, cfo, det


def lts_metric(x: torch.Tensor):
    """The LTS metric that :func:`synchronize` takes the argmax of: (B, L)
    float32 summed over both antennas, zero outside each stream's window
    [sts, sts + 320]; with the coarse CFO and the detect metric."""
    B, A, Nn = x.shape
    xf = x.reshape(B * A, Nn)
    ac = xf[:, 16:] * torch.conj(xf[:, :-16])
    w = df.moving_sum(ac, 64).reshape(B, A, -1).sum(dim=1)
    en = df.moving_sum(torch.abs(xf[:, :-16]) ** 2, 64).float().reshape(
        B, A, -1).sum(dim=1)
    gate = en > 0.05 * en.max(dim=-1, keepdim=True).values
    m = torch.where(gate, torch.abs(w) / (en + 1e-9), 0.0)
    valid = m[:, : max(1, Nn - 900)]
    # plateau ONSET, not argmax: the HT-STF repeats the STS periodicity, so
    # the global lag-16 plateau maximum can land mid-frame; the first
    # sample over 90% of the plateau lies inside the legacy STS
    peak = valid.max(dim=-1, keepdim=True).values
    onset = _first_true(valid > 0.9 * peak)
    sts = torch.clamp(onset + 16, max=valid.shape[-1] - 1)
    det = valid.gather(1, sts[:, None])[:, 0]
    wsel = w.gather(1, sts[:, None])[:, 0]
    cfo = torch.angle(wsel).float() / 16.0
    n = torch.arange(Nn, dtype=torch.float32, device=x.device)
    y = (x * _rotate(cfo[:, None, None] * n)).reshape(B * A, Nn)
    c = torch.abs(df.correlate_stream(y, _LTS_SYM)).reshape(B, A, -1).sum(
        dim=1)
    c2 = c[:, :-64] + c[:, 64:]
    pos = torch.arange(c2.shape[-1], device=x.device)[None, :]
    # the legacy LTS begins within ~320 samples of the STS plateau onset;
    # the window excludes the (LTS-like) HT-LTFs further into the frame
    inwin = (pos >= sts[:, None]) & (pos <= sts[:, None] + 320)
    return torch.where(inwin, c2, 0.0), cfo, det


# =============================================================================
# Front end: CFO, legacy chanest, SIG symbols, MIMO chanest, detection
# =============================================================================


def _cut(x: torch.Tensor, lts1: torch.Tensor, cfo: torch.Tensor,
         need: int) -> torch.Tensor:
    """``need`` samples of both antennas from each frame's lts1, coarse
    then fine CFO removed: (B, 2, need).  A start is clamped into the
    zero-padded row, as lax.dynamic_slice does."""
    B, A, Nn = x.shape
    xp = torch.cat([x, x.new_zeros(B, A, need)], dim=-1)
    start = lts1.to(torch.int64).clamp(0, Nn)
    idx = start[:, None] + torch.arange(need, device=x.device)[None, :]
    y = xp.gather(2, idx[:, None, :].expand(B, A, need))
    n_idx = torch.arange(need, dtype=torch.float32, device=x.device)
    y = y * _rotate(cfo[:, None, None] * n_idx)
    fine = torch.angle(torch.sum(torch.conj(y[:, :, :64]) * y[:, :, 64:128],
                                 dim=(-2, -1))).float() / 64.0
    return y * _rotate(fine[:, None, None] * n_idx)


def _mrc_symbol(y: torch.Tensor, Hleg: torch.Tensor, off: int, pol_idx: int):
    """Legacy-coded symbol at window offset `off` -> (B, 48) equalized
    data carriers (TMrcCombine, PHY_11n.hpp:364 + pilot phase track)."""
    k = _consts(y.device)
    S = dfft.fft64(y[:, :, off + 16: off + 80])               # (B, 2, 64)
    num = torch.sum(torch.conj(Hleg) * S, dim=1)
    den = torch.sum(torch.abs(Hleg) ** 2, dim=1) + 1e-12
    E = num / den                                             # (B, 64)
    pv = E[:, k["pilot_bins"]] * k["sig_pilots"][pol_idx]
    E = E * _rotate(torch.angle(torch.sum(pv, dim=-1)))[:, None]
    return E[:, k["data_bins"]]


def _legacy_front(y: torch.Tensor):
    """Legacy per-antenna channel estimate, SNR, and the gain-normalized
    L-SIG / HT-SIG1 / HT-SIG2 carriers of a cut frame: (Hleg (B, 2, 64),
    nvar (B,), snr_db (B,), sig_eq (B, 3, 48))."""
    k = _consts(y.device)
    L = 0.5 * (dfft.fft64(y[:, :, :64]) + dfft.fft64(y[:, :, 64:128]))
    Hleg = L * k["lts_sign"]                                  # (B, 2, 64)
    nvar = torch.mean(torch.abs(y[:, :, :64] - y[:, :, 64:128]) ** 2,
                      dim=(-2, -1)) / 2
    sig_p = torch.mean(torch.abs(Hleg) ** 2, dim=(-2, -1)) * (64.0 / 52.0)
    snr_db = 10.0 * torch.log10(sig_p / (nvar + 1e-12) + 1e-12)
    lsig = _mrc_symbol(y, Hleg, _OFF_LSIG, 0)
    ht1 = _mrc_symbol(y, Hleg, _OFF_HTSIG1, 1)
    ht2 = _mrc_symbol(y, Hleg, _OFF_HTSIG2, 2)
    gain = torch.mean(torch.abs(lsig), dim=-1, keepdim=True) + 1e-12
    sig_eq = torch.stack([lsig, ht1, ht2], dim=1) / gain[:, None, :]
    return Hleg, nvar, snr_db, sig_eq


def _mm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of (..., 2, 2) complex matrices, written out elementwise."""
    a00, a01, a10, a11 = a[..., 0, 0], a[..., 0, 1], a[..., 1, 0], a[..., 1, 1]
    b00, b01, b10, b11 = b[..., 0, 0], b[..., 0, 1], b[..., 1, 0], b[..., 1, 1]
    return torch.stack([
        torch.stack([a00 * b00 + a01 * b10, a00 * b01 + a01 * b11], dim=-1),
        torch.stack([a10 * b00 + a11 * b10, a10 * b01 + a11 * b11], dim=-1),
    ], dim=-2)


def _inv2x2(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) complex matrices (the
    CSoraMatrix::inverse_scale analogue, sora_matrix.h:53-444)."""
    det = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)
    row0 = torch.stack([H[..., 1, 1], -H[..., 0, 1]], dim=-1)
    row1 = torch.stack([-H[..., 1, 0], H[..., 0, 0]], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def _mmse_w(Hs: torch.Tensor, s2: torch.Tensor):
    """Per-subcarrier MMSE weights W = (H^H H + s2 I)^-1 H^H of Hs (B, K,
    2, 2) and the diagonal of W H (B, K, 2) they are unbiased by."""
    Hh = torch.conj(Hs.transpose(-1, -2))
    G = _mm2(Hh, Hs)
    G = G + torch.diag_embed(s2[:, None, None].expand(*G.shape[:-1]))
    W = _mm2(_inv2x2(G), Hh)
    WH = _mm2(W, Hs)
    d = torch.stack([WH[..., 0, 0], WH[..., 1, 1]], dim=-1)
    return W, d + 1e-12


def _detect(W: torch.Tensor, S: torch.Tensor, d: torch.Tensor):
    """Apply (B, K, 2, 2) weights to (B, nsym, K, 2) carriers and unbias
    by (B, K, 2): xd[b, n, k, i] = sum_j W[b, k, i, j] S[b, n, k, j] /
    d[b, k, i]."""
    W = W[:, None]
    out = (W[..., 0] * S[..., 0:1] + W[..., 1] * S[..., 1:2])
    return out / d[:, None]


def extract_symbols(x: torch.Tensor, lts1: torch.Tensor, cfo: torch.Tensor,
                    nsym: int, short_gi: bool = False, mmse: bool = True,
                    return_weights: bool = False):
    """Front end through MMSE detection for SIG + nsym HT data symbols.

    x: (B, 2, N).  Returns (sig_eq (B, 3, 48) — L-SIG/HT-SIG1/HT-SIG2
    equalized carriers gain-normalized, xd (B, nsym, 52, 2) MMSE-detected
    per-stream data carriers, snr_db (B,)) and, with ``return_weights``,
    the (B, 52, 2) per-(carrier, stream) LLR weights.  ``short_gi`` reads
    72-sample data symbols (400 ns guard); ``mmse=False`` is plain ZF.
    """
    B = x.shape[0]
    k = _consts(x.device)
    per = 72 if short_gi else 80
    gi = per - 64
    y = _cut(x, lts1, cfo, _OFF_DATA + per * nsym)
    Hleg, nvar, snr_db, sig_eq = _legacy_front(y)

    # 2x2 MIMO channel estimate from the two P-mapped HT-LTFs
    # (TMimoChannelEst, channel_11n.hpp:331-445):
    # Y[b,a,k,n] = sum_i H[b,k,a,i] P2[i,n] Lseq[k], and P2^-1 is
    # [[1/2, 1/2], [-1/2, 1/2]]: exact real scalings
    Y1 = dfft.fft64(y[:, :, _OFF_HTLTF1 + 16: _OFF_HTLTF1 + 80])
    Y2 = dfft.fft64(y[:, :, _OFF_HTLTF2 + 16: _OFF_HTLTF2 + 80])
    pinv = N.P2_INV
    Ht = torch.stack([Y1 * float(pinv[0, m]) + Y2 * float(pinv[1, m])
                      for m in range(2)], dim=-1)             # (B,2,64,2)
    H = Ht.transpose(1, 2) / k["lseq"][None, :, None, None]   # (B,64,2,2)

    # Per-subcarrier MMSE detection weights, unbiased by diag(WH) so the
    # constellation gain is exact; s2 is the legacy-LTS noise estimate in
    # FFT-bin units (64x the per-sample variance); mmse=False: plain ZF
    s2 = (64.0 * nvar if mmse else torch.zeros_like(nvar)).to(
        torch.complex64)
    Wd, dd = _mmse_w(H[:, k["ht_data_bins"]], s2)             # (B,52,..)
    Wp, dp = _mmse_w(H[:, k["ht_pilot_bins"]], s2)            # (B,4,..)

    # per-(subcarrier, stream) post-detection confidence |diag(WH)|^2 /
    # [W W^H]_ii, normalized to unit mean: a stream the channel crushed
    # contributes near-erasures instead of full-confidence garbage
    ww = torch.sum(torch.abs(Wd) ** 2, dim=-1)                # (B,52,2)
    wgt = (torch.abs(dd) ** 2) / (ww + 1e-20)
    wgt = wgt / (torch.mean(wgt, dim=(1, 2), keepdim=True) + 1e-20)
    wgt = wgt.float()

    if nsym == 0:
        xd = torch.zeros(B, 0, 52, 2, dtype=torch.complex64, device=x.device)
        if return_weights:
            return sig_eq, xd, snr_db, wgt
        return sig_eq, xd, snr_db
    sym = y[:, :, _OFF_DATA: _OFF_DATA + per * nsym].reshape(
        B, 2, nsym, per)[:, :, :, gi:]
    S = dfft.fft64(sym)                                       # (B,2,nsym,64)
    Sd = S[..., k["ht_data_bins"]].permute(0, 2, 3, 1)        # (B,nsym,52,2)
    Sp = S[..., k["ht_pilot_bins"]].permute(0, 2, 3, 1)       # (B,nsym,4,2)
    xd = _detect(Wd, Sd, dd)
    xpil = _detect(Wp, Sp, dp)

    # phase + slope tracking from the HT pilots (TPilotTrack_11n,
    # pilot_11n.hpp:99 + pilot.hpp:142-236): every stream's detected pilot
    # carries the same common phase + per-subcarrier ramp
    expect = _pilot_expect(nsym, False, x.device)             # (nsym,2,4)
    pvs = xpil.transpose(2, 3) * torch.conj(expect.to(torch.complex64))[None]
    pv4 = torch.sum(pvs, dim=2)                  # (B, nsym, 4) per pilot
    slope = _pilot_slope(pv4)
    # de-ramp before the common-phase sum (see phy.dot11a.rx)
    ph = torch.angle(torch.sum(
        pv4 * _rotate(slope[:, :, None] * k["k4"][None, None, :]), dim=-1))
    xd = xd * _rotate(ph[:, :, None]
                      + slope[:, :, None] * k["k52"][None, None, :]
                      )[:, :, :, None]
    if return_weights:
        return sig_eq, xd, snr_db, wgt
    return sig_eq, xd, snr_db


# =============================================================================
# SIG decode
# =============================================================================


def decode_lsig(eq: torch.Tensor) -> torch.Tensor:
    """(B, 48) L-SIG carriers -> lsig_ok (B,) bool.  In HT mixed mode the
    L-SIG only gates the frame (a 6 Mbps spoof length); its validity is
    the 11a receiver's ML decode over the valid-SIGNAL codebook."""
    return arx.decode_signal(eq)[2]


def decode_htsig(eq2: torch.Tensor):
    """(B, 2, 48) HT-SIG1/2 carriers (QBPSK — constellation on the
    imaginary axis) -> (mcs (B,), length (B,), crc_ok (B,), sgi (B,)),
    int32 / bool, where sgi is HT-SIG bit 31 (the short-guard flag).  The
    96 soft values decode as one 48-step window of the Viterbi."""
    k = _consts(eq2.device)
    soft = eq2.imag.float()[:, :, k["sig_perm"]]
    hs = soft.reshape(soft.shape[0], 96)
    bits = dvit.decode_auto(hs.reshape(-1, 48, 2), terminated=True,
                            blockwise=False).to(torch.int32)
    mcs = torch.sum(bits[:, :7] << k["pow7"], dim=-1).to(torch.int32)
    length = torch.sum(bits[:, 8:24] << k["pow16"], dim=-1).to(torch.int32)
    crc = (torch.sum(k["crc8_mat"][None] * bits[:, None, :34], dim=-1)
           + k["crc8_const"][None]) & 1
    crc_ok = torch.all(crc == bits[:, 34:42], dim=-1)
    tail_ok = torch.sum(bits[:, 42:48], dim=-1) == 0
    return mcs, length, crc_ok & tail_ok, bits[:, 31]


# =============================================================================
# DATA decode (per-MCS)
# =============================================================================

_NBPSC = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}
_MCS_LIST = sorted(N.MCS)                          # 8..15, idx 0..7
_MCS1_LIST = sorted(N.MCS1)                        # 0..7
_MOD_ORDER = ("bpsk", "qpsk", "qam16", "qam64")
_MOD_OFF_N = {"bpsk": 0, "qpsk": 52, "qam16": 156, "qam64": 364}
_STREAM_W = 676                                    # 52+104+208+312


def _depuncture_slots(m: N.McsParam) -> np.ndarray:
    """The trellis slots of one symbol (of 2*ndbps) that carry a coded bit."""
    pa, pb = N.puncture_pattern(m.num, m.den)
    keep = np.stack([pa, pb], -1).reshape(-1)
    keepf = np.tile(keep, -(-2 * m.ndbps // len(keep)))[: 2 * m.ndbps]
    return np.flatnonzero(keepf)


@lru_cache(maxsize=None)
def _auto_tables_n(max_psdu: int, nsym_cap: int = 1 << 30):
    """Static per-MCS one-hot matrices collapsing stream parse +
    deinterleave + depuncture + modulation select for ONE HT symbol.

    HT symbol boundaries align with puncture-period boundaries for every
    MCS, so the map from a symbol's concatenated soft vector (2 streams x
    676) to its (ndbps, 2) trellis slots is the same linear map for every
    symbol.  Punctured slots are all-zero columns (erasures).
    ``nsym_cap`` bounds symbols by the input window's capacity.

    Returns (mats tuple of (1352, 2*ndbps) float32; nsym (8,) per-MCS
    symbol counts; ndbps (8,) int32; nsym_max; T_max)."""
    nsyms = tuple(min(max_symbols(mc, max_psdu), nsym_cap)
                  for mc in _MCS_LIST)
    nsym_max = max(nsyms)
    t_max = max(n * N.MCS[mc].ndbps for n, mc in zip(nsyms, _MCS_LIST))
    mats = []
    for mc in _MCS_LIST:
        m = N.MCS[mc]
        ncbps = 2 * m.ncbpss
        sp = N.stream_parse_indices(ncbps, m.nbpsc)        # (2, ncbpss)
        inv_stream = np.zeros(ncbps, np.int64)
        inv_pos = np.zeros(ncbps, np.int64)
        for i in range(2):
            inv_stream[sp[i]] = i
            inv_pos[sp[i]] = np.arange(m.ncbpss)
        perm2 = np.stack([N.ht_interleaver_permutation(m.nbpsc, i)
                          for i in range(2)])              # (2, ncbpss)
        q = np.arange(ncbps)
        i_s = inv_stream[q]
        src = (i_s * _STREAM_W + _MOD_OFF_N[m.modulation]
               + perm2[i_s, inv_pos[q]])
        P = np.zeros((2 * _STREAM_W, 2 * m.ndbps), np.float32)
        P[src, _depuncture_slots(m)] = 1.0
        mats.append(P)
    return (tuple(mats), nsyms,
            np.array([N.MCS[mc].ndbps for mc in _MCS_LIST], np.int32),
            nsym_max, t_max)


@lru_cache(maxsize=None)
def _auto_tables_1ss(max_psdu: int, nsym_cap: int = 1 << 30):
    """Per-MCS one-hot (676 -> 2*ndbps) matrices for the single-stream
    mixed-MCS decoder (the Nss=1 sibling of _auto_tables_n)."""
    nsyms = tuple(min(max_symbols(mc, max_psdu), nsym_cap)
                  for mc in _MCS1_LIST)
    nsym_max = max(nsyms)
    t_max = max(n * N.MCS1[mc].ndbps for n, mc in zip(nsyms, _MCS1_LIST))
    mats = []
    for mc in _MCS1_LIST:
        m = N.MCS1[mc]
        perm = N.ht_interleaver_permutation(m.nbpsc, 0)
        P = np.zeros((_STREAM_W, 2 * m.ndbps), np.float32)
        P[_MOD_OFF_N[m.modulation] + perm[np.arange(m.ncbpss)],
          _depuncture_slots(m)] = 1.0
        mats.append(P)
    return (tuple(mats), nsyms,
            np.array([N.MCS1[mc].ndbps for mc in _MCS1_LIST], np.int32),
            nsym_max, t_max)


@lru_cache(maxsize=None)
def _mcs_symbol_matrix(mcs: int) -> np.ndarray:
    """(2*ncbpss, 2*ndbps) per-symbol one-hot collapsing stream parse +
    per-stream HT deinterleave + depuncture (the fixed-MCS slice of the
    _auto_tables_n construction)."""
    m = N.MCS[mcs]
    mats = _auto_tables_n(1 << 20, 1 << 20)[0]
    ri = _MCS_LIST.index(mcs)
    off = _MOD_OFF_N[m.modulation]
    rows = [np.asarray(mats[ri][i * _STREAM_W + off:
                                i * _STREAM_W + off + m.ncbpss])
            for i in range(2)]
    return np.concatenate(rows, axis=0)


@lru_cache(maxsize=None)
def _mcs1_symbol_matrix(mcs: int) -> np.ndarray:
    """(ncbpss, 2*ndbps) per-symbol one-hot collapsing the stream-0 HT
    deinterleave + depuncture into one linear map (the Nss=1 slice of
    the _auto_tables_n construction)."""
    m = N.MCS1[mcs]
    perm = N.ht_interleaver_permutation(m.nbpsc, 0)
    P = np.zeros((m.ncbpss, 2 * m.ndbps), np.float32)
    P[perm[np.arange(m.ncbpss)], _depuncture_slots(m)] = 1.0
    return P


@lru_cache(maxsize=None)
def _symbol_gather(mcs: int, device: torch.device):
    """The fixed-MCS one-hot matrix as a gather: for each (A, B) slot of a
    symbol, the soft position it reads and whether it was transmitted."""
    P = _mcs1_symbol_matrix(mcs) if mcs in N.MCS1 else _mcs_symbol_matrix(mcs)
    return (torch.as_tensor(P.argmax(axis=0), device=device),
            torch.as_tensor(P.sum(axis=0) > 0, device=device))


def _expand_weights(wgt: torch.Tensor, nbpsc: int) -> torch.Tensor:
    """(B, 52, 2) per-(subcarrier, stream) LLR weights -> (B, 2*52*nbpsc)
    per-soft-bit scale, stream-major then carrier-major (the demap
    concat layout of decode_data)."""
    w = torch.repeat_interleave(wgt.transpose(1, 2), nbpsc, dim=-1)
    return w.reshape(wgt.shape[0], -1)


def _mask_symbols(soft: torch.Tensor, length: torch.Tensor,
                  ndbps) -> torch.Tensor:
    """Erase (zero) the soft values of symbols past each frame's extent;
    soft is (B, nsym, ...) and ndbps an int or a (B,) tensor."""
    nbits = 16 + 8 * length.to(torch.int64) + 6
    nsym_actual = (nbits + ndbps - 1) // ndbps
    symi = torch.arange(soft.shape[1], device=soft.device)
    shape = (1, -1) + (1,) * (soft.dim() - 2)
    nshape = (-1, 1) + (1,) * (soft.dim() - 2)
    return torch.where(symi.reshape(shape) < nsym_actual.reshape(nshape),
                       soft, 0.0)


def data_soft(xd: torch.Tensor, length: torch.Tensor, mcs: int,
              weights: torch.Tensor = None) -> torch.Tensor:
    """Demapped, weighted, length-masked, stream-deparsed, deinterleaved
    and depunctured soft pairs of the data symbols of one MCS: the Viterbi
    input of :func:`decode_data` / :func:`decode_data_1ss`, (B, nsym_max *
    ndbps, 2) float32.  xd is (B, nsym, 52, 2) for MCS 8-15 and (B, nsym,
    52) for MCS 0-7; weights (B, 52, 2) or (B, 52)."""
    m = N.mcs_param(mcs)
    B, nsym_max = xd.shape[0], xd.shape[1]
    if m.nss == 1:
        soft = dmap.demap_soft(xd, m.modulation)     # (B, nsym, ncbpss)
        if weights is not None:
            soft = soft * torch.repeat_interleave(
                weights, m.nbpsc, dim=-1)[:, None, :]
    else:
        soft = torch.cat([dmap.demap_soft(xd[:, :, :, i], m.modulation)
                          for i in range(2)], dim=-1)  # (B, nsym, 2*ncbpss)
        if weights is not None:
            soft = soft * _expand_weights(weights, m.nbpsc)[:, None, :]
    soft = _mask_symbols(soft, length, m.ndbps)
    src, sent = _symbol_gather(mcs, xd.device)
    ab = torch.where(sent, soft[..., src], 0.0)      # (B, nsym, 2*ndbps)
    return ab.reshape(B, nsym_max * m.ndbps, 2)


def decode_data(xd: torch.Tensor, length: torch.Tensor, mcs: int,
                max_psdu: int = MAX_PSDU, weights: torch.Tensor = None):
    """Decode MMSE-detected HT data symbols for one MCS 8-15.

    xd: (B, nsym_max, 52, 2) per-stream detected carriers; length: (B,)
    PSDU byte counts from HT-SIG; weights: optional (B, 52, 2) LLR
    confidence from extract_symbols(return_weights=True).  Returns
    (psdu (B, max_psdu) uint8, fcs_ok (B,) bool).
    """
    t_steps = xd.shape[1] * N.MCS[mcs].ndbps
    bits = dvit.decode_auto(data_soft(xd, length, mcs, weights),
                            terminated=True)
    return _finish_frame(bits, length, t_steps, max_psdu)


def _parse_sigs(sig_eq: torch.Tensor, max_psdu: int):
    """L-SIG and HT-SIG of (B, 3, 48) carriers -> (sig_ok, mcs, length
    clamped to [0, max_psdu], sgi)."""
    lsig_ok = decode_lsig(sig_eq[:, 0])
    mcs_rx, length, htsig_ok, sgi_rx = decode_htsig(sig_eq[:, 1:])
    length = torch.clamp(length, 0, max_psdu).to(torch.int32)
    return lsig_ok & htsig_ok, mcs_rx, length, sgi_rx


def _pipeline_out(psdu, fcs_ok, sig_ok, ok, cs_ok, det, mcs, length,
                  **extra) -> dict:
    u8 = lambda v: v.to(torch.uint8)
    out = {"psdu": psdu, "fcs_ok": u8(fcs_ok), "sig_ok": u8(sig_ok),
           "ok": u8(ok), "cs_ok": u8(cs_ok), "det": det,
           "mcs": mcs.to(torch.int32), "length": length}
    out.update(extra)
    return out


def _fixed_tail(sig_eq, xd, det, wgt, mcs: int, max_psdu: int,
                short_gi: bool, decode) -> dict:
    """SIG parse + one-MCS data decode + the frame's verdict."""
    sig_ok, mcs_rx, length, sgi_rx = _parse_sigs(sig_eq, max_psdu)
    psdu, fcs_ok = decode(xd, length, mcs, max_psdu, wgt)
    cs_ok = det >= CS_DET_THRESHOLD
    ok = (cs_ok & sig_ok & (mcs_rx == mcs) & fcs_ok
          & (sgi_rx == (1 if short_gi else 0)))
    return _pipeline_out(psdu, fcs_ok, sig_ok, ok, cs_ok, det, mcs_rx,
                         length)


def rx_pipeline(x: torch.Tensor, mcs: int, max_psdu: int = MAX_PSDU,
                short_gi: bool = False, mmse: bool = True,
                weighted: bool = True) -> dict:
    """Complete batched 2x2 HT RX for a known MCS 8-15.

    x: (B, 2, N) complex64.  Returns a dict with psdu (B, max_psdu) uint8,
    ok/fcs_ok/sig_ok/cs_ok (B,) uint8, mcs/length (B,) int32, det, snr_db,
    lts1, cfo.  ``short_gi`` decodes 400 ns-guard data symbols and requires
    HT-SIG bit 31 to agree.  Makes no host sync.
    """
    per = 72 if short_gi else 80
    nsym_win = max(1, (int(x.shape[-1]) - _OFF_DATA) // per)
    nsym = min(max_symbols(mcs, max_psdu), nsym_win)
    lts1, cfo, det = synchronize(x)
    sig_eq, xd, snr_db, wgt = extract_symbols(x, lts1, cfo, nsym, short_gi,
                                              mmse, return_weights=True)
    out = _fixed_tail(sig_eq, xd, det, wgt if weighted else None, mcs,
                      max_psdu, short_gi, decode_data)
    out.update({"snr_db": snr_db, "lts1": lts1, "cfo": cfo})
    return out


# =============================================================================
# Single-spatial-stream path (MCS 0-7, Table 20-30)
# =============================================================================
#
# Nsts = 1 degenerates the MIMO machinery: ONE HT-LTF (so data starts 80
# samples earlier), a (2 RX x 1) channel column, and maximal-ratio
# combining instead of the 2x2 inverse.


def extract_symbols_1ss(x: torch.Tensor, lts1: torch.Tensor,
                        cfo: torch.Tensor, nsym: int,
                        short_gi: bool = False,
                        return_weights: bool = False):
    """Front end for single-stream HT frames.  x: (B, 2, N).
    Returns (sig_eq (B, 3, 48), xd (B, nsym, 52), snr_db (B,)[, wgt
    (B, 52) per-subcarrier MRC confidence for LLR weighting])."""
    B = x.shape[0]
    k = _consts(x.device)
    per = 72 if short_gi else 80
    gi = per - 64
    y = _cut(x, lts1, cfo, _OFF_DATA_1SS + per * nsym)
    _, _, snr_db, sig_eq = _legacy_front(y)

    if nsym == 0:
        z = torch.zeros(B, 0, 52, dtype=torch.complex64, device=x.device)
        if return_weights:
            return sig_eq, z, snr_db, torch.ones(B, 52, device=x.device)
        return sig_eq, z, snr_db

    # (2 x 1) channel column from the single HT-LTF
    Yl = dfft.fft64(y[:, :, _OFF_HTLTF1 + 16: _OFF_HTLTF1 + 80])
    H = Yl * k["lseq"][None, None, :]                     # (B, 2, 64)
    sym = y[:, :, _OFF_DATA_1SS: _OFF_DATA_1SS + per * nsym].reshape(
        B, 2, nsym, per)[:, :, :, gi:]
    S = dfft.fft64(sym)                                   # (B,2,nsym,64)
    num = torch.sum(torch.conj(H)[:, :, None, :] * S, dim=1)
    den = torch.sum(torch.abs(H) ** 2, dim=1)[:, None, :] + 1e-12
    E = num / den                                         # (B,nsym,64)

    # pilot phase + slope track (PSI1 rotation, eq 20-59)
    expect = _pilot_expect(nsym, True, x.device)          # (nsym, 4)
    pv = E[:, :, k["ht_pilot_bins"]] * expect[None]
    slope = _pilot_slope(pv)
    ph = torch.angle(torch.sum(
        pv * _rotate(slope[:, :, None] * k["k4"][None, None, :]), dim=-1))
    E = E[:, :, k["ht_data_bins"]] * _rotate(
        ph[:, :, None] + slope[:, :, None] * k["k52"][None, None, :])
    if return_weights:
        # post-MRC inverse noise amplification = the combining gain
        # sum_a |H_ak|^2 itself (E is unbiased); unit-mean normalized
        wgt = den[:, 0, k["ht_data_bins"]]
        wgt = wgt / (torch.mean(wgt, dim=-1, keepdim=True) + 1e-20)
        return sig_eq, E, snr_db, wgt.float()
    return sig_eq, E, snr_db


def decode_data_1ss(xd: torch.Tensor, length: torch.Tensor, mcs: int,
                    max_psdu: int = MAX_PSDU,
                    weights: torch.Tensor = None):
    """xd: (B, nsym_max, 52) MRC-combined carriers -> (psdu, fcs_ok).
    weights: optional (B, 52) per-subcarrier LLR confidence."""
    t_steps = xd.shape[1] * N.MCS1[mcs].ndbps
    bits = dvit.decode_auto(data_soft(xd, length, mcs, weights),
                            terminated=True)
    return _finish_frame(bits, length, t_steps, max_psdu)


def rx_pipeline_1ss(x: torch.Tensor, mcs: int, max_psdu: int = MAX_PSDU,
                    short_gi: bool = False) -> dict:
    """Complete batched single-stream HT RX for a known MCS 0-7.
    x: (B, 2, N) complex64 (2 RX antennas, MRC).  Makes no host sync."""
    per = 72 if short_gi else 80
    nsym_win = max(1, (int(x.shape[-1]) - _OFF_DATA_1SS) // per)
    nsym = min(max_symbols(mcs, max_psdu), nsym_win)
    lts1, cfo, det = synchronize(x)
    sig_eq, xd, snr_db, wgt = extract_symbols_1ss(
        x, lts1, cfo, nsym, short_gi, return_weights=True)
    out = _fixed_tail(sig_eq, xd, det, wgt, mcs, max_psdu, short_gi,
                      decode_data_1ss)
    out.update({"snr_db": snr_db, "lts1": lts1, "cfo": cfo})
    return out


# =============================================================================
# Mixed-MCS batched decode (runtime MCS dispatch)
# =============================================================================
#
# As in the JAX package: every HT symbol is demapped under all four
# modulations per spatial stream and concatenated (676 soft values per
# stream); stream parse + deinterleave + depuncture + modulation select is
# one static table per MCS (the batched TBB11nMRSelect, PHY_11n.hpp:290).
# The JAX package applies the tables as eight one-hot matmuls whose
# results it sums; here each row gathers through its own MCS's table.
# Every trellis slot has at most one source, so the two are equal.


@lru_cache(maxsize=None)
def _auto_gather_n(one_ss: bool, max_psdu: int, nsym_cap: int,
                   device: torch.device) -> dict:
    """The per-MCS tables as gather tables on ``device``: for MCS index r
    and output slot q of the flattened (t_max, 2) trellis input,
    ``src[r, q]`` = s * width + column of the soft value it reads (symbol
    s of the width-wide concatenated demap) and ``sent[r, q]`` whether it
    was transmitted (False: an erasure, as are slots past the MCS's nsym
    * ndbps steps).  ``wcol`` maps each of a stream's 676 soft values to
    its subcarrier (the weights' repeat by nbpsc)."""
    tables = _auto_tables_1ss if one_ss else _auto_tables_n
    mats, nsyms, ndbps, _, t_max = tables(max_psdu, nsym_cap)
    sym_w = mats[0].shape[0]
    src = np.zeros((len(mats), 2 * t_max), np.int64)
    sent = np.zeros((len(mats), 2 * t_max), bool)
    for ri, P in enumerate(mats):
        width = P.shape[1]                           # 2 * ndbps
        q = np.arange(nsyms[ri] * width)
        src[ri, : q.size] = (q // width) * sym_w + P.argmax(axis=0)[q % width]
        sent[ri, : q.size] = P.sum(axis=0)[q % width] > 0
    wcol = np.concatenate([np.repeat(np.arange(52), _NBPSC[m])
                           for m in _MOD_ORDER])
    t = lambda a: torch.as_tensor(a, device=device)
    return {"src": t(src), "sent": t(sent), "wcol": t(wcol),
            "ndbps": t(ndbps.astype(np.int64)), "t_max": t_max}


def _demap_all(xs: torch.Tensor) -> torch.Tensor:
    """(..., 52) carriers -> (..., 676): the soft values under all four
    modulations, concatenated."""
    return torch.cat([dmap.demap_soft(xs, mod) for mod in _MOD_ORDER],
                     dim=-1)


def _auto_decode(soft_cat: torch.Tensor, length: torch.Tensor,
                 mcs_idx: torch.Tensor, k: dict, max_psdu: int):
    """Mask, select through each row's MCS table, decode and finish:
    soft_cat is (B, nsym, width) weighted soft values."""
    B, nsym, width = soft_cat.shape
    soft_cat = _mask_symbols(soft_cat, length, k["ndbps"][mcs_idx])
    ab = soft_cat.reshape(B, nsym * width).gather(1, k["src"][mcs_idx])
    ab = torch.where(k["sent"][mcs_idx], ab, 0.0).reshape(B, k["t_max"], 2)
    bits = dvit.decode_auto(ab, terminated=True)
    return _finish_frame(bits, length, k["t_max"], max_psdu)


def rx_pipeline_auto_1ss(x: torch.Tensor, max_psdu: int = MAX_PSDU) -> dict:
    """Complete batched single-stream HT RX with runtime MCS dispatch: a
    batch mixing MCS 0-7 decodes in one pass, with two Viterbi launches.
    x: (B, 2, N).  Makes no host sync."""
    nsym_win = max(1, (int(x.shape[-1]) - _OFF_DATA_1SS) // 80)
    nsym_max = _auto_tables_1ss(max_psdu, nsym_win)[3]
    k = _auto_gather_n(True, max_psdu, nsym_win, x.device)
    lts1, cfo, det = synchronize(x)
    sig_eq, xd, snr_db, wgt = extract_symbols_1ss(
        x, lts1, cfo, nsym_max, return_weights=True)
    sig_ok, mcs_rx, length, sgi_rx = _parse_sigs(sig_eq, max_psdu)
    # the mixed-MCS program decodes 800 ns-guard symbols; an SGI frame
    # must not false-accept here (route it to the short_gi pipelines)
    known = ((mcs_rx >= _MCS1_LIST[0]) & (mcs_rx <= _MCS1_LIST[-1])
             & (sgi_rx == 0))
    mcs_idx = torch.clamp(mcs_rx, 0, len(_MCS1_LIST) - 1).to(torch.int64)
    soft_cat = _demap_all(xd) * wgt[:, k["wcol"]][:, None, :]
    psdu, fcs_ok = _auto_decode(soft_cat, length, mcs_idx, k, max_psdu)
    cs_ok = det >= CS_DET_THRESHOLD
    ok = cs_ok & sig_ok & known & fcs_ok
    return _pipeline_out(psdu, fcs_ok, sig_ok, ok, cs_ok, det, mcs_rx,
                         length, snr_db=snr_db, lts1=lts1, cfo=cfo)


def rx_pipeline_auto(x: torch.Tensor, max_psdu: int = MAX_PSDU,
                     min_mcs: int = 8) -> dict:
    """Complete batched 2x2 HT RX with per-frame runtime MCS dispatch: a
    batch mixing MCS 8-15 decodes in one pass, with two Viterbi launches.

    ``min_mcs`` declares the slowest MCS actually expected on the air
    (NodeConfig.min_rate_mbps's HT analogue): the per-MCS symbol tables
    cap at that MCS's max_psdu airtime, so a batch does not pay the MCS 8
    worst case when the traffic is all high-MCS.  Frames at a slower MCS
    and longer than the cap truncate (crc_fail).

    x: (B, 2, N) complex64.  Returns the rx_pipeline dict (mcs is the
    per-frame parsed MCS).  Makes no host sync.
    """
    nsym_win = max(1, (int(x.shape[-1]) - _OFF_DATA) // 80)
    nsym_air = max_symbols(max(8, min(15, min_mcs)), max_psdu)
    nsym_win = min(nsym_win, nsym_air)
    nsym_max = _auto_tables_n(max_psdu, nsym_win)[3]
    lts1, cfo, det = synchronize(x)
    sig_eq, xd, snr_db, wgt = extract_symbols(x, lts1, cfo, nsym_max,
                                              return_weights=True)
    out = auto_tail(sig_eq, xd, det, max_psdu, nsym_win, weights=wgt)
    out.update({"snr_db": snr_db, "lts1": lts1, "cfo": cfo})
    return out


def auto_tail(sig_eq: torch.Tensor, xd: torch.Tensor, det: torch.Tensor,
              max_psdu: int, nsym_cap: int,
              det_threshold: float = CS_DET_THRESHOLD,
              weights: torch.Tensor = None) -> dict:
    """L-SIG/HT-SIG parse + mixed-MCS decode from detected symbols — the
    back half of :func:`rx_pipeline_auto`.  ``ok`` is gated on the
    carrier-sense metric like the 11a chain (TCCA11n's decision
    statistic, cca_11n.hpp:7)."""
    k = _auto_gather_n(False, max_psdu, nsym_cap, xd.device)
    sig_ok, mcs_rx, length, sgi_rx = _parse_sigs(sig_eq, max_psdu)
    known = ((mcs_rx >= _MCS_LIST[0]) & (mcs_rx <= _MCS_LIST[-1])
             & (sgi_rx == 0))
    mcs_idx = torch.clamp(mcs_rx - _MCS_LIST[0], 0,
                          len(_MCS_LIST) - 1).to(torch.int64)
    B, nsym = xd.shape[:2]
    soft_cat = torch.stack([_demap_all(xd[:, :, :, i]) for i in range(2)],
                           dim=2)                   # (B, nsym, 2, 676)
    if weights is not None:
        soft_cat = soft_cat * weights.transpose(1, 2)[:, None, :, k["wcol"]]
    psdu, fcs_ok = _auto_decode(soft_cat.reshape(B, nsym, 2 * _STREAM_W),
                                length, mcs_idx, k, max_psdu)
    cs_ok = det >= det_threshold
    ok = cs_ok & sig_ok & known & fcs_ok
    return _pipeline_out(psdu, fcs_ok, sig_ok, ok, cs_ok, det, mcs_rx,
                         length)


# =============================================================================
# Host-facing API
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
    snr_est_db: float = 0.0
    _debug: dict = field(default_factory=dict)


def demodulate(x, expect_mcs: int | None = None, device=None) -> RxResult:
    """Single-frame convenience wrapper (API-compatible with the golden
    model's demodulate): host samples (2, nsamples) at 20 Msps in, an
    :class:`RxResult` out; routes by the parsed HT-SIG (MCS 0-7 single
    stream, 8-15 2x2, either guard interval).  Runs on ``device``
    (default cuda; raises without CUDA unless ``device="cpu"``)."""
    xb = device_complex(np.asarray(x, dtype=np.complex64)[None], device)
    res = RxResult()
    if xb.dim() != 3 or xb.shape[1] != 2 or xb.shape[2] < 900:
        return res
    lts1, cfo, det = synchronize(xb)
    res.start = int(lts1[0])
    res.cfo = float(cfo[0])
    if float(det[0]) < CS_DET_THRESHOLD:
        res.reason = "cs_timeout"       # E_ERROR_CS_TIMEOUT analogue
        return res
    sig_eq, _, snr = extract_symbols(xb, lts1, cfo, 0)
    res.snr_est_db = float(snr[0])
    if not bool(decode_lsig(sig_eq[:, 0])[0]):
        res.reason = "plcp_header_fail"
        return res
    mcs_rx, length, htsig_ok, sgi_rx = decode_htsig(sig_eq[:, 1:])
    if not bool(htsig_ok[0]):
        res.reason = "htsig_fail"
        return res
    sgi = bool(int(sgi_rx[0]))
    mcs, res.length = int(mcs_rx[0]), int(length[0])
    res.mcs = mcs
    if mcs not in N.MCS and mcs not in N.MCS1:
        res.reason = "htsig_fail"
        return res
    if expect_mcs is not None and mcs != expect_mcs:
        res.reason = "unexpected_mcs"
        return res
    if res.length > MAX_PSDU:
        res.reason = "oversize"
        return res
    one_ss = mcs in N.MCS1
    off_data = _OFF_DATA_1SS if one_ss else _OFF_DATA
    per = 72 if sgi else 80
    if xb.shape[2] < res.start + off_data + per * num_symbols(mcs,
                                                               res.length):
        res.reason = "truncated"
        return res
    nsym = max_symbols(mcs)
    ln = torch.tensor([res.length], dtype=torch.int32, device=xb.device)
    if one_ss:
        _, xd, _, wgt = extract_symbols_1ss(xb, lts1, cfo, nsym, sgi,
                                            return_weights=True)
        psdu, fcs_ok = decode_data_1ss(xd, ln, mcs, weights=wgt)
    else:
        _, xd, _, wgt = extract_symbols(xb, lts1, cfo, nsym, sgi,
                                        return_weights=True)
        psdu, fcs_ok = decode_data(xd, ln, mcs, weights=wgt)
    res.psdu = bytes(psdu[0, : res.length].cpu().numpy())
    res.fcs_ok = bool(fcs_ok[0])
    res.ok = res.fcs_ok
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    return res
