"""802.11b DSSS receiver — torch, batched (port of
``sora_tpu.phy.dot11b.rx``: the fixed-rate and the mixed-rate pipelines,
long and short preamble).

Reference graph (fb11bdemod_config.hpp:92-142): TEnergyDetect ->
TSymTiming/TBarkerSync -> TBB11bDespread -> TDBPSKDemap/TDQPSKDemap |
TCCK*Decoder -> TDesc741 descramble -> TBB11bPlcpParser (CRC16) -> frame
sink (FCS).  The reference hunts timing and the SFD with per-sample state
machines; here every stage is computed for all candidate positions at
once and selected with argmax — the two-phase vectorized detection of
the JAX package.

The JAX package slices rows with ``vmap(dynamic_slice)``, whose start is
clamped into the (padded) row, and gathers with clipped indices; here a
gather of the few positions a stage reads replaces each slice, with the
same clamps, and positions past the padded row's data read zero.  The
GF(2) products (PLCP CRC-16, SFD distance) are integer sums, exact on
any device; the CCK correlator bank is one complex64 matmul (TF32 stays
off, PyTorch's default).  Every function computes on its input tensor's
device and makes no host sync; :func:`demodulate`, which takes host
samples, defaults to CUDA and raises without it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.dsp import crc as dcrc
from sora_tpu_torch.dsp import filters as df
from sora_tpu_torch.phy import dot11b_common as B
from sora_tpu_torch.util.xfer import device_complex, fetch

_SFD = np.array([(B.SFD_LONG >> i) & 1 for i in range(16)], np.uint8)
_SFD_S = np.array([(B.SFD_SHORT >> i) & 1 for i in range(16)], np.uint8)
_SFD_LIMIT = B.SYNC_BITS + 64           # search window for the SFD
_BARKER = B.BARKER.astype(np.complex64)
RATES = (1, 2, 5.5, 11)
_HALF_PI = math.pi / 2


# =============================================================================
# GF(2) affine CRC-16 (PLCP header check without a bit-serial scan)
# =============================================================================


@lru_cache(maxsize=None)
def _crc16_affine():
    """CRC-16/PLCP over 32 bits is affine over GF(2): crc_bits = b @ M ^ c0.
    M: (32, 16) uint8, c0: (16,) uint8 (LSB-first crc bits as transmitted,
    matching plcp_header_bits)."""
    def crc_bits(bits32):
        v = B.crc16_plcp(np.asarray(bits32, np.uint8))
        return np.array([(v >> i) & 1 for i in range(16)], np.uint8)

    c0 = crc_bits(np.zeros(32, np.uint8))
    M = np.zeros((32, 16), np.uint8)
    for i in range(32):
        e = np.zeros(32, np.uint8)
        e[i] = 1
        M[i] = crc_bits(e) ^ c0
    return M, c0


@lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The receiver's constant tables as tensors on ``device``."""
    M, c0 = _crc16_affine()
    t = lambda a, **kw: torch.as_tensor(np.asarray(a, **kw), device=device)
    return {
        "crc_m": t(M, dtype=np.int32), "crc_c0": t(c0, dtype=np.int32),
        "sfd": t(_SFD), "sfd_s": t(_SFD_S),
        "demap": t(np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)),
        "p2": t(1 << np.arange(16), dtype=np.int32),
        "book55": t(np.conj(B.cck55_codebook()).T, dtype=np.complex64),
        "book11": t(np.conj(B.cck11_codebook()).T, dtype=np.complex64),
        "signal": t([B.SIGNAL_BYTE[r] for r in RATES], dtype=np.int32),
        "mbps": t(RATES, dtype=np.float32),
    }


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none) — JAX's
    argmax on a bool array."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _take(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """row[b, idx[b, k]], reading zero past the row's end (the zero padding
    the JAX package slices from); idx >= 0."""
    n = row.shape[-1]
    got = row.gather(1, idx.clamp(max=n - 1))
    return torch.where(idx < n, got, torch.zeros((), dtype=row.dtype,
                                                 device=row.device))


def _crc16_check(hdr: torch.Tensor) -> torch.Tensor:
    """hdr: (B, 48) bits -> (B,) bool CRC pass."""
    k = _consts(hdr.device)
    acc = torch.sum(hdr[:, :32, None].to(torch.int32) * k["crc_m"], dim=1)
    want = (acc & 1) ^ k["crc_c0"]
    return torch.all(want == hdr[:, 32:48].to(torch.int32), dim=1)


def _field(hdr: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The LSB-first integer in header bits [lo, hi), int32."""
    p2 = _consts(hdr.device)["p2"][: hi - lo]
    return torch.sum(hdr[:, lo:hi].to(torch.int32) * p2, dim=1,
                     dtype=torch.int32)


# =============================================================================
# Stages
# =============================================================================


def _descramble(bits: torch.Tensor, prev7: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Feedforward self-sync descrambler out_i = b_i ^ b_{i-4} ^ b_{i-7}
    over the last axis (TDesc741, scramble.hpp).  prev7: (B, 7) register
    prehistory (zeros if None)."""
    if prev7 is None:
        prev7 = bits.new_zeros(bits.shape[:-1] + (7,))
    bp = torch.cat([prev7.to(bits.dtype), bits], dim=-1)
    return bp[..., 7:] ^ bp[..., 3:-4] ^ bp[..., :-7]


def barker_correlate(x: torch.Tensor) -> torch.Tensor:
    """The Barker correlation of every chip offset, (B, N - 10)."""
    return df.correlate_stream(x, _BARKER)


def synchronize(x: torch.Tensor, search: int = 2300):
    """Packet onset + chip-phase timing: find the first energy burst, then
    Barker-correlate and fold the magnitudes modulo 11 over the ``search``
    chips after it (the TEnergyDetect -> TSymTiming peak-tracking chain,
    cca.hpp:13 + symtiming.hpp:177, over all phases at once).  Locking to
    the first burst lets a frame sit anywhere in a window.

    Returns (corr (B, nsym_tot) symbol correlations anchored at the sync,
    t0 (B,) int32 chip offset of the first sync symbol, c the full
    correlation)."""
    return synchronize_from_corr(x, barker_correlate(x), search)


def synchronize_from_corr(x: torch.Tensor, c: torch.Tensor,
                          search: int = 2300):
    """Back half of :func:`synchronize` given the Barker correlation c."""
    Bsz = x.shape[0]
    n = c.shape[-1]
    # first-burst onset: 128-chip moving energy, earliest >= 50% of peak
    en = df.moving_sum(torch.abs(x[:, :n]) ** 2, 128)
    onset = _first_true(en >= 0.5 * en.max(dim=-1, keepdim=True).values)
    onset = torch.clamp(onset, max=max(0, n - search))
    hn = min(search, n) - min(search, n) % 11
    # the slice start clamps into the row, as lax.dynamic_slice does
    start = onset.clamp(0, n - hn)
    idx = start[:, None] + torch.arange(hn, device=x.device)
    head = torch.abs(c.gather(1, idx))
    folds = head.reshape(Bsz, -1, 11).sum(dim=1)
    t0 = (onset + torch.argmax(folds, dim=1)).to(torch.int32)
    # corr[k] = c[t0 + 11 k] of c zero-padded by span (start clamped to n)
    nsym_tot = (n - 10) // 11
    sidx = (t0.to(torch.int64).clamp(0, n)[:, None]
            + 11 * torch.arange(nsym_tot, device=x.device))
    return _take(c, sidx), t0, c


def detect_only(x: torch.Tensor):
    """Cheap DSSS carrier sense for the live node's gating pass — the
    TEnergyDetect + TBarkerSync front half (cca.hpp:13, symtiming.hpp:12)
    without the symbol-timing/PLCP machinery.

    Barker-correlate the chip stream and fold |corr|^2 modulo the 11-chip
    symbol period: during a real preamble one fold phase concentrates the
    energy (det -> ~11), over noise all phases are equal (det -> ~1).
    Returns (det (B,) float32, power (B,) float32, the peak 64-chip mean
    power).  x: (B, N) complex64 chips at 11 Msps.
    """
    c = torch.abs(barker_correlate(x)) ** 2
    n = c.shape[-1] - c.shape[-1] % 11
    folds = c[:, :n].reshape(x.shape[0], -1, 11).sum(dim=1)    # (B, 11)
    det = 11.0 * folds.max(dim=-1).values / (folds.sum(dim=-1) + 1e-9)
    en = df.moving_sum(torch.abs(x) ** 2, 64)
    return det, en.max(dim=-1).values * (1.0 / 64.0)


def _dbpsk_bits(corr: torch.Tensor) -> torch.Tensor:
    """Differential BPSK over successive Barker correlations; the first
    symbol (no reference) is taken as a sync one."""
    d = corr[:, 1:] * torch.conj(corr[:, :-1])
    bits = (d.real < 0).to(torch.uint8)
    return torch.cat([bits.new_ones(bits.shape[0], 1), bits], dim=-1)


def _find_pattern(desc: torch.Tensor, pat: torch.Tensor, sync_bit: int):
    """First offset where the descrambled 1 Mbps stream matches the 16-bit
    pattern and the 8 preceding bits all equal ``sync_bit`` (1 = the long
    SYNC's scrambled ones, 0 = the short SYNC's zeros) — the TSFDSync
    analogue (sfd_sync.hpp:12-134).  The XOR distance of every offset is
    an integer count; the sync-prefix guard rejects garbage bits decoded
    before the true sync that alias the pattern.  Returns (pos (B,) int32,
    found (B,) bool)."""
    lim = min(_SFD_LIMIT, desc.shape[1] - 15)
    w = desc[:, : lim + 15].unfold(1, 16, 1)                  # (B, lim, 16)
    hit = torch.sum(w != pat, dim=-1) == 0
    # ones_before[t] = ones in desc[t-8 .. t-1] (0 before t = 8)
    sum8 = desc.to(torch.int32).unfold(1, 8, 1).sum(dim=-1)
    ones_before = torch.cat([sum8.new_zeros(sum8.shape[0], 8), sum8],
                            dim=1)[:, :lim]
    hit = hit & (ones_before == 8 * sync_bit)
    return _first_true(hit).to(torch.int32), hit.any(dim=1)


def find_sfd(desc: torch.Tensor):
    """Long-preamble SFD (preceded by descrambled ones)."""
    return _find_pattern(desc, _consts(desc.device)["sfd"], 1)


def _dqpsk_demap(d: torch.Tensor) -> torch.Tensor:
    """Differential QPSK: (B, S) phase differences -> (B, S, 2) bits."""
    q = torch.remainder(torch.round(torch.angle(d) / _HALF_PI).to(
        torch.int64), 4)
    return _consts(d.device)["demap"][q]


def _gather_clip(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[b, clip(idx)] — JAX's clipped take_along_axis."""
    return v.gather(1, idx.to(torch.int64).clamp(0, v.shape[1] - 1))


def parse_plcp_short(corr: torch.Tensor, bits: torch.Tensor,
                     desc: torch.Tensor):
    """Short-preamble PLCP (Clause 18.2.5; preamble_type 1 of
    PHY_11b.hpp:26): the reversed SFD follows descrambled zeros, and the
    48 header bits ride 24 DQPSK symbols at 2 Mbps.

    corr: (B, nsym) symbol correlations; bits: raw 1 Mbps decisions;
    desc: their descramble.  Returns dict with found/signal/service/
    length_us/crc_ok/data_sym0/prev7 (raw-bit descrambler prehistory for
    the data section)."""
    Bsz = bits.shape[0]
    dev = bits.device
    pos, found = _find_pattern(desc, _consts(dev)["sfd_s"], 0)
    hs = pos + 16                                  # first header symbol
    cs = _gather_clip(corr, hs[:, None] - 1 + torch.arange(25, device=dev))
    raw = _dqpsk_demap(cs[:, 1:] * torch.conj(cs[:, :-1])).reshape(Bsz, 48)
    prev7h = _gather_clip(bits, hs[:, None] - 7
                          + torch.arange(7, device=dev))
    hdr = _descramble(raw, prev7h)
    return {"found": found, "signal": _field(hdr, 0, 8),
            "service": _field(hdr, 8, 16), "length_us": _field(hdr, 16, 32),
            "crc_ok": _crc16_check(hdr), "data_sym0": hs + 24,
            "prev7": raw[:, -7:]}


def parse_plcp(desc: torch.Tensor, pos: torch.Tensor):
    """Extract + check the 48-bit PLCP header after the SFD at ``pos``.

    Returns dict with signal, length_us, service, crc_ok and hdr_start,
    each (B,)."""
    hdr_start = pos + 16
    hdr = _gather_clip(desc, hdr_start[:, None]
                       + torch.arange(48, device=desc.device))
    return {"signal": _field(hdr, 0, 8), "service": _field(hdr, 8, 16),
            "length_us": _field(hdr, 16, 32), "crc_ok": _crc16_check(hdr),
            "hdr_start": hdr_start}


def _parse_plcp_both(corr: torch.Tensor, bits: torch.Tensor,
                     desc: torch.Tensor):
    """Auto-detected long/short PLCP parse: run both locators and select
    per frame — the runtime preamble_type dispatch (PHY_11b.hpp:26).
    Returns the merged header dict plus data_sym0 (first data symbol),
    prev7 (raw-bit descrambler prehistory), preamble (0 long, 1 short)."""
    pos_l, found_l = find_sfd(desc)
    pl = parse_plcp(desc, pos_l)
    sp = parse_plcp_short(corr, bits, desc)
    use_s = sp["found"] & ~found_l
    hdr_end_l = pl["hdr_start"] + 48
    prev7_l = _gather_clip(bits, hdr_end_l[:, None] - 7
                           + torch.arange(7, device=bits.device))
    sel = lambda key, l_val: torch.where(use_s, sp[key], l_val)
    return {"found": found_l | sp["found"],
            "signal": sel("signal", pl["signal"]),
            "service": sel("service", pl["service"]),
            "length_us": sel("length_us", pl["length_us"]),
            "crc_ok": sel("crc_ok", pl["crc_ok"]),
            "data_sym0": sel("data_sym0", hdr_end_l),
            "prev7": torch.where(use_s[:, None], sp["prev7"], prev7_l),
            "preamble": use_s.to(torch.uint8)}


def _data_nbits(rate_mbps: float, length_us: torch.Tensor,
                service: torch.Tensor) -> torch.Tensor:
    if rate_mbps == 5.5:
        nbits = torch.div(11 * length_us, 2, rounding_mode="floor")
    else:
        nbits = int(rate_mbps) * length_us
    if rate_mbps == 11:
        nbits = nbits - torch.where((service & 0x80) != 0, 8, 0).to(
            nbits.dtype)
    return nbits


def _decode_psk(c: torch.Tensor, data_chip0: torch.Tensor, nsym: int,
                rate_mbps: float):
    """1/2 Mbps data: the symbol correlations at the data chips (one
    reference symbol + nsym), differential demod (TDBPSKDemap /
    TDQPSKDemap, barkerspread.hpp:314).  The JAX package slices them from
    c padded by 11 in front and the span behind, its start clamped."""
    n = c.shape[-1]
    st = data_chip0.to(torch.int64).clamp(0, n + 11)       # in padded coords
    pidx = st[:, None] + 11 * torch.arange(nsym + 1, device=c.device)
    # padded position p holds c[p - 11] (zero before 0 and past n)
    cs = torch.where(pidx >= 11, _take(c, (pidx - 11).clamp(min=0)),
                     torch.zeros((), dtype=c.dtype, device=c.device))
    d = cs[:, 1:] * torch.conj(cs[:, :-1])
    if rate_mbps == 1:
        return (d.real < 0).to(torch.uint8)
    return _dqpsk_demap(d).reshape(c.shape[0], -1)


def _decode_cck(x: torch.Tensor, c: torch.Tensor, data_chip0: torch.Tensor,
                nsym: int, rate_mbps: float):
    """CCK 5.5/11: correlator bank over the codebook (one complex64 matmul
    — TCCK5P5Decoder/TCCK11Decoder, cck.hpp:210,784), winner argmax,
    differential phi1 recovered lag-1-parallel from the winning scores."""
    k = _consts(x.device)
    bookc = k["book55"] if rate_mbps == 5.5 else k["book11"]   # (8, ncw)
    nbps = 4 if rate_mbps == 5.5 else 8
    N = x.shape[-1]
    st = data_chip0.to(torch.int64).clamp(0, N)
    idx = st[:, None] + torch.arange(8 * nsym, device=x.device)
    sym = _take(x, idx).reshape(x.shape[0], nsym, 8)
    sc = torch.matmul(sym, bookc)                              # (B, nsym, ncw)
    iw = torch.argmax(torch.abs(sc), dim=2)                    # (B, nsym)
    phi = torch.angle(sc.gather(2, iw[:, :, None])[:, :, 0])
    # reference phase: the last PLCP Barker symbol correlation
    ref = _gather_clip(c, (data_chip0 - 11)[:, None])[:, 0]
    prev = torch.cat([torch.angle(ref)[:, None], phi[:, :-1]], dim=1)
    odd = (torch.arange(nsym, device=x.device) % 2) * math.pi
    qd = torch.remainder(torch.round((phi - prev - odd) / _HALF_PI).to(
        torch.int64), 4)
    d01 = k["demap"][qd]                                       # (B, nsym, 2)
    cw_bits = torch.stack([(iw >> b) & 1 for b in range(nbps - 2)], dim=2)
    bits = torch.cat([d01, cw_bits.to(torch.uint8)], dim=2)
    return bits.reshape(x.shape[0], nsym * nbps)


def _decode_data(x, c, data_chip0, max_bits: int, rate_mbps: float):
    """The raw (scrambled) data bits of one rate, (B, max_bits)."""
    if rate_mbps in (1, 2):
        nsym = max_bits if rate_mbps == 1 else max_bits // 2
        return _decode_psk(c, data_chip0, nsym, rate_mbps)
    nbps = 4 if rate_mbps == 5.5 else 8
    return _decode_cck(x, c, data_chip0, max_bits // nbps, rate_mbps)


def _frame_tail(raw: torch.Tensor, prev7: torch.Tensor, nbytes: torch.Tensor,
                max_psdu: int):
    """Descramble, pack the PSDU bytes LSB-first, check the FCS.  Returns
    (psdu (B, max_psdu) uint8, fcs_ok (B,) bool)."""
    Bsz = raw.shape[0]
    data = _descramble(raw, prev7)
    p2 = _consts(raw.device)["p2"][:8]
    psdu = torch.sum(data.reshape(Bsz, max_psdu, 8).to(torch.int32) * p2,
                     dim=2).to(torch.uint8)
    nb = nbytes.to(torch.int64)
    body_crc = dcrc.crc32_batch(psdu, torch.clamp(nb - 4, min=0))
    fb = _gather_clip(psdu, nb[:, None] - 4
                      + torch.arange(4, device=raw.device)).to(torch.int64)
    rx_fcs = fb[:, 0] | (fb[:, 1] << 8) | (fb[:, 2] << 16) | (fb[:, 3] << 24)
    return psdu, (body_crc == rx_fcs) & (nb >= 4)


# =============================================================================
# Full pipelines
# =============================================================================


def _plcp_front(x: torch.Tensor, c: torch.Tensor):
    corr, t0, c = synchronize_from_corr(x, c)
    bits = _dbpsk_bits(corr)                     # 1 Mbps raw bits
    return t0, c, bits, _parse_plcp_both(corr, bits, _descramble(bits))


def rx_pipeline(x: torch.Tensor, rate_mbps: float, max_psdu: int = 256):
    """Complete batched 802.11b RX at a configured data rate: the PLCP
    always decodes at 1 Mbps (2 Mbps for the short header), the data at
    ``rate_mbps``, and a frame whose SIGNAL disagrees is flagged not ok.

    x: (B, N) complex64 chips at 11 Msps.  Returns dict with psdu
    (B, max_psdu) uint8, ok/fcs_ok/plcp_ok/sig_rate_ok (B,) uint8, length
    (B,) int32 bytes, signal, length_us, t0, data_chip0 (B,) int32 and
    preamble (B,) uint8.
    """
    t0, c, _, plcp = _plcp_front(x, barker_correlate(x))
    sig_rate_ok = plcp["signal"] == B.SIGNAL_BYTE[rate_mbps]
    nbits = _data_nbits(rate_mbps, plcp["length_us"], plcp["service"])
    nbytes = torch.clamp(torch.div(nbits, 8, rounding_mode="floor"), 0,
                         max_psdu).to(torch.int32)
    data_chip0 = t0 + 11 * plcp["data_sym0"]
    raw = _decode_data(x, c, data_chip0, max_psdu * 8, rate_mbps)
    psdu, fcs_ok = _frame_tail(raw, plcp["prev7"], nbytes, max_psdu)
    plcp_ok = plcp["found"] & plcp["crc_ok"]
    ok = plcp_ok & sig_rate_ok & fcs_ok
    u8 = lambda v: v.to(torch.uint8)
    return {"psdu": psdu, "ok": u8(ok), "fcs_ok": u8(fcs_ok),
            "plcp_ok": u8(plcp_ok), "sig_rate_ok": u8(sig_rate_ok),
            "length": nbytes, "signal": plcp["signal"],
            "length_us": plcp["length_us"], "t0": t0,
            "preamble": plcp["preamble"],
            # chip position of the first data chip: a stable frame anchor
            # for cross-window dedup in the live node
            "data_chip0": data_chip0.to(torch.int32)}


def rx_pipeline_auto(x: torch.Tensor, max_psdu: int = 256):
    """Complete batched 802.11b RX with per-frame runtime rate dispatch: a
    batch mixing all four DSSS rates decodes in one pass with no host
    round trip (the reference demuxes per frame through TBB11bRxRateSel,
    PHY_11b.hpp:378-463).  The data section decodes under all four rates,
    each frame's raw stream is selected by its parsed SIGNAL byte, then
    descramble, byte packing and the FCS run once.

    x: (B, N) complex64 chips at 11 Msps.  Returns the :func:`rx_pipeline`
    dict (without sig_rate_ok) plus rate_mbps (B,) float32.
    """
    return auto_tail(x, barker_correlate(x), max_psdu)


def auto_tail(x: torch.Tensor, c: torch.Tensor, max_psdu: int = 256):
    """Mixed-rate decode from the precomputed Barker correlation — the
    shared back half of :func:`rx_pipeline_auto`."""
    k = _consts(x.device)
    Bsz = x.shape[0]
    t0, c, _, plcp = _plcp_front(x, c)
    signal = plcp["signal"]
    data_chip0 = t0 + 11 * plcp["data_sym0"]
    max_bits = max_psdu * 8
    raws = torch.stack([_decode_data(x, c, data_chip0, max_bits, r)
                        for r in RATES], dim=1)             # (B, 4, max_bits)
    nbits_r = torch.stack([_data_nbits(r, plcp["length_us"],
                                       plcp["service"]) for r in RATES],
                          dim=1)                            # (B, 4)
    onehot = signal[:, None] == k["signal"]                 # (B, 4)
    known = onehot.any(dim=1)
    ridx = _first_true(onehot)
    # the JAX package sums the four streams times the one-hot: the known
    # rate's stream, or zeros
    raw = torch.where(known[:, None], raws.gather(
        1, ridx[:, None, None].expand(Bsz, 1, max_bits))[:, 0], 0).to(
            torch.uint8)
    nbits = torch.where(known, nbits_r.gather(1, ridx[:, None])[:, 0], 0)
    nbytes = torch.clamp(torch.div(nbits, 8, rounding_mode="floor"), 0,
                         max_psdu).to(torch.int32)
    mbps = torch.where(known, k["mbps"][ridx], 0.0)
    psdu, fcs_ok = _frame_tail(raw, plcp["prev7"], nbytes, max_psdu)
    plcp_ok = plcp["found"] & plcp["crc_ok"]
    ok = plcp_ok & known & fcs_ok
    u8 = lambda v: v.to(torch.uint8)
    return {"psdu": psdu, "ok": u8(ok), "fcs_ok": u8(fcs_ok),
            "plcp_ok": u8(plcp_ok), "rate_mbps": mbps, "length": nbytes,
            "signal": signal, "length_us": plcp["length_us"], "t0": t0,
            "preamble": plcp["preamble"],
            "data_chip0": data_chip0.to(torch.int32)}


def rx_plcp(x: torch.Tensor, max_psdu: int = 256):
    """PLCP-only pass (rate-independent): signal/length/preamble and the
    PLCP check, so a host dispatcher can pick the data-rate pipeline — the
    TBB11bRxRateSel two-phase analogue.  ``max_psdu`` is unused (kept for
    the JAX package's signature)."""
    _, _, _, plcp = _plcp_front(x, barker_correlate(x))
    return {"signal": plcp["signal"], "length_us": plcp["length_us"],
            "preamble": plcp["preamble"],
            "plcp_ok": (plcp["found"] & plcp["crc_ok"]).to(torch.uint8)}


# =============================================================================
# Host-facing single-frame API (mirrors golden/dot11b_np.demodulate)
# =============================================================================


@dataclass
class RxResult:
    ok: bool = False
    reason: str = "no_frame"
    rate_mbps: float = 0.0
    length_us: int = 0
    psdu: bytes = b""
    fcs_ok: bool = False


def demodulate(x, max_psdu: int = 2048, device=None) -> RxResult:
    """Decode one frame from a host chip-rate stream, dispatching the data
    rate from the parsed SIGNAL field.  Runs on ``device`` (default cuda;
    raises without CUDA unless ``device="cpu"``)."""
    res = RxResult()
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    xd = device_complex(x.astype(np.complex64), device)
    # minimum span: the short PLCP (56 sync + 16 SFD + 24 header symbols)
    # plus a little data
    if x.shape[1] < 11 * (B.SYNC_BITS_SHORT + 16 + 24 + 8):
        return res
    head = fetch(rx_plcp(xd, max_psdu=max_psdu))
    if not bool(head["plcp_ok"][0]):
        res.reason = "plcp_header_fail"
        return res
    sig = int(head["signal"][0])
    if sig not in B.RATE_BY_SIGNAL:
        res.reason = "bad_signal"
        return res
    rate = B.RATE_BY_SIGNAL[sig]
    res.rate_mbps = rate
    res.length_us = int(head["length_us"][0])
    out = fetch(rx_pipeline(xd, rate, max_psdu=max_psdu))
    n = int(out["length"][0])
    res.psdu = bytes(out["psdu"][0][:n])
    res.fcs_ok = bool(out["fcs_ok"][0])
    res.ok = bool(out["ok"][0])
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    return res
