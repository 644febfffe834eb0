"""How ``correct`` is decided: what the timed calls returned, held to the
frames that were sent and to the plain reference's estimates.

For every row of a judged batch:

* exact, against the frame sent: ``ok``, ``fcs_ok``, ``sig_ok``,
  ``cs_ok``, ``truncated``, ``length``, the rate or MCS and the PSDU bytes
  within the length; against the reference: ``lts1``.  Any difference
  counts one row in ``wrong`` (limit 0).  On the air layout also every
  detected candidate (``src`` with ``det`` at or over the threshold) must
  be one the reference detects and the reverse, ``n_cand`` must equal the
  reference's count, a candidate whose frame lies wholly in the window
  must be ``ok``, one whose frame the window cuts must be ``truncated``
  (it may still decode when only samples of its last symbol are
  missing), every ``ok`` row must hold its frame's exact fields, and no
  row without a frame (no candidate, or none sent there) may be ``ok``;
* widest gaps to the reference's float64 estimates: ``det_gap``,
  ``cfo_gap`` (rad/sample, wrapped) and ``snr_db_gap`` (dB), each against
  a limit set from the program's readings over many seeds and the
  control's (``benchmark/limits/<workload>.json``).

:func:`control` is the reference put in the program's place, computed in
a lower precision (TF32 products, or bfloat16 throughout): the runs the
limits must reject.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ofdm as R

DELTA = 1e-4          # relative threshold perturbation for onset ties
BLOCK = 256           # rows per reference block


def _fixed_estimates(x, phy, prec, det=None, delta=DELTA):
    """Reference estimates of one frame per stream, (B, A, N) -> dict of
    (B,) tensors det, cfo, lts1, snr_db."""
    x = x.to(prec.cplx)
    N = x.shape[-1]
    w, en, m = R.sts_metric(x, prec)
    limit = max(1, N - phy.SYNC["back"])
    lo, hi = R.onsets(en, m, limit, delta)
    plus = phy.SYNC["plus"]
    lo = (lo + plus).clamp(max=limit - 1)
    hi = (hi + plus).clamp(max=limit - 1)
    t = R.pick(lo, hi, m, det)
    cfo = prec.q(torch.angle(w.gather(1, t[:, None])[:, 0]) / 16.0)
    lts1 = R.lts_lock(x, t, cfo, phy.SYNC["width"], True, prec)
    return {"det": m.gather(1, t[:, None])[:, 0], "cfo": cfo, "lts1": lts1,
            "snr_db": R.lts_snr(x, lts1, cfo, prec)}


def fixed_estimates(x, phy, prec, det=None, delta=DELTA) -> dict:
    """:func:`_fixed_estimates` in blocks of rows, as numpy."""
    parts = []
    for s in range(0, x.shape[0], BLOCK):
        d = None if det is None else torch.as_tensor(
            det[s: s + BLOCK], device=x.device)
        parts.append({k: v.cpu().numpy() for k, v in _fixed_estimates(
            x[s: s + BLOCK], phy, prec, d, delta).items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))) \
        if len(b) else 0.0


def _cfo_gap(a, b) -> float:
    if not len(b):
        return 0.0
    d = np.asarray(a, np.float64) - b
    return float(np.max(np.abs((d + np.pi) % (2 * np.pi) - np.pi)))


def _psdu_wrong(out_psdu, expect: np.ndarray, lengths) -> np.ndarray:
    """Rows whose PSDU differs from ``expect`` within its length."""
    n = expect.shape[1]
    got = out_psdu[:, :n]
    if got.shape[1] < n:
        return np.ones(len(expect), bool)
    inside = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return ((got != expect) & inside).any(axis=1)


def _pool_matrix(psdus) -> np.ndarray:
    n = max(len(p) for p in psdus)
    m = np.zeros((len(psdus), n), np.uint8)
    for i, p in enumerate(psdus):
        m[i, : len(p)] = p
    return m


def judge_streams(out, batch, traffic, phy, prec=R.FLOAT64) -> dict:
    """The numbers of one batch of the streams layout.  Fields that a
    receiver does not return (the sharded one returns psdu, ok, fcs_ok,
    length and snr_db) are not compared; a batch whose outputs do not
    hold one row per stream counts every stream wrong."""
    fidx = batch.truth["fidx"]
    B = len(fidx)
    if any(np.shape(v)[:1] != (B,) for v in out.values() if np.ndim(v)):
        return {"wrong": B, "rows": B, "ambiguous": 0}
    fmt = np.array(traffic.formats)[fidx]
    rate, length = fmt[:, 0], fmt[:, 1]
    est = fixed_estimates(batch.x, phy, prec, out.get("det"))
    bad = _psdu_wrong(out["psdu"], _pool_matrix(traffic.psdus)[fidx],
                      length)
    bad |= out["length"] != length
    expect = {"ok": 1, "fcs_ok": 1, "sig_ok": 1, "cs_ok": 1,
              "truncated": 0, phy.RATE_FIELD: rate, "lts1": est["lts1"]}
    for k, v in expect.items():
        if k in out:
            bad |= out[k] != v
    got = {"wrong": int(bad.sum()), "rows": B, "ambiguous": 0,
           "snr_db_gap": _gap(out["snr_db"], est["snr_db"])}
    if "det" in out:
        got["det_gap"] = _gap(out["det"], est["det"])
    if "cfo" in out:
        got["cfo_gap"] = _cfo_gap(out["cfo"], est["cfo"])
    return got


def _air_candidates(x, phy, K, thr, delta, prec=R.FLOAT64):
    """The reference detector over (B, 1, W) windows: (lo, hi, count,
    ambiguous) as tensors, with the metric for :func:`_air_rows`."""
    x = x.to(prec.cplx)
    w, en, m = R.sts_metric(x, prec)
    limit = max(1, x.shape[-1] - phy.SYNC["back"])
    return (w, m) + R.multi_onsets(en, m, limit, thr, K, delta)


def _air_rows(x, w, m, b, t, phy, prec):
    """Estimates of candidates at onset t of windows b."""
    xr = x[b].to(prec.cplx)
    wr, mr = w[b], m[b]
    cfo = prec.q(torch.angle(wr.gather(1, t[:, None])[:, 0]) / 16.0)
    lts1 = R.lts_lock(xr, t, cfo.to(prec.real), phy.SYNC["width"], False,
                      prec)
    return {"det": mr.gather(1, t[:, None])[:, 0], "cfo": cfo, "lts1": lts1,
            "snr_db": R.lts_snr(xr, lts1, cfo, prec)}


def _air_truth(batch, traffic, b, lts1):
    """For candidates in windows b at lts1: (frame index or -1, whether
    the frame lies wholly inside the window)."""
    tr = batch.truth
    at = {int(s) + 192: j for j, s in enumerate(tr["starts"])}
    win = batch.x.shape[-1]
    j = np.array([at.get(int(tr["wstart"][bb]) + int(t), -1)
                  for bb, t in zip(b, lts1)], np.int64)
    rel = tr["starts"][np.maximum(j, 0)] - tr["wstart"][b]
    fits = (j >= 0) & (rel + tr["lengths"][np.maximum(j, 0)] <= win)
    return j, fits


def judge_air(out, batch, traffic, phy, K: int, thr: float,
              prec=R.FLOAT64) -> dict:
    """The numbers of one batch of the air layout (multi-frame detection
    with the candidates compacted by ``det``)."""
    x = batch.x
    w, m, lo, hi, count, amb = _air_candidates(x, phy, K, thr, DELTA)
    count, amb = count.cpu().numpy(), amb.cpu().numpy()
    det = np.asarray(out["det"])
    # without compaction every candidate row comes, candidate-major
    src = np.asarray(out.get("src", np.arange(len(det))), np.int64)
    cand = det >= thr
    b_all, k_all = src // K, src % K
    in_ref = k_all < count[b_all]
    wrong = int((cand & ~in_ref & ~amb[b_all]).sum())
    prog_set = {int(s) for s in src[cand]}
    for bb in np.flatnonzero(~amb):
        wrong += sum(1 for k in range(count[bb])
                     if bb * K + k not in prog_set)
    if not amb.any():
        wrong += int(int(out["n_cand"]) != int(count.sum()))
    wrong += int((out["ok"][~cand] != 0).sum())
    sel = np.flatnonzero(cand & in_ref & ~amb[b_all])
    res = {"rows": int(len(sel)), "ambiguous": int(amb.sum())}
    if not len(sel):
        return {"wrong": wrong, "det_gap": 0.0, "cfo_gap": 0.0,
                "snr_db_gap": 0.0, **res}
    b, k = b_all[sel], k_all[sel]
    bt = torch.as_tensor(b, device=x.device)
    kt = torch.as_tensor(k, device=x.device)
    t = R.pick(lo[bt, kt], hi[bt, kt], m[bt],
               torch.as_tensor(det[sel], device=x.device))
    est = {kk: v.cpu().numpy()
           for kk, v in _air_rows(x, w, m, bt, t, phy, prec).items()}
    wrong += _air_exact(out, sel, b, est["lts1"], batch, traffic, phy)
    return {"wrong": wrong,
            "det_gap": _gap(det[sel], est["det"]),
            "cfo_gap": _cfo_gap(out["cfo"][sel], est["cfo"]),
            "snr_db_gap": _gap(out["snr_db"][sel], est["snr_db"]), **res}


def _air_exact(out, sel, b, lts1, batch, traffic, phy) -> int:
    """Rows of ``sel`` whose exact fields differ from the frame sent."""
    j, fits = _air_truth(batch, traffic, b, lts1)
    fidx = batch.truth["fidx"][np.maximum(j, 0)]
    fmt = np.array(traffic.formats)[fidx]
    ok = out["ok"][sel] == 1
    bad = out["lts1"][sel] != lts1
    # a frame wholly inside decodes; a cut one is flagged and may still
    # decode (a few samples of its last symbol missing), then rightly
    bad |= fits & ~ok
    bad |= (j < 0) & ok
    bad |= (j >= 0) & (out["truncated"][sel] != ~fits)
    f = np.flatnonzero(ok & (j >= 0))
    sub = sel[f]
    fb = np.zeros(len(sel), bool)
    fb[f] = _psdu_wrong(out["psdu"][sub],
                        _pool_matrix(traffic.psdus)[fidx[f]], fmt[f, 1])
    fb[f] |= out["length"][sub] != fmt[f, 1]
    fb[f] |= out[phy.RATE_FIELD][sub] != fmt[f, 0]
    fb[f] |= (out["fcs_ok"][sub] != 1) | (out["sig_ok"][sub] != 1)
    return int((bad | fb).sum())


def judge(out, batch, traffic, phy, mix, prec=R.FLOAT64) -> dict:
    """The numbers of one judged batch, by the mix's layout."""
    if mix["layout"] == "air":
        kw = mix["entry"]["kwargs"]
        return judge_air(out, batch, traffic, phy, kw["n_frames"],
                         kw.get("det_threshold", phy.CS_THRESHOLD), prec)
    return judge_streams(out, batch, traffic, phy, prec)


def control(batch, traffic, phy, mix, prec=R.TF32) -> dict:
    """The reference in the program's place: its estimates in ``prec``,
    every exact field as the frame sent (what a sound receiver returns).
    The same keys as the program's output."""
    if mix["layout"] == "air":
        return _air_control(batch, traffic, phy, mix, prec)
    fidx = batch.truth["fidx"]
    fmt = np.array(traffic.formats)[fidx]
    est = fixed_estimates(batch.x, phy, prec, None, 0.0)
    B = len(fidx)
    one = np.ones(B, np.uint8)
    return {"psdu": _pool_matrix(traffic.psdus)[fidx], "ok": one,
            "fcs_ok": one, "sig_ok": one, "cs_ok": one,
            "truncated": 0 * one, "length": fmt[:, 1].astype(np.int32),
            phy.RATE_FIELD: fmt[:, 0].astype(np.int32),
            "det": est["det"].astype(np.float32),
            "cfo": est["cfo"].astype(np.float32),
            "lts1": est["lts1"].astype(np.int32),
            "snr_db": est["snr_db"].astype(np.float32)}


def _air_control(batch, traffic, phy, mix, prec) -> dict:
    kw = mix["entry"]["kwargs"]
    K, n_decode = kw["n_frames"], kw["n_decode"]
    thr = kw.get("det_threshold", phy.CS_THRESHOLD)
    x = batch.x
    w, m, lo, hi, count, amb = _air_candidates(x, phy, K, thr, 0.0, prec)
    count = count.cpu().numpy()
    b = np.repeat(np.arange(len(count)), count)
    k = np.concatenate([np.arange(c) for c in count]) if len(b) else b
    bt = torch.as_tensor(b, device=x.device)
    t = lo[bt, torch.as_tensor(k, device=x.device)]
    est = {kk: v.cpu().numpy()
           for kk, v in _air_rows(x, w, m, bt, t, phy, prec).items()}
    j, fits = _air_truth(batch, traffic, b, est["lts1"])
    fidx = batch.truth["fidx"][np.maximum(j, 0)]
    fmt = np.array(traffic.formats)[fidx]
    psdu = _pool_matrix(traffic.psdus)[fidx]
    R_ = max(min(n_decode, len(count) * K), len(b))
    pad = R_ - len(b)
    z = lambda v, dt: np.concatenate([np.asarray(v).astype(dt),
                                      np.zeros(pad, dt)])
    taken = set((b * K + k).tolist())
    filler = [s for s in range(len(count) * K) if s not in taken][:pad]
    return {"src": np.concatenate([b * K + k, filler]).astype(np.int32),
            "det": z(est["det"], np.float32), "cfo": z(est["cfo"],
                                                       np.float32),
            "lts1": z(est["lts1"], np.int32),
            "snr_db": z(est["snr_db"], np.float32),
            "ok": z(fits, np.uint8), "truncated": z((j >= 0) & ~fits,
                                                    np.uint8),
            "fcs_ok": z(fits, np.uint8), "sig_ok": z(fits, np.uint8),
            "cs_ok": z(np.ones(len(b)), np.uint8),
            "length": z(fmt[:, 1], np.int32),
            phy.RATE_FIELD: z(fmt[:, 0], np.int32),
            "psdu": np.concatenate([psdu, np.zeros((pad, psdu.shape[1]),
                                                   np.uint8)]),
            "n_cand": np.int32(len(b))}
