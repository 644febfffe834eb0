"""The port's mixed-rate, multi-frame 802.11a receiver (sora_tpu_torch,
CPU) against the JAX package's: synchronize_multi, detect_only,
auto_soft/auto_tail and rx_pipeline_auto.

Batches mirror tests/test_jax_dot11a.py: an 8-rate batch, several frames
per stream, candidate compaction, mixed SNR, noise and the
``min_rate_mbps`` cap.  Frames come from the golden numpy modulator and
noise from a numpy seed.  Bits, bytes, flags and integer positions must
be equal.  On the CPU the JAX chain decodes with its float Viterbi and
the port with the radix-4 kernel's plain version (test_torch_dot11a.py),
so decoded bytes are compared on rows that decode (``ok``); empty
candidates hold garbage bits that the two decoders need not share.
Float fields: det within 1e-4 (a ratio of fp32 moving sums), cfo within
1e-5 rad/sample, snr_db within 0.05 dB.  ``lax.top_k`` and
``torch.topk`` may order equal dets differently, so compacted rows are
compared as a set keyed by ``src``.
"""

import numpy as np
import pytest
import torch

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.mac import frame as jfr
from sora_tpu.phy.dot11a import rx as jrx
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

RATES = [6, 9, 12, 18, 24, 36, 48, 54]
CLOSE = {"det": 1e-4, "cfo": 1e-5, "snr_db": 0.05}
ROW_EXACT = ["ok", "fcs_ok", "sig_ok", "cs_ok", "rate_mbps", "length",
             "lts1", "truncated"]


def _frames(rng, rates, size):
    psdus = [jfr.build_data_frame(bytes(rng.integers(
        0, 256, size, dtype=np.uint8)), seq=i) for i in range(len(rates))]
    return psdus, [golden.modulate(p, r).astype(np.complex64)
                   for p, r in zip(psdus, rates)]


def _noise(rng, shape, sigma):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * sigma).astype(np.complex64)


def _run(x, **kw):
    want = {k: np.asarray(v) for k, v in
            jrx.rx_pipeline_auto(x, **kw).items()}
    got = fetch(trx.rx_pipeline_auto(torch.from_numpy(x), **kw))
    return want, got


def _assert_rows_equal(got, want, rows=None):
    """Exact fields on every row, psdu on the rows that decode, floats
    within their tolerances."""
    rows = slice(None) if rows is None else rows
    assert sorted(got) == sorted(want)
    for key in ROW_EXACT:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key][rows], want[key][rows],
                                      err_msg=key)
    ok = want["ok"][rows].astype(bool)
    np.testing.assert_array_equal(got["psdu"][rows][ok],
                                  want["psdu"][rows][ok])
    for key, tol in CLOSE.items():
        np.testing.assert_allclose(got[key][rows], want[key][rows], rtol=0,
                                   atol=tol, err_msg=key)


# ---- synchronize_multi and its onset suppression ---------------------------


@pytest.mark.parametrize("span", [1, 5, 240])
def test_prior_hits_matches_loop(span):
    rng = np.random.default_rng(span)
    hit = rng.random((3, 700)) < 0.1
    got = trx._prior_hits(torch.from_numpy(hit), span).numpy()
    want = np.array([[hit[b, max(0, t - span): t].sum() for t in range(700)]
                     for b in range(3)])
    np.testing.assert_array_equal(got, want)


# onset steps of 160-sample short-training bursts, six per row: 320 (one
# merged onset: the hits of a burst reach within 240 samples of the
# next), 417-422 (the last hit of a burst and the next burst's first hit
# cross the 240-sample suppression here: the onsets split at 420), and
# 600 (six onsets)
STEPS = [320, 417, 418, 419, 420, 421, 422, 600]


@pytest.fixture(scope="module")
def onset_batch():
    """One row of short-training bursts per entry of STEPS, then a row of
    noise only."""
    rng = np.random.default_rng(320)
    sts = np.asarray(jrx.C.PREAMBLE_TIME, np.complex64)[:160]
    x = np.zeros((len(STEPS) + 1, 4096), np.complex64)
    for row, step in enumerate(STEPS):
        for k in range(6):
            o = 100 + step * k
            x[row, o: o + 160] += sts[: max(0, min(160, 4096 - o))]
    x += _noise(rng, x.shape, 0.02)
    x[-1] = _noise(rng, (4096,), 0.7)
    return x


@pytest.mark.parametrize("n_frames", [3, 8])
def test_synchronize_multi_matches_jax(onset_batch, n_frames):
    want = [np.asarray(v) for v in jrx.synchronize_multi(onset_batch,
                                                         n_frames)]
    got = fetch(trx.synchronize_multi(torch.from_numpy(onset_batch),
                                      n_frames))
    assert [g.dtype for g in got] == [w.dtype for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=CLOSE["cfo"])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=CLOSE["det"])
    onsets = (got[2].reshape(-1, n_frames) > 0).sum(axis=1)
    assert onsets[0] == onsets[1] == 1 and onsets[-1] == 0
    assert onsets[-2] == min(6, n_frames) and onsets[5] > 1


def test_synchronize_multi_threshold_matches_jax(onset_batch):
    want = [np.asarray(v) for v in jrx.synchronize_multi(onset_batch, 4,
                                                         0.9)]
    got = fetch(trx.synchronize_multi(torch.from_numpy(onset_batch), 4,
                                      det_threshold=0.9))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=CLOSE["det"])


def test_detect_only_matches_jax(onset_batch):
    want = [np.asarray(v) for v in jrx.detect_only(onset_batch)]
    got = fetch(trx.detect_only(torch.from_numpy(onset_batch)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=CLOSE["det"])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)
    assert got[1].dtype == np.float32


# ---- the 8-rate batch --------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    rng = np.random.default_rng(8)
    psdus, waves = _frames(rng, RATES, 70)
    x = np.zeros((8, max(len(w) for w in waves) + 256), np.complex64)
    for i, w in enumerate(waves):
        x[i, 40 + 13 * i: 40 + 13 * i + len(w)] = w
    x += _noise(rng, x.shape, 0.02)
    return x, psdus


def test_rx_pipeline_auto_8_rates_matches_jax(mixed):
    x, psdus = mixed
    want, got = _run(x, max_psdu=256)
    _assert_rows_equal(got, want)
    assert got["ok"].all() and got["rate_mbps"].tolist() == RATES
    for i, p in enumerate(psdus):
        assert got["psdu"][i, : len(p)].tobytes() == p


def test_auto_soft_equals_one_hot_matmuls(mixed):
    """The port's per-row gather equals the JAX package's eight one-hot
    einsums (auto_tail, rx.py:705-714) applied in numpy, exactly."""
    x, _ = mixed
    nsym_cap = (x.shape[1] - 208) // 80
    mats, nsyms, ndbps, nsym_max, t_max = jrx._auto_tables(256, nsym_cap)
    lts1, cfo, _ = jrx.synchronize(x)
    eq, _, wgt = [np.asarray(v) for v in jrx.extract_symbols(
        x, lts1, cfo, nsym_max, return_weights=True)]
    rb, length, _ = [np.asarray(v) for v in jrx.decode_signal(eq[:, 0])]
    length = np.clip(length, 0, 256).astype(np.int32)
    rate_idx = jrx._BITS_TO_IDX[rb]
    data = np.array(eq[:, 1:])
    soft_cat = np.concatenate(
        [fetch(trx.dmap.demap_soft(torch.from_numpy(data), m))
         for m in trx._MOD_ORDER], -1)
    soft_cat = soft_cat * np.concatenate(
        [np.repeat(wgt, trx._MOD_NBPSC[m], -1) for m in trx._MOD_ORDER],
        -1)[:, None, :]
    nsym_act = -(-(22 + 8 * length) // ndbps[rate_idx])
    soft_cat = np.where(np.arange(nsym_max)[None, :, None]
                        < nsym_act[:, None, None], soft_cat, 0.0)
    want = np.zeros((len(x), t_max, 2), np.float32)
    for ri, P in enumerate(mats):
        sel = soft_cat[:, : nsyms[ri]] * (rate_idx == ri)[:, None, None]
        ab = np.einsum("bsj,jk->bsk", sel, P).reshape(len(x), -1, 2)
        want[:, : ab.shape[1]] += ab
    got = trx.auto_soft(torch.from_numpy(data), torch.from_numpy(length),
                        torch.from_numpy(rate_idx.astype(np.int64)), 256,
                        nsym_cap, torch.from_numpy(wgt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_auto_tail_matches_jax(mixed):
    """The back half alone, from the JAX package's equalized carriers."""
    x, _ = mixed
    nsym_cap = (x.shape[1] - 208) // 80
    nsym_max = jrx._auto_tables(256, nsym_cap)[3]
    lts1, cfo, det = jrx.synchronize(x)
    eq, _, wgt = jrx.extract_symbols(x, lts1, cfo, nsym_max,
                                     return_weights=True)
    want = {k: np.asarray(v) for k, v in jrx.auto_tail(
        eq, det, 256, nsym_cap, lts1=lts1, n_samples=x.shape[1],
        weights=wgt).items()}
    t = lambda v: torch.from_numpy(np.array(v))
    got = fetch(trx.auto_tail(t(eq), t(det), 256, nsym_cap, lts1=t(lts1),
                              n_samples=x.shape[1], weights=t(wgt)))
    assert sorted(got) == sorted(want)
    for key in ("psdu", "ok", "fcs_ok", "sig_ok", "cs_ok", "rate_mbps",
                "length", "truncated", "det"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---- several frames per stream, compaction, SNR, noise, the rate cap -------


@pytest.fixture(scope="module")
def multi():
    """Stream 0: one 54 Mbps frame; stream 2: a 12 and a 6 Mbps frame 70
    samples apart; streams 1 and 3: noise."""
    rng = np.random.default_rng(4)
    psdus, waves = _frames(rng, [54, 12, 6], 40)
    x = np.zeros((4, 8192), np.complex64)
    x[0, 30: 30 + len(waves[0])] = waves[0]
    x[2, 100: 100 + len(waves[1])] = waves[1]
    off2 = 100 + len(waves[1]) + 70
    x[2, off2: off2 + len(waves[2])] = waves[2]
    x += _noise(rng, x.shape, 0.02)
    return x, psdus


def test_rx_pipeline_auto_n_frames_matches_jax(multi):
    x, psdus = multi
    want, got = _run(x, max_psdu=256, n_frames=4)
    assert got["n_cand"].dtype == np.int32 and got["n_cand"].shape == ()
    assert int(got["n_cand"]) == int(want["n_cand"]) == 3
    _assert_rows_equal({k: v for k, v in got.items() if k != "n_cand"},
                       {k: v for k, v in want.items() if k != "n_cand"})
    ok = got["ok"].astype(bool)
    assert ok.sum() == 3 and got["rate_mbps"][ok].tolist() == [54, 12, 6]
    for p, k in zip(psdus, np.flatnonzero(ok)):
        assert got["psdu"][k, : len(p)].tobytes() == p


def test_rx_pipeline_auto_compaction_matches_jax_as_a_set(multi):
    x, psdus = multi
    want, got = _run(x, max_psdu=256, n_frames=4, n_decode=8)
    assert len(got["ok"]) == 8 and got["src"].dtype == np.int32
    assert int(got["n_cand"]) == int(want["n_cand"])

    def keyed(out):
        live = out["det"] > 0
        return {int(s): i for i, s in enumerate(out["src"]) if live[i]}

    kg, kw = keyed(got), keyed(want)
    assert sorted(kg) == sorted(kw) == [0, 8, 9]
    order_g = np.array([kg[s] for s in sorted(kg)])
    order_w = np.array([kw[s] for s in sorted(kw)])
    _assert_rows_equal({k: v[order_g] for k, v in got.items()
                        if k != "n_cand"},
                       {k: v[order_w] for k, v in want.items()
                        if k != "n_cand"})
    assert got["ok"][order_g].all()
    decoded = {int(got["src"][i]): got["psdu"][i, : len(p)].tobytes()
               for i, p in zip(order_g, psdus)}
    assert decoded == {0: psdus[0], 8: psdus[1], 9: psdus[2]}


def test_rx_pipeline_auto_mixed_snr_matches_jax():
    rng = np.random.default_rng(3)
    psdus, (strong, weak) = _frames(rng, [6, 6], 40)
    sigma = np.sqrt(float(np.mean(np.abs(weak) ** 2)) / (2.0 * 10 ** 0.4))
    x = np.zeros((1, 8192), np.complex64)
    x[0, 30: 30 + len(strong)] = strong * np.sqrt(10.0)
    off = 30 + len(strong) + 80
    x[0, off: off + len(weak)] = weak
    x += _noise(rng, x.shape, sigma)
    want, got = _run(x, max_psdu=256, n_frames=3)
    _assert_rows_equal({k: v for k, v in got.items() if k != "n_cand"},
                       {k: v for k, v in want.items() if k != "n_cand"})
    assert got["ok"][0] and got["ok"][1] and got["det"][1] < 0.75
    for i in (0, 1):
        assert got["psdu"][i, : len(psdus[i])].tobytes() == psdus[i]


def test_rx_pipeline_auto_rejects_noise():
    rng = np.random.default_rng(9)
    x = _noise(rng, (2, 4096), 1.0)
    want, got = _run(x, max_psdu=256)
    assert not got["ok"].any() and not got["cs_ok"].any()
    np.testing.assert_array_equal(got["cs_ok"], want["cs_ok"])
    np.testing.assert_allclose(got["det"], want["det"], rtol=0,
                               atol=CLOSE["det"])


def test_rx_pipeline_auto_min_rate_cap_matches_jax():
    """With min_rate_mbps=54 the symbol tables hold a 54 Mbps frame of
    max_psdu bytes: the long 6 Mbps frame runs past them and fails while
    the short one and the 54 Mbps frames decode."""
    rng = np.random.default_rng(54)
    rates = [54, 6, 6, 54]
    sizes = [300, 300, 0, 100]      # 28, 328, 28 and 128-byte PSDUs
    psdus = [jfr.build_data_frame(bytes(rng.integers(0, 256, n,
                                                     dtype=np.uint8)), seq=i)
             for i, n in enumerate(sizes)]
    waves = [golden.modulate(p, r).astype(np.complex64)
             for p, r in zip(psdus, rates)]
    x = np.zeros((4, max(len(w) for w in waves) + 200), np.complex64)
    for i, w in enumerate(waves):
        x[i, 60: 60 + len(w)] = w
    x += _noise(rng, x.shape, 0.02)
    want, got = _run(x, max_psdu=400, min_rate_mbps=54)
    _assert_rows_equal(got, want)
    assert got["ok"].tolist() == [1, 0, 1, 1]
