"""The port's mixed-MCS 802.11n receivers (rx_pipeline_auto with min_mcs,
auto_tail, rx_pipeline_auto_1ss; sora_tpu_torch, CPU) against the JAX
chain.

The JAX package applies its per-MCS one-hot tables as eight matmuls whose
results it sums; the port gathers each row's trellis input through its
own MCS's table.  Every trellis slot has at most one source, so the
tables must be equal and the decodes equal in bits, bytes, flags, MCS,
length and lts1; float outputs agree within the stated tolerances.
Frames come from the golden model through random channels, from a numpy
seed, as in tests/test_jax_dot11n.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sora_tpu.golden import dot11n_np as golden
from sora_tpu.phy.dot11n import rx as jrx
from sora_tpu_torch.phy.dot11n import rx as trx
from sora_tpu_torch.util.xfer import fetch

from test_torch_dot11n import (_assert_equal_outputs, _chan_2x1, _chan_2x2,
                               _host, _psdu)

torch.set_num_threads(2)


def _mixed(seed, mcss, nbytes, pad=300, noise=0.01):
    """One frame per MCS, row i at offset 40 + 7 i, each through its own
    channel, plus noise: (x (len(mcss), 2, N), psdus)."""
    rng = np.random.default_rng(seed)
    psdus, ys = [], []
    for i, mcs in enumerate(mcss):
        p = _psdu(rng, nbytes + 4 * i, i)
        psdus.append(p)
        ch = _chan_2x1(rng) if mcs < 8 else _chan_2x2(rng)
        ys.append(ch @ golden.modulate(p, mcs))
    N = max(y.shape[1] for y in ys) + pad
    x = np.zeros((len(mcss), 2, N), np.complex64)
    for i, y in enumerate(ys):
        x[i, :, 40 + 7 * i: 40 + 7 * i + y.shape[1]] = y
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * noise
    return x, psdus


@pytest.mark.parametrize("max_psdu, nsym_cap",
                         [(256, 1 << 30), (1504, 232), (1504, 41)])
def test_auto_tables_equal(max_psdu, nsym_cap):
    for name in ("_auto_tables_n", "_auto_tables_1ss"):
        got = getattr(trx, name)(max_psdu, nsym_cap)
        want = getattr(jrx, name)(max_psdu, nsym_cap)
        assert len(got[0]) == len(want[0]) == 8
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        assert got[1] == want[1] and got[3:] == want[3:]
        np.testing.assert_array_equal(got[2], want[2])


def test_auto_gather_reproduces_one_hot_tables():
    """Each row's gather through its MCS table equals the JAX package's
    sum of the eight one-hot products (computed here in numpy)."""
    rng = np.random.default_rng(3)
    mats, nsyms, _, nsym_max, t_max = trx._auto_tables_n(256, 1 << 30)
    k = trx._auto_gather_n(False, 256, 1 << 30, torch.device("cpu"))
    soft = rng.normal(size=(8, nsym_max, 1352)).astype(np.float32)
    for r in range(8):
        want = np.zeros((t_max * 2,), np.float32)
        ab = (soft[r, : nsyms[r]] @ mats[r]).reshape(-1)
        want[: ab.size] = ab
        src = k["src"][r].numpy()
        got = np.where(k["sent"][r].numpy(), soft[r].reshape(-1)[src], 0.0)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mixed_2x2():
    return _mixed(11, list(range(8, 16)), 40)


def test_rx_pipeline_auto_matches_jax(mixed_2x2):
    x, psdus = mixed_2x2
    want = _host(jrx.rx_pipeline_auto(jnp.asarray(x), max_psdu=256))
    got = fetch(trx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=256))
    _assert_equal_outputs(got, want)
    assert got["ok"].all() and got["mcs"].tolist() == list(range(8, 16))
    for i, p in enumerate(psdus):
        assert bytes(got["psdu"][i][: len(p)]) == p


def test_rx_pipeline_auto_min_mcs_matches_jax(mixed_2x2):
    """min_mcs caps the tables at that MCS's airtime: the slow frames
    that run past the cap fail, equally in both."""
    x, _ = mixed_2x2
    want = _host(jrx.rx_pipeline_auto(jnp.asarray(x), max_psdu=256,
                                      min_mcs=13))
    got = fetch(trx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=256,
                                     min_mcs=13))
    _assert_equal_outputs(got, want)
    assert got["ok"][-3:].all() and not got["ok"][0]


def test_auto_tail_matches_jax(mixed_2x2):
    x, _ = mixed_2x2
    lts1, cfo, det = jrx.synchronize(jnp.asarray(x))
    nsym_win = min((x.shape[-1] - 608) // 80, trx.max_symbols(8, 256))
    nsym_max = trx._auto_tables_n(256, nsym_win)[3]
    sig, xd, _, wgt = jrx.extract_symbols(jnp.asarray(x), lts1, cfo,
                                          nsym_max, return_weights=True)
    for weights in (wgt, None):
        want = _host(jrx.auto_tail(sig, xd, det, 256, nsym_win,
                                   weights=weights))
        got = fetch(trx.auto_tail(
            torch.from_numpy(np.asarray(sig)),
            torch.from_numpy(np.asarray(xd)),
            torch.from_numpy(np.asarray(det)), 256, nsym_win,
            weights=None if weights is None
            else torch.from_numpy(np.asarray(weights))))
        _assert_equal_outputs(got, want, exact=[
            "psdu", "ok", "fcs_ok", "sig_ok", "cs_ok", "mcs", "length"])
        assert got["ok"].all()
    # a raised carrier-sense threshold gates every row
    got = fetch(trx.auto_tail(torch.from_numpy(np.asarray(sig)),
                              torch.from_numpy(np.asarray(xd)),
                              torch.from_numpy(np.asarray(det)), 256,
                              nsym_win, det_threshold=1.01))
    assert not got["ok"].any() and got["sig_ok"].all()


def test_rx_pipeline_auto_1ss_matches_jax():
    x, psdus = _mixed(12, list(range(8)), 52)
    want = _host(jrx.rx_pipeline_auto_1ss(jnp.asarray(x), max_psdu=128))
    got = fetch(trx.rx_pipeline_auto_1ss(torch.from_numpy(x), max_psdu=128))
    _assert_equal_outputs(got, want)
    assert got["ok"].all() and got["mcs"].tolist() == list(range(8))
    for i, p in enumerate(psdus):
        assert bytes(got["psdu"][i][: len(p)]) == p


def test_auto_pipelines_reject_the_other_class_and_sgi():
    """Each auto pipeline rejects the other stream class and short-GI
    frames (the mixed programs decode 800 ns symbols), equally in both."""
    x, _ = _mixed(13, [3, 9, 0, 15], 60)
    rng = np.random.default_rng(14)
    sgi = np.zeros_like(x[:2])
    for i, mcs in enumerate((5, 12)):
        ch = _chan_2x1(rng) if mcs < 8 else _chan_2x2(rng)
        y = ch @ golden.modulate(_psdu(rng, 60, 9), mcs, short_gi=True)
        sgi[i, :, 50: 50 + y.shape[1]] = y[:, : x.shape[-1] - 50]
    x = np.concatenate([x, sgi])
    for jp, tp, want_ok in (
            (jrx.rx_pipeline_auto, trx.rx_pipeline_auto, [0, 1, 0, 1, 0, 0]),
            (jrx.rx_pipeline_auto_1ss, trx.rx_pipeline_auto_1ss,
             [1, 0, 1, 0, 0, 0])):
        want = _host(jp(jnp.asarray(x), max_psdu=128))
        got = fetch(tp(torch.from_numpy(x), max_psdu=128))
        _assert_equal_outputs(got, want)
        assert got["ok"].tolist() == want_ok
