"""The port's 802.11n chain (sora_tpu_torch.phy.dot11n, CPU) against the JAX
chain: the tables, the TX, every stage of the fixed-MCS receivers, the
fixed-MCS pipelines (2x2 MCS 8-15, single-stream MCS 0-7, short GI) and
``demodulate``.

Frames come from the golden model (sora_tpu.golden.dot11n_np) through a
random 2x2 (or 2x1) channel plus noise, all drawn from a numpy seed, as in
tests/test_jax_dot11n.py.  Bits, bytes, flags, MCS, lengths and lts1 must
be equal; float outputs agree within the stated tolerances (fp32 sums and
complex products taken in another order by XLA and PyTorch).

On the CPU the JAX chain decodes HT-SIG and the data with its float
Viterbi, the port with the radix-4 decoder (over one 48-step window for
HT-SIG); at the SNRs here both return the true bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sora_tpu.golden import dot11n_np as golden
from sora_tpu.mac import frame as fr
from sora_tpu.phy.dot11n import rx as jrx
from sora_tpu.phy.dot11n import tx as jtx
from sora_tpu_torch.phy.dot11n import preamble as tpre
from sora_tpu_torch.phy.dot11n import rx as trx
from sora_tpu_torch.phy.dot11n import tx as ttx
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

JAX_ATOL = 1e-6           # the port's TX against the JAX TX (unit power)
GOLDEN_ATOL = 1e-5        # the port's TX against the float64 golden model
EXACT = ["psdu", "ok", "fcs_ok", "sig_ok", "cs_ok", "mcs", "length", "lts1"]
# det is a ratio of fp32 moving sums (1e-4 absolute on a [0, 1] metric),
# cfo an angle / 16 (1e-5 rad/sample), snr_db a log ratio (0.05 dB)
CLOSE = {"det": 1e-4, "cfo": 1e-5, "snr_db": 0.05}
CARRIER_ATOL = 1e-4       # detected carriers of magnitude ~1
WEIGHT_RTOL, WEIGHT_ATOL = 1e-4, 1e-5


def _chan_2x2(rng):
    while True:
        H = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))) \
            / np.sqrt(2.0)
        if abs(np.linalg.det(H)) > 0.3:
            return H


def _chan_2x1(rng):
    while True:
        h = (rng.normal(size=(2, 1)) + 1j * rng.normal(size=(2, 1))
             ) / np.sqrt(2.0)
        if np.abs(h).min() > 0.2:
            return h


def _psdu(rng, nbytes, seq):
    return fr.build_data_frame(bytes(rng.integers(0, 256, nbytes,
                                                  dtype=np.uint8)), seq=seq)


def _batch(seed, mcs, B, nbytes, short_gi=False, noise=0.01, pad=300):
    """B frames of one MCS, each through its own random channel, at
    offsets 40 + 13 i, plus complex Gaussian noise: (x (B, 2, N), psdus)."""
    rng = np.random.default_rng(seed)
    psdus, ys = [], []
    for i in range(B):
        p = _psdu(rng, nbytes, i)
        psdus.append(p)
        ch = _chan_2x1(rng) if mcs < 8 else _chan_2x2(rng)
        ys.append(ch @ golden.modulate(p, mcs, short_gi=short_gi))
    N = max(y.shape[1] for y in ys) + pad
    x = np.zeros((B, 2, N), np.complex64)
    for i, y in enumerate(ys):
        off = 40 + 13 * i
        x[i, :, off: off + y.shape[1]] = y
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * noise
    return x, psdus


def _host(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_equal_outputs(got, want, exact=EXACT):
    """Exact fields on every row, PSDU bytes within the length on the rows
    that decode, floats within their tolerances.  The bytes past a frame's
    length come from the decoder's walk over erased symbols (and every
    byte of a row that fails from its walk over noise): there the JAX
    chain on the CPU runs another Viterbi than the port (ROADMAP queue
    3), so they are not compared."""
    assert sorted(got) == sorted(want)
    for key in exact:
        assert got[key].dtype == want[key].dtype, key
        if key == "psdu":
            assert got[key].shape == want[key].shape
            for i in np.flatnonzero(want["ok"]):
                n = want["length"][i]
                np.testing.assert_array_equal(got[key][i, :n],
                                              want[key][i, :n])
            continue
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, tol in CLOSE.items():
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=tol, err_msg=key)


# ---- tables ----------------------------------------------------------------


def test_crc8_tables_equal():
    np.testing.assert_array_equal(trx._CRC8_MAT, jrx._CRC8_MAT)
    np.testing.assert_array_equal(trx._CRC8_CONST, jrx._CRC8_CONST)


@pytest.mark.parametrize("nsym", [1, 5, 47, 130])
def test_pilot_tables_equal(nsym):
    np.testing.assert_array_equal(ttx._pilot_table(nsym),
                                  jtx._pilot_table(nsym))
    np.testing.assert_array_equal(ttx._pilot_table_1ss(nsym),
                                  jtx._pilot_table_1ss(nsym))


def test_csd_phasor_and_puncture_equal():
    np.testing.assert_array_equal(ttx._csd_phasor(), jtx._csd_phasor())
    for mcs in range(16):
        m = ttx.N.mcs_param(mcs)
        np.testing.assert_array_equal(ttx._puncture_gather(m, 2 * 1560),
                                      jtx._puncture_gather(m, 2 * 1560))
        for plen in (1, 148, 1500):
            assert ttx.num_symbols(mcs, plen) == jtx.num_symbols(mcs, plen)
            for sgi in (False, True):
                assert ttx.waveform_len(mcs, plen, sgi) == \
                    jtx.waveform_len(mcs, plen, sgi)


@pytest.mark.parametrize("mcs", list(range(16)))
def test_preamble_constants_equal(mcs):
    """The float64 preamble of the port's own golden helpers, cast to
    complex64, equals the JAX TX's constant bit for bit."""
    for plen in (60, 1500):
        for sgi in (False, True):
            if mcs < 8:
                got = ttx._preamble_const_1ss(mcs, plen, sgi)
                want = jtx._preamble_const_1ss(mcs, plen, sgi)
            else:
                got = ttx._preamble_const(mcs, plen, sgi)
                want = jtx._preamble_const(mcs, plen, sgi)
            assert got.dtype == want.dtype == np.complex64
            np.testing.assert_array_equal(got, want)


def test_preamble_helpers_equal_golden():
    rng = np.random.default_rng(4)
    bits24 = rng.integers(0, 2, 24).astype(np.uint8)
    np.testing.assert_array_equal(tpre._encode_legacy_symbolbits(bits24),
                                  golden._encode_legacy_symbolbits(bits24))
    for mcs, plen, nsym, nltf in ((3, 100, 12, 1), (15, 1500, 24, 2)):
        np.testing.assert_array_equal(
            tpre._lsig_bits(mcs, plen, nsym, nltf),
            golden._lsig_bits(mcs, plen, nsym, nltf))
    bits48 = rng.integers(0, 2, 48).astype(np.uint8)
    for pol, q in ((0, False), (2, True)):
        f = tpre._legacy_data_freq(bits48, pol, q)
        np.testing.assert_array_equal(f, golden._legacy_data_freq(
            bits48, pol, q))
        for ant in (0, 1):
            np.testing.assert_array_equal(tpre._legacy_symbol(f, ant),
                                          golden._legacy_symbol(f, ant))
        np.testing.assert_array_equal(tpre._leg_sym_1ss(f),
                                      golden._leg_sym_1ss(f))
    for ant in (0, 1):
        np.testing.assert_array_equal(tpre._legacy_preamble(ant),
                                      golden._legacy_preamble(ant))
        for gi in (8, 16):
            ht = tpre.N.HTLTF_FREQ
            np.testing.assert_array_equal(tpre._ht_symbol(ht, ant, gi),
                                          golden._ht_symbol(ht, ant, gi))
            np.testing.assert_array_equal(tpre._ht_sym_1ss(ht, gi),
                                          golden._ht_sym_1ss(ht, gi))
    np.testing.assert_array_equal(tpre._csd_factor(-8, tpre.N.HT_SC_IDX),
                                  golden._csd_factor(-8, tpre.N.HT_SC_IDX))
    np.testing.assert_array_equal(tpre._preamble_1ss(5, 200, 9, True),
                                  golden._preamble_1ss(5, 200, 9, True))


@pytest.mark.parametrize("mcs", list(range(8, 16)))
def test_mcs_symbol_matrix_equal(mcs):
    np.testing.assert_array_equal(trx._mcs_symbol_matrix(mcs),
                                  jrx._mcs_symbol_matrix(mcs))
    np.testing.assert_array_equal(trx._mcs1_symbol_matrix(mcs - 8),
                                  jrx._mcs1_symbol_matrix(mcs - 8))
    for mp in (256, 1504):
        assert trx.max_symbols(mcs, mp) == jrx.max_symbols(mcs, mp)
        assert trx.max_symbols(mcs - 8, mp) == jrx.max_symbols(mcs - 8, mp)


# ---- TX ---------------------------------------------------------------------


@pytest.mark.parametrize("mcs", list(range(16)))
def test_modulate_matches_jax_and_golden(mcs):
    rng = np.random.default_rng(100 + mcs)
    arr = np.stack([np.frombuffer(_psdu(rng, 62, i), np.uint8)
                    for i in range(3)])
    for sgi in (False, True):
        got = ttx.modulate(torch.from_numpy(arr), mcs, arr.shape[1],
                           short_gi=sgi).numpy()
        want = np.asarray(jtx.modulate(jnp.asarray(arr), mcs, arr.shape[1],
                                       short_gi=sgi))
        assert got.dtype == np.complex64 and got.shape == want.shape
        assert got.shape[-1] == ttx.waveform_len(mcs, arr.shape[1], sgi)
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
        np.testing.assert_allclose(
            got[1], golden.modulate(arr[1].tobytes(), mcs, short_gi=sgi),
            rtol=0, atol=GOLDEN_ATOL)


def test_modulate_other_scrambler_seed():
    """The JAX TX traces its seed (it cannot take another one under jit),
    so the port is held to the golden model here."""
    rng = np.random.default_rng(9)
    psdu = _psdu(rng, 40, 0)
    arr = np.frombuffer(psdu, np.uint8)[None].copy()
    for mcs in (2, 13):
        got = ttx.modulate(torch.from_numpy(arr), mcs, arr.shape[1],
                           scrambler_seed=0x21).numpy()
        want = golden.modulate(psdu, mcs, scrambler_seed=0x21)
        np.testing.assert_allclose(got[0], want, rtol=0, atol=GOLDEN_ATOL)
        assert np.abs(got - ttx.modulate(torch.from_numpy(arr), mcs,
                                         arr.shape[1]).numpy()).max() > 0.1


# ---- the 2x2 stages ---------------------------------------------------------

MCS, B, NBYTES, MAX_PSDU = 11, 6, 120, 256


@pytest.fixture(scope="module")
def mimo_batch():
    return _batch(21, MCS, B, NBYTES, noise=0.01)


@pytest.fixture(scope="module")
def mimo_sync(mimo_batch):
    x, _ = mimo_batch
    want = [np.asarray(v) for v in jrx.synchronize(jnp.asarray(x))]
    got = fetch(trx.synchronize(torch.from_numpy(x)))
    return want, got


def test_synchronize_matches_jax(mimo_sync):
    (lts1, cfo, det), (t_lts1, t_cfo, t_det) = mimo_sync
    assert t_lts1.dtype == lts1.dtype
    np.testing.assert_array_equal(t_lts1, lts1)
    np.testing.assert_allclose(t_cfo, cfo, rtol=0, atol=CLOSE["cfo"])
    np.testing.assert_allclose(t_det, det, rtol=0, atol=CLOSE["det"])


@pytest.mark.parametrize("mmse", [True, False])
def test_extract_symbols_matches_jax(mimo_batch, mimo_sync, mmse):
    x, _ = mimo_batch
    (lts1, cfo, _), _ = mimo_sync
    nsym = trx.max_symbols(MCS, MAX_PSDU)
    want = [np.asarray(v) for v in jrx.extract_symbols(
        jnp.asarray(x), jnp.asarray(lts1), jnp.asarray(cfo), nsym, False,
        mmse, return_weights=True)]
    got = fetch(trx.extract_symbols(
        torch.from_numpy(x), torch.from_numpy(lts1), torch.from_numpy(cfo),
        nsym, False, mmse, return_weights=True))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=CARRIER_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=CARRIER_ATOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=CLOSE["snr_db"])
    np.testing.assert_allclose(got[3], want[3], rtol=WEIGHT_RTOL,
                               atol=WEIGHT_ATOL)
    # without weights, and with no data symbols
    three = fetch(trx.extract_symbols(
        torch.from_numpy(x), torch.from_numpy(lts1), torch.from_numpy(cfo),
        0, mmse=mmse))
    assert len(three) == 3 and three[1].shape == (B, 0, 52, 2)
    np.testing.assert_allclose(three[0], want[0], rtol=0, atol=CARRIER_ATOL)


def test_inv2x2_matches_jax():
    rng = np.random.default_rng(5)
    H = (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2))
         ).astype(np.complex64)
    H[0] = [[1, 2], [2, 4]]                      # singular: guarded
    got = trx._inv2x2(torch.from_numpy(H)).numpy()
    want = np.asarray(jrx._inv2x2(jnp.asarray(H)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


@pytest.fixture(scope="module")
def mimo_sig(mimo_batch, mimo_sync):
    x, _ = mimo_batch
    (lts1, cfo, _), _ = mimo_sync
    sig, xd, _, wgt = jrx.extract_symbols(
        jnp.asarray(x), jnp.asarray(lts1), jnp.asarray(cfo),
        trx.max_symbols(MCS, MAX_PSDU), return_weights=True)
    return np.asarray(sig), np.asarray(xd), np.asarray(wgt)


def test_decode_lsig_and_htsig_match_jax(mimo_sig):
    sig, _, _ = mimo_sig
    np.testing.assert_array_equal(
        trx.decode_lsig(torch.from_numpy(sig[:, 0])).numpy(),
        np.asarray(jrx.decode_lsig(jnp.asarray(sig[:, 0]))))
    got = fetch(trx.decode_htsig(torch.from_numpy(sig[:, 1:])))
    want = [np.asarray(v) for v in jrx.decode_htsig(jnp.asarray(sig[:, 1:]))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == MCS).all() and got[2].all()
    assert (got[1] == NBYTES + 28).all()


def test_decode_data_matches_jax(mimo_sig):
    _, xd, wgt = mimo_sig
    length = np.full(B, NBYTES + 28, np.int32)
    for w in (wgt, None):
        want = [np.asarray(v) for v in jrx.decode_data(
            jnp.asarray(xd), jnp.asarray(length), MCS, MAX_PSDU,
            None if w is None else jnp.asarray(w))]
        got = fetch(trx.decode_data(
            torch.from_numpy(xd), torch.from_numpy(length), MCS, MAX_PSDU,
            None if w is None else torch.from_numpy(w)))
        for g, v in zip(got, want):
            assert g.shape == v.shape
            np.testing.assert_array_equal(g, v)
        assert got[1].all()


# ---- the fixed-MCS pipelines ------------------------------------------------


@pytest.mark.parametrize("mcs, mmse, weighted", [
    (8, True, True), (11, False, True), (13, True, False), (15, True, True)])
def test_rx_pipeline_matches_jax(mcs, mmse, weighted):
    x, psdus = _batch(30 + mcs, mcs, 4, 90, noise=0.005)
    want = _host(jrx.rx_pipeline(jnp.asarray(x), mcs, max_psdu=200,
                                 mmse=mmse, weighted=weighted))
    got = fetch(trx.rx_pipeline(torch.from_numpy(x), mcs, max_psdu=200,
                                mmse=mmse, weighted=weighted))
    _assert_equal_outputs(got, want)
    assert got["ok"].all() and got["psdu"].shape == (4, 200)
    for i, p in enumerate(psdus):
        assert bytes(got["psdu"][i][: len(p)]) == p


@pytest.mark.parametrize("mcs", list(range(8)))
def test_rx_pipeline_1ss_matches_jax(mcs):
    x, psdus = _batch(50 + mcs, mcs, 3, 80)
    # a carrier offset on top (90 kHz, as tests/test_jax_dot11n.py)
    x = (x * np.exp(1j * 2 * np.pi * 90e3 / 20e6
                    * np.arange(x.shape[-1]))).astype(np.complex64)
    want = _host(jrx.rx_pipeline_1ss(jnp.asarray(x), mcs, max_psdu=256))
    got = fetch(trx.rx_pipeline_1ss(torch.from_numpy(x), mcs, max_psdu=256))
    _assert_equal_outputs(got, want)
    assert got["ok"].all()
    for i, p in enumerate(psdus):
        assert bytes(got["psdu"][i][: len(p)]) == p


def test_extract_symbols_1ss_matches_jax():
    x, _ = _batch(61, 5, 4, 100)
    lts1, cfo, _ = jrx.synchronize(jnp.asarray(x))
    nsym = trx.max_symbols(5, 256)
    for sgi in (False, True):
        want = [np.asarray(v) for v in jrx.extract_symbols_1ss(
            jnp.asarray(x), lts1, cfo, nsym, sgi, return_weights=True)]
        got = fetch(trx.extract_symbols_1ss(
            torch.from_numpy(x), torch.from_numpy(np.asarray(lts1)),
            torch.from_numpy(np.asarray(cfo)), nsym, sgi,
            return_weights=True))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=CARRIER_ATOL)
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=CARRIER_ATOL)
        np.testing.assert_allclose(got[2], want[2], rtol=0,
                                   atol=CLOSE["snr_db"])
        np.testing.assert_allclose(got[3], want[3], rtol=WEIGHT_RTOL,
                                   atol=WEIGHT_ATOL)
    z = fetch(trx.extract_symbols_1ss(torch.from_numpy(x),
                                      torch.from_numpy(np.asarray(lts1)),
                                      torch.from_numpy(np.asarray(cfo)), 0,
                                      return_weights=True))
    assert z[1].shape == (4, 0, 52) and (z[3] == 1).all()


def test_decode_data_1ss_matches_jax():
    x, _ = _batch(62, 6, 3, 70)
    lts1, cfo, _ = jrx.synchronize(jnp.asarray(x))
    _, xd, _, wgt = jrx.extract_symbols_1ss(
        jnp.asarray(x), lts1, cfo, trx.max_symbols(6, 128),
        return_weights=True)
    length = np.full(3, 98, np.int32)
    want = [np.asarray(v) for v in jrx.decode_data_1ss(
        xd, jnp.asarray(length), 6, 128, wgt)]
    got = fetch(trx.decode_data_1ss(
        torch.from_numpy(np.asarray(xd)), torch.from_numpy(length), 6, 128,
        torch.from_numpy(np.asarray(wgt))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].all()


@pytest.mark.parametrize("mcs", [15, 7])
def test_short_gi_pipelines_match_jax(mcs):
    """Short-GI frames decode through the short_gi pipelines and are
    rejected by the 800 ns ones, equally in both packages."""
    x, psdus = _batch(70 + mcs, mcs, 3, 90, short_gi=True, noise=0.005)
    jpipe = jrx.rx_pipeline if mcs >= 8 else jrx.rx_pipeline_1ss
    tpipe = trx.rx_pipeline if mcs >= 8 else trx.rx_pipeline_1ss
    for sgi in (True, False):
        want = _host(jpipe(jnp.asarray(x), mcs, max_psdu=256, short_gi=sgi))
        got = fetch(tpipe(torch.from_numpy(x), mcs, max_psdu=256,
                          short_gi=sgi))
        _assert_equal_outputs(got, want)
        assert got["ok"].all() == sgi and not (got["ok"].any() and not sgi)
    for i, p in enumerate(psdus):
        res = trx.demodulate(x[i], device="cpu")
        assert res.ok and res.mcs == mcs and res.psdu == p


# ---- demodulate -------------------------------------------------------------


@pytest.mark.parametrize("mcs", [4, 9, 14])
def test_demodulate_matches_jax(mcs):
    x, psdus = _batch(80 + mcs, mcs, 1, 150)
    res = trx.demodulate(x[0], device="cpu")
    jres = jrx.demodulate(x[0])
    assert res.ok and res.reason == "frame_ok" and res.psdu == psdus[0]
    assert (res.mcs, res.length, res.start, res.psdu, res.reason) == (
        jres.mcs, jres.length, jres.start, jres.psdu, jres.reason)
    assert res.cfo == pytest.approx(jres.cfo, abs=CLOSE["cfo"])
    assert res.snr_est_db == pytest.approx(jres.snr_est_db,
                                           abs=CLOSE["snr_db"])
    wrong = trx.demodulate(x[0], expect_mcs=(mcs + 1) % 16, device="cpu")
    assert wrong.reason == "unexpected_mcs" and not wrong.ok


def test_demodulate_reasons_match_jax():
    rng = np.random.default_rng(90)
    # a legacy preamble (L-STF + L-LTF) followed by noise: the carrier is
    # sensed, the L-SIG is noise
    w = golden.modulate(fr.build_data_frame(b"y" * 100, seq=5), 9)
    x = (0.05 * (rng.normal(size=(2, 3000))
                 + 1j * rng.normal(size=(2, 3000)))).astype(np.complex64)
    x[:, 100: 420] += w[:, :320]
    res = trx.demodulate(x, device="cpu")
    assert not res.ok and res.reason == "plcp_header_fail"
    assert res.reason == jrx.demodulate(x).reason
    for seed in range(91, 95):            # noise never decodes
        n = np.random.default_rng(seed).normal(size=(2, 3000, 2))
        xn = (n[..., 0] + 1j * n[..., 1]).astype(np.complex64)
        res = trx.demodulate(xn, device="cpu")
        assert not res.ok and res.reason == jrx.demodulate(xn).reason
    psdu = fr.build_data_frame(b"x" * 200, seq=5)
    y = np.concatenate([np.zeros((2, 80)), golden.modulate(psdu, 8)],
                       axis=1)[:, :1400].astype(np.complex64)
    res = trx.demodulate(y, device="cpu")
    assert not res.ok and res.reason == "truncated"
    assert res.reason == jrx.demodulate(y).reason
    short = np.zeros((2, 600), np.complex64)
    assert trx.demodulate(short, device="cpu").reason == "no_frame"
    assert jrx.demodulate(short).reason == "no_frame"
    idle = np.zeros((2, 3000), np.complex64)
    assert trx.demodulate(idle, device="cpu").reason == \
        jrx.demodulate(idle).reason == "cs_timeout"


def test_port_waveforms_decode_in_both_receivers():
    """Frames modulated by the port (2x2 and single stream) decode to the
    same bytes through the port's and the JAX fixed-MCS receivers."""
    rng = np.random.default_rng(95)
    arr = np.frombuffer(_psdu(rng, 64, 3), np.uint8)[None].copy()
    for mcs in (1, 12):
        w = ttx.modulate(torch.from_numpy(arr), mcs, arr.shape[1]).numpy()[0]
        ch = _chan_2x1(rng) if mcs < 8 else _chan_2x2(rng)
        y = ch @ w
        x = np.zeros((1, 2, y.shape[1] + 300), np.complex64)
        x[0, :, 70: 70 + y.shape[1]] = y
        x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
              ).astype(np.complex64) * 0.01
        jp = jrx.rx_pipeline_1ss if mcs < 8 else jrx.rx_pipeline
        tp = trx.rx_pipeline_1ss if mcs < 8 else trx.rx_pipeline
        want = _host(jp(jnp.asarray(x), mcs, max_psdu=128))
        got = fetch(tp(torch.from_numpy(x), mcs, max_psdu=128))
        _assert_equal_outputs(got, want)
        assert got["ok"][0] and bytes(got["psdu"][0][: arr.shape[1]]) == \
            arr[0].tobytes()
