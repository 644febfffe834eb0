"""The port's 802.11b transmitter, PLCP helpers, receiver stages and the
fixed-rate receiver (sora_tpu_torch.phy.dot11b, CPU) against the JAX
package's (sora_tpu.phy.dot11b, run as JAX on the CPU) and the golden
numpy model.  The scenarios are those of tests/test_jax_dot11b.py.

TX.  The port accumulates each differential phase as an integer count of
quarter turns and looks its phasor up in {1, j, -1, -j}: it is held to the
float64 golden model within 1e-5 (at 1000- and 2048-byte frames).  The
JAX TX accumulates a float32 phase, which drifts from the golden model
with the frame's length (1.2e-3 at 1000 bytes, 3.3e-3 at 2048 bytes,
1 Mbps); the port is held to JAX within JAX's own drift from the golden
model, measured in the test, plus 1e-5.

RX.  Every exact field is equal: psdu (within length), ok, fcs_ok,
plcp_ok, sig_rate_ok, length, signal, length_us, t0, preamble,
data_chip0 — the bytes of every row, except a frame read at the wrong
static rate, whose CCK scores are garbage and sit on near-ties.
``detect_only``'s det and power agree within 1e-5 relative (fp32 sums of
|corr|^2 taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sora_tpu.golden import dot11b_np as golden
from sora_tpu.mac import frame as jfr
from sora_tpu.phy import dot11b_common as JB
from sora_tpu.phy.dot11b import rx as jrx
from sora_tpu.phy.dot11b import tx as jtx
from sora_tpu_torch.phy.dot11b import preamble as P
from sora_tpu_torch.phy.dot11b import rx as trx
from sora_tpu_torch.phy.dot11b import tx as ttx

torch.set_num_threads(2)

RATES = [1, 2, 5.5, 11]
GOLDEN_ATOL = 1e-5
JAX_SLACK = 1e-5         # on top of the JAX TX's own drift from golden
DET_RTOL = 1e-5
EXACT = ("ok", "fcs_ok", "plcp_ok", "sig_rate_ok", "length", "signal",
         "length_us", "t0", "preamble", "data_chip0", "rate_mbps")


def _frames(rng, n, payload_len):
    return [jfr.build_data_frame(bytes(rng.integers(0, 256, payload_len,
                                                    dtype=np.uint8)), seq=i)
            for i in range(n)]


def _noisy(x, rng, sigma=0.02):
    return (x + (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
            .astype(np.complex64) * sigma).astype(np.complex64)


def assert_equal_outputs(got: dict, want: dict, byte_rows=None):
    """Every exact field equal, dtypes included; PSDU bytes within each
    row's length (of the rows ``byte_rows``, default all)."""
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for key in EXACT:
        if key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for i, n in enumerate(want["length"]):
        if byte_rows is None or i in byte_rows:
            np.testing.assert_array_equal(got["psdu"][i, :n],
                                          want["psdu"][i, :n],
                                          err_msg=f"psdu row {i}")


# -- PLCP helpers and the scrambler ------------------------------------------


def test_scrambler_impulse_response_equals_jax():
    np.testing.assert_array_equal(ttx._impulse_response_period(),
                                  jtx._impulse_response_period())


@pytest.mark.parametrize("seed", [0x6C, 0x00, 0x7F, 0x35])
def test_scramble_tx_matches_golden_and_jax(rng, seed):
    bits = rng.integers(0, 2, (3, 400)).astype(np.uint8)
    got = ttx.scramble_tx(torch.from_numpy(bits), seed).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jtx.scramble_tx(jnp.asarray(bits), seed)))
    for i in range(3):
        np.testing.assert_array_equal(got[i], JB.scramble_11b(bits[i], seed))


@pytest.mark.parametrize("rate", RATES)
def test_plcp_helpers_equal_golden(rng, rate):
    for n in (14, 100, 1000, 2048):
        np.testing.assert_array_equal(P.plcp_header_bits(rate, n),
                                      golden.plcp_header_bits(rate, n))
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    for q0 in range(4):
        want = golden._dbpsk_phases(bits, q0 * np.pi / 2)
        got = P._dbpsk_quarters(bits, q0) * np.pi / 2
        np.testing.assert_allclose(np.exp(1j * got), np.exp(1j * want),
                                   atol=1e-9)
        di = bits.reshape(-1, 2)
        want = golden._dqpsk_phases(di, q0 * np.pi / 2)
        got = P._dqpsk_quarters(di, q0) * np.pi / 2
        np.testing.assert_allclose(np.exp(1j * got), np.exp(1j * want),
                                   atol=1e-9)
    prev = rng.integers(0, 2, 20).astype(np.uint8)
    np.testing.assert_array_equal(P._scramble_continue(prev, bits),
                                  golden._scramble_continue(prev, bits))


@pytest.mark.parametrize("rate,preamble", [(r, "long") for r in RATES]
                         + [(r, "short") for r in RATES[1:]])
def test_plcp_const_equals_jax(rate, preamble):
    chips, q0, seed = ttx._plcp_const(rate, 100, preamble)
    jchips, phi0, jseed = jtx._plcp_const(rate, 100, preamble)
    assert chips.dtype == jchips.dtype and chips.shape == jchips.shape
    np.testing.assert_allclose(chips, jchips, rtol=0, atol=1e-6)
    assert np.exp(1j * q0 * np.pi / 2) == pytest.approx(np.exp(1j * phi0))
    assert seed == jseed


# -- TX ----------------------------------------------------------------------


def _tx_check(arr, rate, preamble="long"):
    got = ttx.modulate(torch.from_numpy(arr), rate, arr.shape[1],
                       preamble=preamble).numpy()
    want = np.asarray(jtx.modulate(jnp.asarray(arr), rate, arr.shape[1],
                                   preamble=preamble))
    ref = np.stack([golden.modulate(a.tobytes(), rate, preamble=preamble)
                    for a in arr])
    assert got.dtype == np.complex64 and got.shape == want.shape == ref.shape
    assert got.shape[1] == ttx.waveform_len(rate, arr.shape[1], preamble)
    np.testing.assert_allclose(got, ref, rtol=0, atol=GOLDEN_ATOL)
    jax_drift = float(np.abs(want - ref).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=jax_drift + JAX_SLACK)
    return jax_drift


@pytest.mark.parametrize("rate,preamble", [(r, "long") for r in RATES]
                         + [(r, "short") for r in RATES[1:]])
def test_modulate_1000_bytes_matches_golden_and_jax(rate, preamble):
    rng = np.random.default_rng(int(rate * 10))
    arr = np.stack([np.frombuffer(p, np.uint8) for p in _frames(rng, 2, 972)])
    drift = _tx_check(arr, rate, preamble)
    assert drift > 10 * GOLDEN_ATOL         # the JAX TX's float32 phase drift


def test_modulate_2048_bytes_1mbps_matches_golden():
    rng = np.random.default_rng(2048)
    arr = np.stack([np.frombuffer(p, np.uint8)
                    for p in _frames(rng, 2, 2048 - 28)])
    assert _tx_check(arr, 1) > 2e-3


def test_modulate_rejects_short_1mbps_and_unknown_rate():
    arr = torch.zeros(1, 20, dtype=torch.uint8)
    with pytest.raises(ValueError, match="short preamble"):
        ttx.modulate(arr, 1, 20, preamble="short")
    with pytest.raises(ValueError):
        ttx.modulate(arr, 6, 20)


def test_waveform_len_equals_jax():
    for rate in RATES:
        for n in (14, 88, 1000, 2048):
            for pre in ("long", "short"):
                assert (ttx.waveform_len(rate, n, pre)
                        == jtx.waveform_len(rate, n, pre))


# -- receiver stages ---------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_batch():
    """Four 64-byte frames, one per rate, long preamble, plus noise."""
    rng = np.random.default_rng(7)
    psdus = _frames(rng, 4, 36)
    plen = len(psdus[0])
    N = max(ttx.waveform_len(r, plen) for r in RATES) + 300
    x = np.zeros((4, N), np.complex64)
    for i, (p, rate) in enumerate(zip(psdus, RATES)):
        w = golden.modulate(p, rate).astype(np.complex64)
        x[i, 40 + 5 * i: 40 + 5 * i + len(w)] = w
    return psdus, _noisy(x, rng)


def test_synchronize_equals_jax(mixed_batch):
    _, x = mixed_batch
    corr, t0, c = trx.synchronize(torch.from_numpy(x))
    jcorr, jt0, jc = jrx.synchronize(jnp.asarray(x))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    assert t0.dtype == torch.int32
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(corr.numpy(), np.asarray(jcorr), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["frames", "noise"])
def test_detect_only_equals_jax(mixed_batch, kind):
    x = mixed_batch[1]
    if kind == "noise":
        x = _noisy(np.zeros((3, 6000), np.complex64), np.random.default_rng(3),
                   0.05)
    det, power = trx.detect_only(torch.from_numpy(x))
    jdet, jpower = jrx.detect_only(jnp.asarray(x))
    assert det.dtype == power.dtype == torch.float32
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=DET_RTOL)
    np.testing.assert_allclose(power.numpy(), np.asarray(jpower),
                               rtol=DET_RTOL)
    if kind == "frames":
        assert (det.numpy() > 3.0).all()
    else:
        assert (det.numpy() < 1.7).all()


def test_crc16_and_descramble_equal_jax(rng):
    hdr = np.stack([golden.plcp_header_bits(r, n) for r in RATES
                    for n in (20, 300, 1500)])
    bad = hdr.copy()
    bad[::2, rng.integers(0, 48, len(bad[::2]))] ^= 1
    for h in (hdr, bad):
        got = trx._crc16_check(torch.from_numpy(h)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jrx._crc16_check(jnp.asarray(h))))
    assert trx._crc16_check(torch.from_numpy(hdr)).all()
    bits = rng.integers(0, 2, (3, 200)).astype(np.uint8)
    prev = rng.integers(0, 2, (3, 7)).astype(np.uint8)
    for p in (None, prev):
        got = trx._descramble(torch.from_numpy(bits), None if p is None
                              else torch.from_numpy(p)).numpy()
        want = np.asarray(jrx._descramble(jnp.asarray(bits), None if p is None
                                          else jnp.asarray(p)))
        np.testing.assert_array_equal(got, want)


def test_plcp_parse_equals_jax(mixed_batch):
    _, x = mixed_batch
    corr, _, _ = trx.synchronize(torch.from_numpy(x))
    jcorr, _, _ = jrx.synchronize(jnp.asarray(x))
    bits = trx._dbpsk_bits(corr)
    jbits = jrx._dbpsk_bits(jcorr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    desc, jdesc = trx._descramble(bits), jrx._descramble(jbits)
    for (pos, found), (jpos, jfound) in (
            (trx.find_sfd(desc), jrx.find_sfd(jdesc)),):
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        assert found.all()
    got = trx._parse_plcp_both(corr, bits, desc)
    want = jrx._parse_plcp_both(jcorr, jbits, jdesc)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["crc_ok"].all()


# -- the fixed-rate receiver -------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
def test_rx_pipeline_loopback_equals_jax(rng, rate):
    psdus = _frames(rng, 4, 36)
    plen = len(psdus[0])
    x = np.zeros((4, ttx.waveform_len(rate, plen) + 300), np.complex64)
    for i, p in enumerate(psdus):
        w = golden.modulate(p, rate).astype(np.complex64)
        x[i, 40 + 3 * i: 40 + 3 * i + len(w)] = w
    x = _noisy(x, rng)
    got = trx.rx_pipeline(torch.from_numpy(x), rate, max_psdu=plen)
    assert_equal_outputs(got, jrx.rx_pipeline(jnp.asarray(x), rate,
                                              max_psdu=plen))
    assert got["ok"].all()
    for i, p in enumerate(psdus):
        assert bytes(got["psdu"][i].numpy()) == p


def test_rx_wrong_static_rate_flagged_equals_jax():
    psdu = jfr.build_data_frame(b"rate mismatch", seq=1)
    w = golden.modulate(psdu, 2).astype(np.complex64)
    x = np.concatenate([np.zeros(30, np.complex64), w])[None, :]
    got = trx.rx_pipeline(torch.from_numpy(x), 11, max_psdu=64)
    # a 2 Mbps frame read through the CCK-11 bank: every score is garbage
    # and the argmax sits on near-ties, so its bytes are not compared
    assert_equal_outputs(got, jrx.rx_pipeline(jnp.asarray(x), 11,
                                              max_psdu=64), byte_rows=())
    assert not got["ok"][0] and not got["sig_rate_ok"][0]
    assert got["plcp_ok"][0]                  # the header still parses


@pytest.mark.parametrize("rate", [2, 5.5, 11])
def test_rx_pipeline_short_preamble_equals_jax(rng, rate):
    psdu = _frames(rng, 1, 40)[0]
    w = golden.modulate(psdu, rate, preamble="short").astype(np.complex64)
    x = np.zeros((1, len(w) + 400), np.complex64)
    x[0, 60: 60 + len(w)] = w
    x = _noisy(x, rng)
    got = trx.rx_pipeline(torch.from_numpy(x), rate, max_psdu=len(psdu))
    assert_equal_outputs(got, jrx.rx_pipeline(jnp.asarray(x), rate,
                                              max_psdu=len(psdu)))
    assert got["ok"][0] and got["preamble"][0] == 1


def test_rx_plcp_equals_jax(mixed_batch):
    _, x = mixed_batch
    got = trx.rx_plcp(torch.from_numpy(x))
    want = jrx.rx_plcp(jnp.asarray(x))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got["signal"].numpy(),
                                  [JB.SIGNAL_BYTE[r] for r in RATES])


@pytest.mark.parametrize("rate,preamble", [(r, "long") for r in RATES]
                         + [(5.5, "short")])
def test_demodulate_equals_jax(rate, preamble):
    psdu = jfr.build_data_frame(b"hello 11b world", seq=9)
    w = golden.modulate(psdu, rate, preamble=preamble)
    x = np.concatenate([np.zeros(50), w, np.zeros(100)]).astype(np.complex64)
    got = trx.demodulate(x, max_psdu=64, device="cpu")
    assert vars(got) == vars(jrx.demodulate(x, max_psdu=64))
    assert got.ok and got.rate_mbps == rate and got.psdu == psdu


def test_demodulate_noise_and_short_input_equal_jax(rng):
    x = (rng.normal(size=4000) + 1j * rng.normal(size=4000)).astype(
        np.complex64)
    got = trx.demodulate(x, max_psdu=64, device="cpu")
    assert vars(got) == vars(jrx.demodulate(x, max_psdu=64))
    assert not got.ok and got.reason in ("plcp_header_fail", "bad_signal",
                                         "crc32_fail")
    short = x[:500]
    assert vars(trx.demodulate(short, device="cpu")) == vars(
        jrx.demodulate(short))
