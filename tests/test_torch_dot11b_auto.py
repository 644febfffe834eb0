"""The port's mixed-rate 802.11b receiver (``rx_pipeline_auto`` and
``auto_tail``, CPU) against the JAX package's, run as JAX on the CPU, on
the scenarios of tests/test_jax_dot11b.py: the four rates in one batch,
long and short preamble mixed, noise rejected, the SFD garbage-prefix
alias at bench.py's 11b width, and frames that lock late, where the JAX
package's slices clamp their start.

Every exact field is equal: psdu (within length), ok, fcs_ok, plcp_ok,
length, signal, length_us, t0, preamble, data_chip0 and rate_mbps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sora_tpu.golden import dot11b_np as golden
from sora_tpu.mac import frame as jfr
from sora_tpu.phy.dot11b import rx as jrx
from sora_tpu_torch.phy.dot11b import rx as trx
from sora_tpu_torch.phy.dot11b import tx as ttx

torch.set_num_threads(2)

RATES = [1, 2, 5.5, 11]
EXACT = ("ok", "fcs_ok", "plcp_ok", "length", "signal", "length_us", "t0",
         "preamble", "data_chip0", "rate_mbps")


def _frames(rng, n, payload_len):
    return [jfr.build_data_frame(bytes(rng.integers(0, 256, payload_len,
                                                    dtype=np.uint8)), seq=i)
            for i in range(n)]


def _noisy(x, rng, sigma=0.02):
    return (x + (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
            .astype(np.complex64) * sigma).astype(np.complex64)


def _auto_both(x, max_psdu):
    """The port's and the JAX package's rx_pipeline_auto on x, every exact
    field compared; returns the port's output as numpy."""
    got = {k: v.numpy() for k, v in trx.rx_pipeline_auto(
        torch.from_numpy(x), max_psdu=max_psdu).items()}
    want = {k: np.asarray(v) for k, v in jrx.rx_pipeline_auto(
        jnp.asarray(x), max_psdu=max_psdu).items()}
    assert sorted(got) == sorted(want)
    for key in EXACT:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for i, n in enumerate(want["length"]):
        np.testing.assert_array_equal(got["psdu"][i, :n], want["psdu"][i, :n],
                                      err_msg=f"psdu row {i}")
    return got


def test_auto_mixed_rates_equals_jax(rng):
    psdus = _frames(rng, 4, 36)
    plen = len(psdus[0])
    x = np.zeros((4, max(ttx.waveform_len(r, plen) for r in RATES) + 300),
                 np.complex64)
    for i, (p, rate) in enumerate(zip(psdus, RATES)):
        w = golden.modulate(p, rate).astype(np.complex64)
        x[i, 40 + 5 * i: 40 + 5 * i + len(w)] = w
    out = _auto_both(_noisy(x, rng), plen)
    assert out["ok"].all()
    np.testing.assert_array_equal(out["rate_mbps"], RATES)
    for i, p in enumerate(psdus):
        assert bytes(out["psdu"][i]) == p


@pytest.mark.parametrize("rate", [2, 5.5, 11])
def test_auto_short_preamble_equals_jax(rng, rate):
    psdu = _frames(rng, 1, 40)[0]
    w = golden.modulate(psdu, rate, preamble="short").astype(np.complex64)
    x = np.zeros((1, len(w) + 400), np.complex64)
    x[0, 60: 60 + len(w)] = w
    out = _auto_both(_noisy(x, rng), len(psdu))
    assert out["ok"][0] and out["preamble"][0] == 1
    assert out["rate_mbps"][0] == rate and bytes(out["psdu"][0]) == psdu


def test_auto_mixed_long_short_equals_jax(rng):
    psdus = _frames(rng, 4, 36)
    plen = len(psdus[0])
    specs = [(2, "long"), (2, "short"), (11, "long"), (11, "short")]
    waves = [golden.modulate(p, r, preamble=pre).astype(np.complex64)
             for p, (r, pre) in zip(psdus, specs)]
    x = np.zeros((4, max(len(w) for w in waves) + 300), np.complex64)
    for i, w in enumerate(waves):
        x[i, 40 + 5 * i: 40 + 5 * i + len(w)] = w
    out = _auto_both(_noisy(x, rng), plen)
    assert out["ok"].all()
    assert list(out["preamble"]) == [0, 1, 0, 1]
    np.testing.assert_array_equal(out["rate_mbps"], [2, 2, 11, 11])


def test_auto_noise_rejected_equals_jax(rng):
    x = (rng.normal(size=(2, 4000)) + 1j * rng.normal(size=(2, 4000))
         ).astype(np.complex64)
    out = _auto_both(x, 64)
    assert not out["ok"].any()


def test_auto_tail_from_correlation_equals_jax(rng):
    """auto_tail on a precomputed Barker correlation (the sharded
    pipeline's entry) equals the JAX package's."""
    psdus = _frames(rng, 2, 30)
    plen = len(psdus[0])
    x = np.zeros((2, ttx.waveform_len(5.5, plen) + 300), np.complex64)
    for i, p in enumerate(psdus):
        w = golden.modulate(p, 5.5).astype(np.complex64)
        x[i, 70 * i + 20: 70 * i + 20 + len(w)] = w
    x = _noisy(x, rng)
    c = trx.barker_correlate(torch.from_numpy(x))
    got = trx.auto_tail(torch.from_numpy(x), c, plen)
    jc = jnp.asarray(c.numpy())
    want = jrx.auto_tail(jnp.asarray(x), jc, plen)
    for key in EXACT + ("psdu",):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["ok"].all()


def test_sfd_rejects_garbage_prefix_alias_equals_jax(rng):
    """bench.py's 11b width: 128 streams of one 1000-byte 11 Mbps frame at
    offsets 30 + (7 i) % 300; early timing lock decodes noise symbols
    ahead of the sync, and a spurious SFD alias there must not hijack the
    first-hit selection."""
    psdu = jfr.build_data_frame(bytes(rng.integers(0, 256, 972,
                                                   dtype=np.uint8)), seq=2)
    wave = golden.modulate(psdu, 11).astype(np.complex64)
    B, N = 128, len(wave) + 400
    x = np.zeros((B, N), np.complex64)
    for i in range(B):
        x[i, 30 + (7 * i) % 300:][: len(wave)] = wave
    out = _auto_both(_noisy(x, rng), 1024)
    assert int(out["ok"].sum()) == B


def test_late_lock_clamps_like_jax(rng):
    """Frames near the window's end: the onset clamps to n - search, and a
    PLCP that runs off the end puts data_chip0 past the row, where the JAX
    package's data slices clamp their start.  Every field of the mixed-rate
    and of the fixed-rate receiver still equals the JAX package's."""
    psdus = _frames(rng, 6, 30)
    plen = len(psdus[0])
    N = 6000
    specs = [(11, "long", N - 2000), (11, "long", N - 1000),
             (2, "short", N - 1100), (5.5, "short", N - 1000),
             (1, "long", N - 3000), (11, "long", 100)]
    x = np.zeros((len(specs), N), np.complex64)
    for i, (p, (rate, pre, off)) in enumerate(zip(psdus, specs)):
        w = golden.modulate(p, rate, preamble=pre).astype(np.complex64)
        w = w[: N - off]
        x[i, off: off + len(w)] = w
    x = _noisy(x, rng)
    out = _auto_both(x, plen)
    assert (out["data_chip0"][:4] > N).any()
    assert not out["ok"][:5].any()
    # the one whole frame still decodes
    assert out["ok"][5] and bytes(out["psdu"][5]) == psdus[5]
    got = trx.rx_pipeline(torch.from_numpy(x), 11, max_psdu=plen)
    want = jrx.rx_pipeline(jnp.asarray(x), 11, max_psdu=plen)
    for key in EXACT[:-1] + ("sig_rate_ok",):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert (got["data_chip0"].numpy()[:4] > N).any()
