"""The port's sample-rate front end (sora_tpu_torch.phy.frontend, CPU)
against the JAX package's, and the receivers' "40m" / "44m" inputs.

The filter prototypes are numpy in both packages and must be equal bit
for bit.  The stages are fp32 shifted-add FIRs and means over the same
inputs: they agree within 1e-5 absolute on unit-scale samples (sums
taken in another order; the 44 <-> 40 resamplers add ~100 taps).  The
receivers' exact fields (bits, bytes, flags, positions) must be equal.
"""

import numpy as np
import pytest
import torch

from sora_tpu.io.dumpfile import load_dump
from sora_tpu.phy import frontend as jfe
from sora_tpu.phy.dot11a import rx as jrx
from sora_tpu_torch.phy import frontend as tfe
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

ATOL = 1e-5
EXACT = ["psdu", "ok", "fcs_ok", "sig_ok", "cs_ok", "truncated", "length",
         "lts1"]
# det: ratio of fp32 moving sums; cfo: angle / 16 (rad/sample); snr_db:
# log ratio — the tolerances of test_torch_dot11a.py
CLOSE = {"det": 1e-4, "cfo": 1e-5, "snr_db": 0.05}


@pytest.mark.parametrize("args", [(), (23,), (11,)])
def test_halfband_taps_equal(args):
    np.testing.assert_array_equal(tfe.halfband_taps(*args),
                                  jfe.halfband_taps(*args))


@pytest.mark.parametrize("args", [(), (0.35, 4, 6), (0.5, 8, 4)])
def test_rrc_taps_equal(args):
    np.testing.assert_array_equal(tfe.rrc_taps(*args), jfe.rrc_taps(*args))


@pytest.mark.parametrize("up, down", [(10, 11), (11, 10), (2, 1)])
def test_resample_taps_equal(up, down):
    np.testing.assert_array_equal(tfe._resample_taps(up, down),
                                  jfe._resample_taps(up, down))


STAGES = {
    "dc_remove": lambda fe, x: fe.dc_remove(x),
    "downsample2": lambda fe, x: fe.downsample2(x),
    "downsample2_phase1": lambda fe, x: fe.downsample2(x, phase=1),
    "downsample2_unfiltered": lambda fe, x: fe.downsample2(x, 0, False),
    "resample_10_11": lambda fe, x: fe.resample(x, 10, 11),
    "resample_11_10": lambda fe, x: fe.resample(x, 11, 10),
    "upsample2": lambda fe, x: fe.upsample2(x),
    "ofdm_frontend_40m": lambda fe, x: fe.ofdm_frontend_40m(x),
    "ofdm_frontend_40m_phase1": lambda fe, x: fe.ofdm_frontend_40m(x, 1),
    "ofdm_frontend_44m": lambda fe, x: fe.ofdm_frontend_44m(x),
    "ofdm_frontend_20m": lambda fe, x: fe.ofdm_frontend(x, "20m"),
    "ofdm_frontend_dispatch_40m": lambda fe, x: fe.ofdm_frontend(x, "40m"),
    "ofdm_frontend_dispatch_44m": lambda fe, x: fe.ofdm_frontend(x, "44m"),
    "ofdm_upsample_44m": lambda fe, x: fe.ofdm_upsample_44m(x),
    "chip_frontend_44m": lambda fe, x: fe.chip_frontend_44m(x),
    "chip_frontend_40m": lambda fe, x: fe.chip_frontend_40m(x),
    "pulse_shape_11b": lambda fe, x: fe.pulse_shape_11b(x),
    "channelize": lambda fe, x: fe.channelize(x, 0.125),
    "channelize_decim4": lambda fe, x: fe.channelize(x, -0.2, decim=4),
}


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(44)
    x = (rng.normal(size=(2, 1320)) + 1j * rng.normal(size=(2, 1320))
         ) * np.sqrt(0.5) + (0.3 - 0.1j)             # with a DC offset
    return x.astype(np.complex64)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_matches_jax(samples, name):
    fn = STAGES[name]
    got = fn(tfe, torch.from_numpy(samples)).numpy()
    want = np.asarray(fn(jfe, samples))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_unknown_input_rate_raises():
    x = torch.zeros(1, 64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="unknown OFDM input_rate"):
        tfe.ofdm_frontend(x, "30m")
    with pytest.raises(ValueError, match="2\\^k"):
        tfe.channelize(x, 0.1, decim=3)


# ---- the receivers at 40 and 44 Msps ---------------------------------------


@pytest.fixture(scope="module")
def raw40():
    """The 54 Mbps capture, untouched (40 Msps, with its DC offset)."""
    return load_dump("tests/data/fsample54.dmp").astype(np.complex64)


@pytest.fixture(scope="module")
def batch40(raw40):
    """Two streams holding the raw capture at offsets 50 and 76 in a
    window 320 samples longer, plus noise at 0.02 of its mean amplitude."""
    rng = np.random.default_rng(40)
    x = np.zeros((2, len(raw40) + 320), np.complex64)
    for i, off in enumerate((50, 76)):
        x[i, off: off + len(raw40)] = raw40
    scale = 0.02 * float(np.abs(raw40).mean())
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * scale
    return x


def _rates(batch40):
    """The same streams per input rate: 40 Msps as is, 44 Msps through the
    JAX package's 11/10 resampler (both chains get the same samples)."""
    return {"40m": batch40,
            "44m": np.array(jfe.resample(batch40, 11, 10))}


@pytest.mark.parametrize("input_rate", ["40m", "44m"])
def test_rx_pipeline_input_rate_matches_jax(batch40, input_rate):
    x = _rates(batch40)[input_rate]
    want = {k: np.asarray(v) for k, v in jrx.rx_pipeline(
        x, 54, max_psdu=1504, input_rate=input_rate).items()}
    got = fetch(trx.rx_pipeline(torch.from_numpy(x), 54, max_psdu=1504,
                                input_rate=input_rate))
    assert got["ok"].all() and (got["length"] == 1500).all()
    for key in EXACT:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, tol in CLOSE.items():
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("input_rate", ["40m", "44m"])
def test_rx_pipeline_auto_input_rate_matches_jax(batch40, input_rate):
    x = _rates(batch40)[input_rate]
    want = jrx.rx_pipeline_auto(x, max_psdu=1504, input_rate=input_rate,
                                min_rate_mbps=54)
    got = fetch(trx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=1504,
                                     input_rate=input_rate,
                                     min_rate_mbps=54))
    assert got["ok"].all() and (got["rate_mbps"] == 54).all()
    for key in EXACT + ["rate_mbps"]:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("input_rate", ["40m", "44m"])
def test_demodulate_input_rate_matches_jax(batch40, input_rate):
    x = _rates(batch40)[input_rate][0]
    got = trx.demodulate(x, input_rate=input_rate, device="cpu")
    want = jrx.demodulate(x, input_rate=input_rate)
    assert got.ok and got.reason == "frame_ok"
    assert (got.rate_mbps, got.length) == (54, 1500)
    assert (got.start, got.psdu, got.reason) == \
        (want.start, want.psdu, want.reason)
