"""The port's 802.11a receiver (sora_tpu_torch, CPU) against the JAX chain.

The batch is built like bench.py's saturated batch, from the 54 Mbps
capture tests/data/fsample54.dmp decimated to 20 Msps: B streams holding
the frame at offsets 25 + 13 i, plus small noise.  Bits, bytes, flags and
integer positions must be equal; float outputs agree within the stated
tolerances (fp32 sums taken in another order by XLA and PyTorch).

On the CPU the JAX chain decodes with its float Viterbi (block 512,
overlap 96), not the radix-4 kernel the port runs, so chain parity is
checked at clean SNR; low-SNR agreement of the decoders is held at the
kernel level (test_torch_viterbi.py).
"""

import numpy as np
import pytest
import torch

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.io.dumpfile import load_dump
from sora_tpu.phy.dot11a import rx as jrx
from sora_tpu_torch.mac.frame import check_fcs
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

RATE, MAX_PSDU, B = 54, 1504, 6
EXACT = ["psdu", "ok", "fcs_ok", "sig_ok", "cs_ok", "truncated", "length",
         "lts1"]
# det is a ratio of fp32 moving sums (1e-4 absolute on a [0, 1] metric),
# cfo an angle / 16 (1e-5 rad/sample), snr_db a log ratio (0.05 dB)
CLOSE = {"det": 1e-4, "cfo": 1e-5, "snr_db": 0.05}


@pytest.fixture(scope="module")
def capture20():
    x = load_dump("tests/data/fsample54.dmp").astype(np.complex128)
    x -= x.mean()
    return x[0::2]


@pytest.fixture(scope="module")
def batch(capture20):
    x20 = capture20.astype(np.complex64)
    rng = np.random.default_rng(1)
    x = np.zeros((B, len(x20) + 160), np.complex64)
    for i in range(B):
        off = 25 + (13 * i) % 120
        x[i, off: off + len(x20)] = x20
    scale = 0.02 * np.abs(x20).mean()
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * scale
    return x


@pytest.fixture(scope="module")
def outputs(batch):
    want = {k: np.asarray(v)
            for k, v in jrx.rx_pipeline(batch, RATE, max_psdu=MAX_PSDU).items()}
    got = fetch(trx.rx_pipeline(torch.from_numpy(batch), RATE,
                                max_psdu=MAX_PSDU))
    return want, got


@pytest.fixture(scope="module")
def stages(batch):
    """Both chains' synchronize + extract_symbols outputs."""
    nsym = min(trx.max_symbols(trx.C.RATES[RATE], MAX_PSDU),
               (batch.shape[1] - 208) // 80)
    j_sync = [np.array(v) for v in jrx.synchronize(batch)]
    t_sync = fetch(trx.synchronize(torch.from_numpy(batch)))
    # both extract from the JAX anchors so the comparison isolates the stage
    j_ext = [np.array(v) for v in jrx.extract_symbols(
        batch, *j_sync[:2], nsym, return_weights=True)]
    t_ext = fetch(trx.extract_symbols(
        torch.from_numpy(batch), torch.from_numpy(j_sync[0]),
        torch.from_numpy(j_sync[1]), nsym, return_weights=True))
    return j_sync, t_sync, j_ext, t_ext


@pytest.mark.parametrize("key", EXACT)
def test_rx_pipeline_exact_fields(outputs, key):
    want, got = outputs
    assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("key", sorted(CLOSE))
def test_rx_pipeline_close_fields(outputs, key):
    want, got = outputs
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=CLOSE[key])


def test_rx_pipeline_decodes_every_row(outputs):
    _, got = outputs
    assert got["ok"].all()
    assert (got["length"] == 1500).all()
    psdu = got["psdu"][:, :1500]
    assert (psdu == psdu[0]).all() and check_fcs(psdu[0].tobytes())


def test_synchronize_matches_jax(stages):
    (lts1, cfo, det), (t_lts1, t_cfo, t_det), _, _ = stages
    np.testing.assert_array_equal(t_lts1, lts1)
    np.testing.assert_allclose(t_cfo, cfo, rtol=0, atol=CLOSE["cfo"])
    np.testing.assert_allclose(t_det, det, rtol=0, atol=CLOSE["det"])


def test_extract_symbols_matches_jax(stages):
    _, _, (eq, snr, wgt), (t_eq, t_snr, t_wgt) = stages
    assert t_eq.shape == eq.shape and t_eq.dtype == np.complex64
    # unit-gain equalized carriers after ~60 symbols of phase tracking:
    # 1e-3 absolute on values of magnitude ~1
    np.testing.assert_allclose(t_eq, eq, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_snr, snr, rtol=0, atol=CLOSE["snr_db"])
    np.testing.assert_allclose(t_wgt, wgt, rtol=1e-4, atol=1e-5)


def test_decode_signal_matches_jax(stages):
    _, _, (eq, _, _), _ = stages
    want = [np.asarray(v) for v in jrx.decode_signal(eq[:, 0, :])]
    got = fetch(trx.decode_signal(torch.from_numpy(eq[:, 0, :])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the trellis cross-check decodes the same SIGNAL fields
    via = fetch(trx.decode_signal_viterbi(torch.from_numpy(eq[:, 0, :])))
    for g, w in zip(via, want):
        np.testing.assert_array_equal(g, w)


def test_decode_data_matches_jax(stages):
    _, _, (eq, _, wgt), _ = stages
    length = np.full(B, 1500, np.int32)
    want = [np.asarray(v) for v in jrx.decode_data(eq[:, 1:, :], length,
                                                    RATE, wgt)]
    got = fetch(trx.decode_data(torch.from_numpy(eq[:, 1:, :]),
                                torch.from_numpy(length), RATE,
                                torch.from_numpy(wgt)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_demodulate_capture_matches_golden(capture20):
    res = trx.demodulate(capture20, device="cpu")
    ref = golden.demodulate(capture20)
    assert res.ok and res.reason == "frame_ok"
    assert (res.rate_mbps, res.length) == (54, 1500)
    assert res.psdu == ref.psdu and len(res.psdu) == 1500
    jres = jrx.demodulate(capture20)
    assert (res.start, res.psdu) == (jres.start, jres.psdu)


def test_noise_is_not_ok():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 5452)) + 1j * rng.normal(size=(3, 5452))
         ).astype(np.complex64)
    out = fetch(trx.rx_pipeline(torch.from_numpy(x), RATE,
                                max_psdu=MAX_PSDU))
    assert not out["ok"].any()
    assert trx.demodulate(x[0], device="cpu").reason != "frame_ok"


def test_unknown_input_rate_raises():
    """As the JAX package's ofdm_frontend: an input rate other than 20m,
    40m and 44m is a ValueError, in every entry point."""
    x = torch.zeros(1, 1000, dtype=torch.complex64)
    with pytest.raises(ValueError, match="unknown OFDM input_rate"):
        jrx.rx_pipeline(x.numpy(), RATE, input_rate="30m")
    with pytest.raises(ValueError, match="unknown OFDM input_rate"):
        trx.rx_pipeline(x, RATE, input_rate="30m")
    with pytest.raises(ValueError, match="unknown OFDM input_rate"):
        trx.rx_pipeline_auto(x, input_rate="30m")
    with pytest.raises(ValueError, match="unknown OFDM input_rate"):
        trx.demodulate(np.zeros(1000), input_rate="30m", device="cpu")


# ---- the receiver's constant tables equal the JAX package's ---------------


def test_signal_ml_tables_equal():
    for a, b in zip(trx._signal_ml_tables(), jrx._signal_ml_tables()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_psdu, nsym_cap",
                         [(1504, 65), (trx.MAX_PSDU, 1 << 30)])
def test_auto_tables_equal(max_psdu, nsym_cap):
    got = trx._auto_tables(max_psdu, nsym_cap)
    want = jrx._auto_tables(max_psdu, nsym_cap)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1] and got[3:] == want[3:]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("mbps", sorted(trx.C.RATES))
def test_rate_symbol_matrix_equal(mbps):
    np.testing.assert_array_equal(trx._rate_symbol_matrix(mbps),
                                  jrx._rate_symbol_matrix(mbps))
    assert trx.max_symbols(trx.C.RATES[mbps], 1504) == \
        jrx.max_symbols(jrx.C.RATES[mbps], 1504)
