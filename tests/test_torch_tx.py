"""The port's 802.11a transmitter (sora_tpu_torch, CPU) against the JAX
transmitter and the golden numpy model.

PSDUs come from a numpy seed.  The waveforms are fp32 IFFTs taken as DFT
matmuls by both packages: they agree within 1e-6 absolute on unit-power
samples (sums taken in another order).  The golden model computes in
float64, so against it the bound is 1e-5.  The port's waveforms must
also decode byte-identically through both receivers.
"""

import numpy as np
import pytest
import torch

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.phy.dot11a import rx as jrx
from sora_tpu.phy.dot11a import tx as jtx
from sora_tpu_torch.mac import frame as tfr
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.phy.dot11a import tx as ttx

torch.set_num_threads(2)

RATES = [6, 9, 12, 18, 24, 36, 48, 54]
JAX_ATOL = 1e-6
GOLDEN_ATOL = 1e-5


def _psdus(seed: int, n: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([np.frombuffer(tfr.build_data_frame(bytes(
        rng.integers(0, 256, size, dtype=np.uint8)), seq=i), np.uint8)
        for i in range(n)])


@pytest.mark.parametrize("rate", RATES)
def test_modulate_matches_jax_and_golden(rate):
    arr = _psdus(rate, 3, 90)
    got = ttx.modulate(torch.from_numpy(arr), rate, arr.shape[1]).numpy()
    want = np.asarray(jtx.modulate(arr, rate, arr.shape[1]))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert got.shape[1] == ttx.waveform_len(rate, arr.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
    for i in range(len(arr)):
        np.testing.assert_allclose(got[i], golden.modulate(
            arr[i].tobytes(), rate), rtol=0, atol=GOLDEN_ATOL)


@pytest.mark.parametrize("rate", [6, 54])
def test_modulate_other_scrambler_seed(rate):
    arr = _psdus(100 + rate, 2, 40)
    got = ttx.modulate(torch.from_numpy(arr), rate, arr.shape[1],
                       scrambler_seed=0x21).numpy()
    want = np.asarray(jtx.modulate(arr, rate, arr.shape[1],
                                   scrambler_seed=0x21))
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)


def test_tx_tables_equal():
    for rate in RATES:
        for plen in (1, 100, 1504):
            assert ttx.num_symbols(rate, plen) == jtx.num_symbols(rate, plen)
            assert ttx.waveform_len(rate, plen) == \
                jtx.waveform_len(rate, plen)
        r = ttx.C.RATES[rate]
        np.testing.assert_array_equal(ttx._puncture_gather(r, 2 * 216),
                                      jtx._puncture_gather(r, 2 * 216))


def test_port_waveforms_decode_in_both_receivers():
    """One frame per rate, modulated by the port, decoded by the port's
    and the JAX mixed-rate receivers with equal results."""
    arr = _psdus(7, 1, 60)
    waves = [ttx.modulate(torch.from_numpy(arr), r, arr.shape[1]).numpy()[0]
             for r in RATES]
    rng = np.random.default_rng(8)
    x = np.zeros((len(RATES), max(len(w) for w in waves) + 200),
                 np.complex64)
    for i, w in enumerate(waves):
        x[i, 50 + 7 * i: 50 + 7 * i + len(w)] = w
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * 0.02
    got = trx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=256)
    want = jrx.rx_pipeline_auto(x, max_psdu=256)
    assert got["ok"].all()
    assert got["rate_mbps"].tolist() == RATES
    for key in ("psdu", "ok", "rate_mbps", "length", "lts1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert (got["psdu"][:, : arr.shape[1]].numpy() == arr[0]).all()
