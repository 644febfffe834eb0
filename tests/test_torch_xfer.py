"""The port's int16/int8 sample wire (sora_tpu_torch.util.xfer) against the
JAX package's, on the CPU.

Quantization runs on the host in both (float32 multiply by the gain,
saturation at +-32767 / +-127, numpy's truncating store), and the device
divides the fixed scale back out (1/2048 and 1/32 are exact), so the
complex64 values must be equal bit for bit — with saturating input, at
AGC gains above and below 1, and from the pre-quantized windows of the
native feed.  ``Pending.is_ready`` never waits; the entry points raise
without CUDA unless given ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from sora_tpu.util import xfer as jx
from sora_tpu_torch.util import xfer as tx

GAINS = [1.0, 0.37, 9.0, 300.0, 1.0 / 64.0]


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(41)
    x = ((rng.normal(size=(3, 2048)) + 1j * rng.normal(size=(3, 2048)))
         * 3.0).astype(np.complex64)
    # exact levels, half levels, both rails and far past them
    x[0, :8] = [0.0, 1e9, -1e9, 0.4999 - 0.4999j, 15.99 + 1j, -3.97 - 8j,
                1.0 / 2048 + 0.5j / 32, -16.0 + 16.0j]
    return x


def _host(z):
    return np.asarray(z)


def test_scales_equal_jax():
    assert tx.I16_SCALE == jx.I16_SCALE == 2048.0
    assert tx.I8_SCALE == jx.I8_SCALE == 32.0


@pytest.mark.parametrize("gain", GAINS)
@pytest.mark.parametrize("name", ["device_complex16", "device_complex8"])
def test_wire_equals_jax_bit_for_bit(samples, name, gain):
    got = getattr(tx, name)(samples, "cpu", scale=gain)
    want = _host(getattr(jx, name)(samples, scale=gain))
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    assert got.shape == samples.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,lim", [("device_complex16", 32767),
                                      ("device_complex8", 127)])
def test_wire_saturates_never_wraps(samples, name, lim):
    scale = tx.I16_SCALE if lim == 32767 else tx.I8_SCALE
    got = getattr(tx, name)(samples, "cpu", scale=1.0).numpy()
    assert got[0, 1].real == lim / scale and got[0, 2].real == -lim / scale
    assert np.abs(got.real).max() * scale <= lim
    assert np.abs(got.imag).max() * scale <= lim


@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_device_quantized_equals_jax(dtype):
    rng = np.random.default_rng(5)
    lim = np.iinfo(dtype).max
    h = rng.integers(-lim, lim + 1, (4, 512, 2)).astype(dtype)
    h[0, :3] = [[lim, -lim], [0, 1], [-1, lim - 1]]
    got = tx.device_quantized(h, "cpu").numpy()
    np.testing.assert_array_equal(got, _host(jx.device_quantized(h)))
    scale = tx.I8_SCALE if dtype == np.int8 else tx.I16_SCALE
    np.testing.assert_array_equal(got.real, h[..., 0] / np.float32(scale))
    np.testing.assert_array_equal(got.imag, h[..., 1] / np.float32(scale))


def test_device_complex16_is_the_quantized_path(samples):
    """device_complex16 = host quantization + device_quantized: the node's
    carry path and its native feed put the same values on the device."""
    h = np.empty(samples.shape + (2,), np.int16)
    f = np.multiply(samples.real, tx.I16_SCALE * 0.5, dtype=np.float32)
    h[..., 0] = np.clip(f, -32767, 32767)
    f = np.multiply(samples.imag, tx.I16_SCALE * 0.5, dtype=np.float32)
    h[..., 1] = np.clip(f, -32767, 32767)
    np.testing.assert_array_equal(
        tx.device_complex16(samples, "cpu", scale=0.5).numpy(),
        tx.device_quantized(h, "cpu").numpy())


def test_pending_is_ready_and_get():
    t = torch.arange(6, dtype=torch.float32)
    p = tx.Pending({"a": t, "b": (t * 2, 3)})
    assert p.is_ready() is True
    got = p.get()
    np.testing.assert_array_equal(got["a"], np.arange(6))
    np.testing.assert_array_equal(got["b"][0], 2 * np.arange(6))
    assert got["b"][1] == 3


def test_wire_entry_points_raise_without_cuda(monkeypatch, samples):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = np.zeros((2, 8, 2), np.int8)
    for call in (lambda: tx.device_complex16(samples),
                 lambda: tx.device_complex8(samples, scale=2.0),
                 lambda: tx.device_quantized(h),
                 lambda: tx.device_complex16(samples, "cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tx.device_quantized(h, "cpu").device.type == "cpu"
    assert tx.device_complex8(samples, "cpu").device.type == "cpu"
