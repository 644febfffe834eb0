"""The port's radio manager (sora_tpu_torch.runtime.radio) against the JAX
package's, on the CPU.

The channel model is numpy in both: with one seed the port's output must
equal the JAX package's bit for bit (multipath, Doppler, SFO, noise, and
the noise stream across captures).  ``SoftRadio.capture`` runs its rate
change through each package's front end (torch here, JAX there), so the
captures agree within 1e-5 (a float32 polyphase FIR summed in another
order); without a rate change they are equal.  The radio feeds the port's
node end to end, and raises without CUDA unless given ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.mac.frame import MacHeader, append_fcs
from sora_tpu.runtime import radio as jradio
from sora_tpu_torch.runtime import native as tnative
from sora_tpu_torch.runtime import node as tnode
from sora_tpu_torch.runtime import radio as tradio

ADDR = b"\x02SORA1"
CAPTURE_ATOL = 1e-5


def _tone(n, f=0.02):
    return np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)


def test_ref_taps_equal_jax():
    assert len(tradio.REF_TAPS) == len(jradio.REF_TAPS)
    for (d, c), (dj, cj) in zip(tradio.REF_TAPS, jradio.REF_TAPS):
        assert d == dj and c == cj


@pytest.mark.parametrize("kw", [
    dict(taps=tradio.REF_TAPS, doppler_hz=55e3, sfo_ppm=20.0,
         noise_rms=0.01, seed=9),
    dict(noise_rms=0.1, seed=4),
    dict(taps=[(0, 1.0), (3, 0.5j)], sfo_ppm=-35.0)])
def test_channel_model_equals_jax(rng, kw):
    x = (rng.normal(size=3000) + 1j * rng.normal(size=3000)
         ).astype(np.complex64)
    got_m, want_m = tradio.ChannelModel(**kw), jradio.ChannelModel(**kw)
    for _ in range(2):             # the noise stream advances per call
        got, want = got_m.apply(x, 20e6), want_m.apply(x, 20e6)
        assert got.dtype == want.dtype == np.complex64
        np.testing.assert_array_equal(got, want)


def test_channel_model_mimo_matrix_taps_equal_jax(rng):
    H = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
         ).astype(np.complex64)
    x2 = (rng.normal(size=(2, 256)) + 1j * rng.normal(size=(2, 256))
          ).astype(np.complex64)
    kw = dict(taps=[(0, 1.0), (3, H)], noise_rms=0.02, seed=2)
    got = tradio.ChannelModel(**kw).apply(x2, 20e6)
    np.testing.assert_array_equal(got, jradio.ChannelModel(**kw).apply(
        x2, 20e6))
    assert got.shape == (2, 259)


def _configure(r, rate=20e6, gain=0.0, tune=0.0, offset=0.0):
    r.set_sample_rate(rate)
    r.set_rx_gain(gain)
    r.set_central_freq(2.422e9 + tune)
    r.set_freq_offset(offset)


@pytest.mark.parametrize("rate,gain,tune", [
    (20e6, 20.0, 0.0), (20e6, -6.0, 37e3), (40e6, 0.0, 0.0),
    (44e6, 3.0, -90e3), (10e6, 0.0, 5e3)])
def test_capture_matches_jax(rate, gain, tune):
    air = _tone(1 << 13)
    caps = []
    for r in (tradio.SoftRadio(device="cpu"), jradio.SoftRadio()):
        r.attach_air(air, freq_hz=2.422e9, rate_sps=20e6)
        r.set_channel((tradio if isinstance(r, tradio.SoftRadio)
                       else jradio).ChannelModel(noise_rms=0.05, seed=3))
        _configure(r, rate, gain, tune)
        caps.append(r.capture())
    got, want = caps
    assert got.shape == want.shape and got.dtype == np.complex64
    if rate == 20e6:
        np.testing.assert_array_equal(got, want)
    else:
        peak = float(np.abs(want).max())
        assert np.abs(got - want).max() <= CAPTURE_ATOL * peak


def test_gain_and_tx_sink():
    r = tradio.SoftRadio(device="cpu")
    r.attach_air(_tone(4096, 0.01))
    r.set_rx_gain(20.0)
    np.testing.assert_allclose(np.abs(r.capture()).mean(), 10.0, rtol=1e-3)
    fired = []
    r.attach_tx_sink(fired.append)
    r.set_tx_gain(6.0)
    out = r.tx(np.ones(100, np.complex64))
    np.testing.assert_allclose(np.abs(out), 10 ** 0.3, rtol=1e-5)
    assert len(fired) == 1 and len(fired[0]) == 100
    r.write_register(0x10, 0xDEAD)
    assert r.read_register(0x10) == 0xDEAD and r.read_register(0x44) == 0
    with pytest.raises(RuntimeError, match="no RX ring"):
        r.start_rx()


def test_radio_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tradio.SoftRadio()
    assert tradio.SoftRadio(device="cpu").device.type == "cpu"


def test_radio_feeds_port_node_through_channel(rng):
    """Frames on the air, captured through -20 dB of gain, a 90 kHz tuning
    error and the 4-tap / Doppler / SFO / noise channel, streamed into the
    port node's ring: the node (AGC + CFO tracking) decodes them all."""
    pieces, n = [], 4
    for i in range(n):
        hdr = MacHeader(addr1=ADDR, addr2=b"\x02PEER0", addr3=ADDR,
                        seq_ctrl=i << 4)
        psdu = append_fcs(hdr.pack()
                          + bytes(rng.integers(0, 256, 60, dtype=np.uint8)))
        pieces += [np.zeros(800, np.complex64),
                   golden.modulate(psdu, 12).astype(np.complex64)]
    pieces.append(np.zeros(2400, np.complex64))
    air = np.concatenate(pieces)
    ring = tnative.RxRing(capacity=1 << 22)
    radio = tradio.SoftRadio(ring, device="cpu")
    radio.attach_air(air, freq_hz=2.422e9, rate_sps=20e6)
    radio.set_rx_gain(-20.0)
    radio.set_central_freq(2.422e9 + 90e3)
    radio.set_channel(tradio.ChannelModel(
        taps=tradio.REF_TAPS, doppler_hz=55e3, sfo_ppm=20.0,
        noise_rms=0.01, seed=5))
    node = tnode.StreamingNode(ring, tnode.NodeConfig(
        window=4096, batch=2, overlap=2816, max_psdu=128, addr=ADDR,
        rate_mbps=None, min_rate_mbps=12), device="cpu")
    radio.start_rx()
    idle = 0
    while idle < 3:
        idle = 0 if node.step() else idle + 1
    node.flush()
    assert node.stats.frame_ok == n, node.report()
    radio.stop()
    ring.close()
