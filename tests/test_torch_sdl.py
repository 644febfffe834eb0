"""The port's SDL layer (``sora_tpu_torch.sdl``) against the JAX package's
``sora_tpu.sdl`` on the same seeded inputs, and the dump replay in the
sample wire's units (``runtime.native.replay_samples``).

* ``Signal``: the dump files are the same bytes; ``resample`` within 1e-5
  of JAX's front end; ``power_dbfs`` and ``snr_db`` within 1e-9 (the same
  numpy code); ``spectrum`` within 1e-3 dB above peak - 80 dB.
* ``Radio``: on the air of ``tests/test_sdl.py::test_radio_loopback_rx``
  the same payload list and ``frame_ok`` as JAX's ``Radio``; phy "n" on
  two rings and phy "b" with JAX's payloads and counters; phy "a" at the
  node width on traffic where the K decode candidates a window bind, with
  JAX's payloads and counters; ``replay`` of the 40 Msps capture decodes
  with crc_fail 0.
* The node app's ``--dump`` on the capture decodes with crc_fail 0, where
  the JAX app's raw-count replay loses every frame to the CRC.

``Radio.rx`` keeps its wall-clock API, so every call here gets a generous
``seconds``: under a loaded test run a short one can end before the ring
is drained.
"""

import re

import numpy as np
import pytest
import torch

from sora_tpu import sdl as jsdl
from sora_tpu.apps import node as japp
from sora_tpu.golden import dot11a_np as ga
from sora_tpu.golden import dot11b_np as gb
from sora_tpu.golden import dot11n_np as gn
from sora_tpu.mac.frame import MacHeader, append_fcs
from sora_tpu.runtime import native as jnative
from sora_tpu_torch import sdl as tsdl
from sora_tpu_torch.apps import node as tapp
from sora_tpu_torch.runtime import native as tnative
from sora_tpu_torch.util.xfer import I16_SCALE

torch.set_num_threads(2)

ADDR = b"\x02SORA1"
PEER = b"\x02PEER0"
CAPTURE = "tests/data/fsample54.dmp"
RESAMPLE_ATOL = 1e-5      # float32 FIR of two libraries, unit-power input
SPECTRUM_DB_ATOL = 1e-3
RX_SECONDS = 120.0        # a generous wall-clock bound for Radio.rx


def _noise(rng, shape, scale=0.01):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64) * scale


def _psdu(i, body):
    hdr = MacHeader(addr1=ADDR, addr2=PEER, addr3=ADDR, seq_ctrl=16 * i)
    return append_fcs(hdr.pack() + body)


@pytest.mark.parametrize("bits", [14, 16])
def test_signal_dump_roundtrip_equals_jax(tmp_path, rng, bits):
    x = _noise(rng, 4096, 0.3)
    a, b = str(tmp_path / "t.dmp"), str(tmp_path / "j.dmp")
    assert tsdl.Signal(x, 40e6).to_dump(a, bits=bits) == \
        jsdl.Signal(x, 40e6).to_dump(b, bits=bits)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = tsdl.Signal.from_dump(a, 40e6)
    want = jsdl.Signal.from_dump(a, 40e6)
    assert back.sample_rate == 40e6 and len(back) >= len(x)
    assert back.samples.dtype == np.complex64
    assert np.array_equal(back.samples, want.samples)
    # the dump stores auto-scaled integer I/Q: compare up to gain
    s = back.samples[: len(x)]
    rho = np.vdot(s, x) / (np.linalg.norm(s) * np.linalg.norm(x))
    assert abs(rho) > 0.9999


@pytest.mark.parametrize("rates", [(20e6, 40e6), (40e6, 20e6),
                                   (40e6, 44e6), (44e6, 40e6),
                                   (20e6, 20e6)])
def test_signal_resample_equals_jax(rng, rates):
    src, dst = rates
    x = np.exp(2j * np.pi * 1.7e6 / src * np.arange(6000)).astype(
        np.complex64) + _noise(rng, 6000, 0.1)
    got = tsdl.Signal(x, src).resample(dst, device="cpu")
    want = jsdl.Signal(x, src).resample(dst)
    assert got.sample_rate == want.sample_rate == dst
    assert got.samples.dtype == np.complex64
    assert got.samples.shape == want.samples.shape
    assert np.abs(got.samples - want.samples).max() < RESAMPLE_ATOL


def test_signal_measures_equal_jax(rng):
    n = 8192
    tone = np.exp(2j * np.pi * 2e6 / 20e6 * np.arange(n)).astype(
        np.complex64) + _noise(rng, n, 0.003)
    t, j = tsdl.Signal(tone, 20e6), jsdl.Signal(tone, 20e6)
    assert abs(t.power_dbfs() - j.power_dbfs()) < 1e-9
    assert abs(t.snr_db() - j.snr_db()) < 1e-9 and t.snr_db() > 35
    up = t.resample(40e6, device="cpu")
    assert len(up) == 2 * n
    f_t, p_t = up.spectrum(nfft=512, device="cpu")
    f_j, p_j = jsdl.Signal(up.samples, 40e6).spectrum(nfft=512)
    assert np.array_equal(f_t, f_j)
    # over the bins above peak - 80 dB: the halfband's stop band sits at
    # -125 dB, in both libraries' float32 rounding noise
    live = p_j > p_j.max() - 80.0
    assert live.sum() > 256
    assert np.abs(p_t - p_j)[live].max() < SPECTRUM_DB_ATOL
    assert abs(f_t[int(np.argmax(p_t))] - 2e6) < 1e5


def _loopback_air(rng):
    """The air of tests/test_sdl.py::test_radio_loopback_rx."""
    psdu = _psdu(1, b"sdl radio payload")
    w = ga.modulate(psdu, 12).astype(np.complex64)
    air = np.concatenate([np.zeros(500, np.complex64), w,
                          np.zeros(4096, np.complex64)])
    return air + _noise(rng, len(air))


LOOPBACK_KW = dict(window=4096, batch=2, overlap=2816, max_psdu=128,
                   min_rate_mbps=12)


def test_radio_loopback_rx_equals_jax(rng):
    air = _loopback_air(rng)
    with tsdl.Radio(phy="a", device="cpu", **LOOPBACK_KW) as r:
        r.inject(air)
        got = list(r.rx(seconds=RX_SECONDS))
        t_ok, t_acks = r.stats.frame_ok, r.stats.acks_tx
    with jsdl.Radio(phy="a", **LOOPBACK_KW) as r:
        r.inject(air)
        want = list(r.rx(seconds=RX_SECONDS))
        j_ok = r.stats.frame_ok
    assert got == want == [(PEER, b"sdl radio payload")]
    assert t_ok == j_ok == 1 and t_acks == 1


def test_radio_sends_data_over_its_loopback_air():
    """``send`` queues a CSMA data frame; the loopback TX sink writes it
    into the radio's own ring, where the node logs it as not addressed to
    it (promiscuous off)."""
    with tsdl.Radio(phy="a", device="cpu", **LOOPBACK_KW) as r:
        r.send(b"over the air", PEER, rate=12)
        r.inject(np.zeros(3 * 4096, np.complex64))
        list(r.rx(seconds=RX_SECONDS))
        assert r.stats.tx_data == 1
        assert r.tx_sink.fired and r.tx_sink.rings == r.rings


COUNTERS = ("windows", "cs_timeout", "decoded_batches", "frame_ok",
            "plcp_fail", "crc_fail", "truncated", "dup", "not_for_us",
            "acks_tx")


def _radio_run(mod, phy, air, **kw):
    """(payloads, counters) of ``mod.Radio`` after injecting ``air``."""
    with mod.Radio(phy=phy, **kw) as r:
        r.inject(air)
        got = list(r.rx(seconds=RX_SECONDS))
        return got, {k: getattr(r.stats, k) for k in COUNTERS}


def test_radio_phy_n_two_rings_equals_jax():
    """phy "n" opens two rings (the CSoraMIMORadio case): 2x2 frames at
    MCS 8, 11 and 15 injected as (2, N) air all decode and are ACKed, with
    the JAX radio's payloads and counters."""
    rng = np.random.default_rng(31)
    psdus = [_psdu(i, bytes(rng.integers(0, 256, 80, dtype=np.uint8)))
             for i in range(3)]
    pieces = []
    for p, m in zip(psdus, (8, 11, 15)):
        pieces += [np.zeros((2, 800), np.complex64),
                   np.asarray(gn.modulate(p, m), np.complex64)]
    pieces.append(np.zeros((2, 2700), np.complex64))
    air = np.concatenate(pieces, axis=1)
    air += _noise(np.random.default_rng(32), air.shape, 0.005)
    kw = dict(window=4096, batch=2, overlap=2816, min_rate_mbps=9)
    got, counts = _radio_run(tsdl, "n", air, device="cpu", **kw)
    assert (got, counts) == _radio_run(jsdl, "n", air, **kw)
    assert got == [(PEER, p[24:-4]) for p in psdus]
    assert counts["frame_ok"] == counts["acks_tx"] == 3
    with tsdl.Radio(phy="n", device="cpu", **kw) as r:
        assert len(r.rings) == 2 and r.node.rings == r.rings


def test_radio_phy_b_equals_jax():
    """phy "b" at 11 Msps chips: DSSS frames at 2, 5.5 and 11 Mbps, with
    the JAX radio's payloads and counters (the loopback sink writes each
    ACK back into the ring, where the node decodes it too)."""
    rng = np.random.default_rng(23)
    psdus = [_psdu(i, bytes(rng.integers(0, 256, 40, dtype=np.uint8)))
             for i in range(3)]
    pieces = []
    for p, rate in zip(psdus, (2, 5.5, 11)):
        pieces += [np.zeros(2200, np.complex64),
                   gb.modulate(p, rate).astype(np.complex64)]
    pieces.append(np.zeros(6600, np.complex64))
    air = np.concatenate(pieces)
    air += _noise(rng, len(air))
    kw = dict(input_rate="11m", window=8192, batch=2, overlap=6144,
              max_psdu=72, min_rate_mbps=2)
    got, counts = _radio_run(tsdl, "b", air, device="cpu",
                             radio=tsdl.RadioConfig(sample_rate=11e6), **kw)
    assert (got, counts) == _radio_run(
        jsdl, "b", air, radio=jsdl.RadioConfig(sample_rate=11e6), **kw)
    assert got == [(PEER, p[24:-4]) for p in psdus]
    assert counts["acks_tx"] == 3


# the node width of the node app's 24 Mbps traffic (windows of 32768, K =
# 11 decode candidates a window, the i8 wire) at a small batch
K_BOUND_KW = dict(window=32768, batch=2, max_frames_per_window=11,
                  max_psdu=256, min_rate_mbps=24, rate_mbps=None, wire="i8",
                  addr=ADDR)
K_BOUND_FRAMES = 60


def test_radio_phy_a_k_bound_equals_jax():
    """The node app's back-to-back 24 Mbps traffic (gap 900) brings about
    12.7 frames a hop of 29696 samples, more than the K = 11 candidates a
    window: the node decodes at most K frames a hop and the rest are not
    delivered.  The port's Radio delivers exactly the JAX Radio's payload
    list there, with its counters (ACKs among frame_ok)."""
    air = tapp.synthetic_traffic(K_BOUND_FRAMES, ADDR, mixed=False, rate=24,
                                 gap=900, device="cpu")
    got, counts = _radio_run(tsdl, "a", air, device="cpu", **K_BOUND_KW)
    assert (got, counts) == _radio_run(jsdl, "a", air, **K_BOUND_KW)
    # K binds: some frames are lost, none to the CRC
    assert 0.8 * K_BOUND_FRAMES < len(got) < K_BOUND_FRAMES
    assert counts["crc_fail"] == 0 and counts["acks_tx"] == len(got)
    assert counts["frame_ok"] > len(got)          # the ACKs decoded back


REPLAY_KW = dict(radio=tsdl.RadioConfig(sample_rate=40e6), input_rate="40m",
                 max_psdu=1600, min_rate_mbps=54)


def test_radio_replay_of_the_capture_decodes():
    """``replay`` feeds the 40 Msps capture in the wire's units: its 54 Mbps
    frame decodes with crc_fail 0.  The same radio fed the raw ADC counts
    (what the JAX package's ``Radio.replay`` writes) loses it."""
    with tsdl.Radio(phy="a", device="cpu", **REPLAY_KW) as r:
        r.replay(CAPTURE)
        got = list(r.rx(seconds=RX_SECONDS))
        assert r.stats.frame_ok > 0 and r.stats.crc_fail == 0
        assert all(len(p) == 1500 - 28 for _, p in got)
    with tsdl.Radio(phy="a", device="cpu", **REPLAY_KW) as r:
        r.inject(jnative.parse_dump(CAPTURE))
        assert list(r.rx(seconds=RX_SECONDS)) == []
        assert r.stats.frame_ok == 0 and r.stats.crc_fail > 0


def test_replay_samples_are_the_dump_in_wire_units():
    counts = tnative.parse_dump(CAPTURE)
    assert np.array_equal(counts, jnative.parse_dump(CAPTURE))
    x = tnative.replay_samples(CAPTURE)
    assert x.dtype == np.complex64
    assert np.array_equal(x, counts / np.float32(I16_SCALE))
    # raw counts saturate the int16 wire even at the AGC's 1/64 floor
    assert np.abs(counts).max() / 64.0 * I16_SCALE > 32767
    assert np.abs(x).max() * I16_SCALE <= 32767


def _status(out: str, key: str) -> int:
    return int(re.search(rf"\b{key}\s+(\d+)", out).group(1))


def test_node_app_dump_replay_decodes(capsys):
    """The port's node app replays the capture in the wire's units: its
    64-QAM frames decode, none fails the CRC."""
    tapp.main(["--dump", CAPTURE, "--seconds", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _status(out, "frame_ok") > 0, out
    assert _status(out, "crc_fail") == 0, out


def test_jax_node_app_raw_count_replay_loses_frames(capsys):
    """The JAX app replays raw counts (sora_tpu/apps/node.py:181-182), which
    clip at the wire: every frame of the capture fails the CRC."""
    assert japp.main(["--dump", CAPTURE, "--seconds", "3"]) == 1
    out = capsys.readouterr().out
    assert _status(out, "frame_ok") == 0, out
    assert _status(out, "crc_fail") > 0, out
