"""The port's node app and node soak tool on the CPU.

``synthetic_traffic`` draws its payloads and noise from the same numpy
generator as the JAX package's and modulates with the port's TX, so the
stream equals the JAX app's (golden-model frames) within 1e-5 for phy
"a", "b" and "n", and the CLI's default stream equals the JAX CLI's; the
CLI and the soak tool run end to end with ``--device cpu``.
"""

import time

import numpy as np
import pytest
import torch

from sora_tpu.apps import node as japp
from sora_tpu_torch.apps import node as tapp
from sora_tpu_torch.tools import node_soak

torch.set_num_threads(2)

ADDR = b"\x02SORA1"
TRAFFIC_ATOL = 1e-5       # the port's TX against the float64 golden model


@pytest.mark.parametrize("mixed,rate", [(False, 24), (True, 6)])
def test_synthetic_traffic_matches_jax(mixed, rate):
    got = tapp.synthetic_traffic(12, ADDR, mixed, rate, gap=500,
                                 device="cpu")
    want = japp.synthetic_traffic(12, ADDR, mixed, rate, gap=500)
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TRAFFIC_ATOL


def test_synthetic_traffic_phy_b_n_not_ported():
    """Both are ported.  phy "b": 11 Msps DSSS chips, mixed over the four
    rates or at one, the gap floored at 2400; phy "n": (2, N) 2x2 traffic,
    or (1, N) single-stream.  Each equals the JAX app's within the TX
    tolerance."""
    for mixed, rate, gap in ((True, 2, 900), (False, 5.5, 3000),
                             (False, 1, 100)):
        got = tapp.synthetic_traffic(6, ADDR, mixed, rate, gap=gap, phy="b",
                                     device="cpu")
        want = japp.synthetic_traffic(6, ADDR, mixed, rate, gap=gap, phy="b")
        assert got.dtype == want.dtype == np.complex64
        assert got.shape == want.shape and got.ndim == 1
        assert np.abs(got - want).max() < TRAFFIC_ATOL
    for mixed, mcs, gap in ((True, 8, 900), (False, 13, 4096),
                            (False, 4, 3300)):
        got = tapp.synthetic_traffic(10, ADDR, mixed, mcs, gap=gap,
                                     phy="n", device="cpu")
        want = japp.synthetic_traffic(10, ADDR, mixed, mcs, gap=gap,
                                      phy="n")
        assert got.dtype == want.dtype == np.complex64
        assert got.shape == want.shape == ((1 if mcs < 8 else 2),
                                           got.shape[-1])
        assert np.abs(got - want).max() < TRAFFIC_ATOL


class _Built(Exception):
    pass


@pytest.mark.parametrize("phy", ["a", "b", "n"])
def test_cli_default_stream_equals_jax_app(monkeypatch, phy):
    """With the same flags the port's CLI builds the JAX CLI's synthetic
    air: the JAX app passes the default gap (900, floored at 2400 for phy
    "b" and 3200 for phy "n"; sora_tpu/apps/node.py:191-192, :48, :52),
    and so does the port unless given --gap."""
    built = []

    def capture(*args, **kwargs):
        built.append(tapp_synthetic(*args, **kwargs))
        raise _Built

    tapp_synthetic = tapp.synthetic_traffic
    monkeypatch.setattr(tapp, "synthetic_traffic", capture)
    with pytest.raises(_Built):
        tapp.main(["--phy", phy, "--synthetic", "6", "--mixed", "--device",
                   "cpu"])
    want = japp.synthetic_traffic(6, ADDR, True,
                                  {"a": 6, "b": 2, "n": 8}[phy], phy=phy)
    got = built[0]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TRAFFIC_ATOL
    with pytest.raises(SystemExit):
        tapp.main(["--synthetic", "6", "--gap", "wide", "--device", "cpu"])


def test_node_app_decodes_synthetic_traffic(capsys):
    tapp.main(["--synthetic", "24", "--rate", "24", "--device", "cpu",
               "--seconds", "1.5", "--batch", "4"])
    out = capsys.readouterr().out
    assert "frame_ok           24" in out, out
    assert "24 frames, 24 acks" in out, out


class _PassClock:
    """The app's clock for its run loop, advancing 1 ms a reading: the
    loop makes the same number of passes however loaded the machine is.
    An idle pass still sleeps for real, so the ring's replay thread gets
    the core while the loop waits for samples."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t

    def sleep(self, seconds):
        time.sleep(seconds)


def test_node_app_phy_n_decodes_mixed_mcs(capsys, monkeypatch):
    """--phy n: two rings, mixed MCS 8-15 traffic with the gap at the
    node's hop (--gap hop), every frame decoded and ACKed."""
    monkeypatch.setattr(tapp, "time", _PassClock())
    tapp.main(["--phy", "n", "--synthetic", "16", "--mixed", "--device",
               "cpu", "--seconds", "1.5", "--batch", "4", "--gap", "hop"])
    out = capsys.readouterr().out
    assert "frame_ok           16" in out, out
    assert "16 frames, 16 acks" in out, out


def test_node_app_phy_b_decodes_mixed_rates(capsys, monkeypatch):
    """--phy b: 11 Msps chips on one ring, mixed 1/2/5.5/11 Mbps traffic
    with the gap at the node's hop (the DSSS receiver locks on the first
    burst of a window), every frame decoded and ACKed."""
    monkeypatch.setattr(tapp, "time", _PassClock())
    tapp.main(["--phy", "b", "--synthetic", "12", "--mixed", "--device",
               "cpu", "--seconds", "1.5", "--batch", "2", "--gap", "hop"])
    out = capsys.readouterr().out
    assert "frame_ok           12" in out, out
    assert "12 frames, 12 acks" in out, out


@pytest.mark.parametrize("phy", ["a", "b"])
def test_node_soak_tool_runs(phy, capsys):
    """The soak at phy "a" (20 Msps OFDM) and phy "b" (11 Msps chips, the
    JAX soak's ``--phy b``): exit 0 with frames decoded."""
    rc = node_soak.main(["--phy", phy, "--seconds", "1.0", "--device",
                         "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"soak: phy={phy} " in out, out
    frames = int(out.split("soak OK (")[1].split()[0])
    assert frames > 0, out


def test_layered_config_equals_jax(tmp_path, monkeypatch):
    """defaults < file < env < overrides resolve the port's NodeConfig as
    the JAX package resolves its own."""
    import dataclasses
    import json

    from sora_tpu.runtime.node import NodeConfig as JNodeConfig
    from sora_tpu.util.config import load_config as jload
    from sora_tpu_torch.runtime.node import NodeConfig
    from sora_tpu_torch.util.config import dump_config, load_config

    f = tmp_path / "node.json"
    f.write_text('{"window": 2048, "batch": 4, "ack_rate": 12, '
                 '"max_psdu": 64, "min_rate_mbps": 24, "addr": "\\u0002AB"}')
    monkeypatch.setenv("SORA_BATCH", "16")
    monkeypatch.setenv("SORA_WIRE", "i8")
    over = {"ack_rate": 24, "window": None}
    cfg = load_config(NodeConfig, path=str(f), overrides=over)
    assert (cfg.window, cfg.batch, cfg.ack_rate, cfg.wire) == (
        2048, 16, 24, "i8")
    assert cfg.addr == b"\x02AB"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jload(JNodeConfig, path=str(f), overrides=over))
    assert json.loads(dump_config(cfg))["addr"] == "\x02AB"
    with pytest.raises(KeyError):
        load_config(NodeConfig, overrides={"nonsense": 1})


def test_stopwatch_report():
    from sora_tpu_torch.util.stopwatch import MacStopwatch

    sw = MacStopwatch(sample_rate=20e6)
    sw.add(20000, 0.0005)      # 1 ms of signal in 0.5 ms -> ratio 0.5
    sw.add(20000, 0.002)       # ratio 2.0
    with sw.segment(200000):
        pass
    rep = sw.report()
    assert rep.segments == 3 and rep.max_ratio == pytest.approx(2.0)
    assert rep.frac_over == pytest.approx(1 / 3)
    assert rep.realtime and "33.3% segments over" in str(rep)
    sw.reset()
    assert sw.report().segments == 0
