"""The metric arithmetic: the rate over the whole window, the p95 over
all batches, the readers of the traced stretch, the roofline's count and
peak."""

import json

import numpy as np
import pytest

from benchmark import roofline, run
from benchmark import trace as T


def test_rate_over_the_whole_window_and_p95_over_all_batches():
    lat = list(np.linspace(0.010, 0.050, 401))
    win = run.Window(t0=100.0, t_last=102.5, latencies=lat,
                     samples=5_000_000, done=401)
    v = run.end_to_end(win, 12.0)
    assert v["rx_msps"] == pytest.approx(5_000_000 / 2.5 / 1e6)
    assert v["batch_p95_ms"] == pytest.approx(48.0)
    assert v["setup_s"] == 12.0


def test_viterbi_roofline_count_and_peak():
    steps = 2048 * 12096
    assert roofline.PEAK_OPS == 133.8e12 and roofline.PEAK_BYTES == 3.35e12
    least = roofline.viterbi_least_time(steps)
    assert least == pytest.approx(192 * steps / 133.8e12)
    assert 192 * steps / 133.8e12 > 1.125 * steps / 3.35e12
    assert least == pytest.approx(35.55e-6, rel=1e-3)


def _stretch():
    dev = [("k_a", 0.000, 0.002, "kernel"), ("k_b", 0.001, 0.002, "kernel"),
           ("viterbi_r4_kernel", 0.004, 0.001, "kernel"),
           ("Memcpy DtoH", 0.006, 0.001, "gpu_memcpy"),
           ("k_a", 0.008, 0.001, "kernel"),
           ("viterbi_r4_kernel", 0.0095, 0.0005, "kernel")]
    host = [("bench.window", 0.0, 0.010), ("bench.rx_call", 0.0, 0.004),
            ("aten::mul", 0.0031, 0.0008), ("bench.fetch", 0.0045, 0.003)]
    return T.Stretch(calls=2, steps=1000, window=(0.0, 0.010), device=dev,
                     host=host, issue_ms=[2.0, 4.0])


def _reader(name):
    return run.metric_reader(name)


def test_readers_of_the_stretch():
    st = _stretch()
    assert _reader("launches_per_batch")(st) == 2.5
    assert _reader("host_issue_ms")(st) == 3.0
    assert _reader("viterbi_ms")(st) == pytest.approx(0.75)
    assert _reader("viterbi_roofline_pct")(st) == pytest.approx(
        100 * roofline.viterbi_least_time(1000) / 0.0015)
    # busy: [0, 3] + [4, 5] + [6, 7] + [8, 9] + [9.5, 10] ms of 10
    assert _reader("device_idle_pct")(st) == pytest.approx(35.0)


def test_readers_find_nothing_and_return_nothing():
    st = T.Stretch(calls=2, steps=0, window=(0.0, 1.0), device=[], host=[])
    assert _reader("viterbi_ms")(st) is None
    assert _reader("viterbi_roofline_pct")(st) is None
    assert _reader("host_issue_ms")(st) is None


def test_breakdown_names_the_host_in_each_gap():
    b = _stretch().breakdown()
    ops = dict(b["device_ops"])
    assert ops["k_a"] == pytest.approx(0.003)
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(0.001)
    assert gaps["bench.fetch"] == pytest.approx(0.002)
    assert gaps["host (no traced op)"] == pytest.approx(0.0005)
    assert sum(gaps.values()) == pytest.approx(0.0035)


def test_chrome_trace_is_read(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0,
           "dur": 2.0},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3.0}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    dev, host, window = T.read_chrome_trace(str(p))
    assert [d[0] for d in dev] == ["k"]
    assert dev[0][1:3] == pytest.approx((10e-6, 5e-6))
    assert window == pytest.approx((0.0, 100e-6))
    assert [h[0] for h in host] == ["bench.window", "aten::add"]
