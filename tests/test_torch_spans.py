"""The port's stage spans and Viterbi step counter (``util.spans``) in the
11a receivers, on the CPU, and the benchmark's readers of them.

* With no profiler and no ``capture()`` a receiver call records nothing
  and never enters ``record_function``.
* Under ``torch.profiler`` each of ``rx_pipeline``, ``rx_pipeline_auto``
  and ``rx_pipeline_sharded`` (a gloo world of one) leaves its stage
  spans in the exported Chrome trace, in order, under one ``rx.call``
  per call.
* ``viterbi.steps_run`` counts rows x windows x (block + 2 x overlap) for
  the three window geometries of ``decode_auto``.
* Outputs are bitwise equal with spans on and off.
* The five readers of ``benchmark/metrics`` read hand-set totals and read
  nothing on a call-count mismatch.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import run as brun
from benchmark import trace as btrace
from sora_tpu_torch.dsp import viterbi as dvit
from sora_tpu_torch.golden import dot11a_np as golden
from sora_tpu_torch.mac import frame as fr
from sora_tpu_torch.ops import viterbi_cuda as vc
from sora_tpu_torch.parallel import shard as tsh
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.util import spans
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

STAGES = ["rx.sync", "rx.equalize", "rx.demap", "rx.viterbi", "rx.tail"]
READERS = {"sync_ms": "rx.sync", "equalize_ms": "rx.equalize",
           "demap_ms": "rx.demap", "tail_ms": "rx.tail"}


@pytest.fixture(autouse=True)
def _clean():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def batch():
    """Four 24 Mb/s frames of 60 bytes in streams of 1600 samples."""
    rng = np.random.default_rng(5)
    x = np.zeros((4, 1600), np.complex64)
    for i in range(4):
        psdu = fr.build_data_frame(bytes(rng.integers(0, 256, 32,
                                                      dtype=np.uint8)), seq=i)
        w = golden.modulate(psdu, 24).astype(np.complex64)
        x[i, 40 + 17 * i: 40 + 17 * i + w.size] = w
    x += ((rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
          * 0.01).astype(np.complex64)
    return x


@pytest.fixture(scope="module")
def world1():
    assert not torch.distributed.is_initialized()
    mesh = tsh.make_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def _calls(batch, world1=None):
    """The three entries, each as a function of nothing."""
    x = torch.from_numpy(batch)
    out = {"rx_pipeline": lambda: trx.rx_pipeline(x, 24, max_psdu=64),
           "rx_pipeline_auto": lambda: trx.rx_pipeline_auto(
               x, max_psdu=64, n_frames=2, n_decode=4, min_rate_mbps=24)}
    if world1 is not None:
        out["rx_pipeline_sharded"] = lambda: tsh.rx_pipeline_sharded(
            batch, world1, 24, max_psdu=64, device="cpu")
    return out


def test_inactive_spans_record_nothing(batch, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for call in _calls(batch).values():
        assert fetch(call())["ok"].all()
    assert spans.totals() == {"spans": {}, "counters": {}}
    assert entered == []
    with spans.capture():
        trx.rx_pipeline(torch.from_numpy(batch), 24, max_psdu=64)
    assert entered[0] == "rx.call" and sorted(set(entered)) == sorted(
        ["rx.call"] + STAGES)


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                  for e in ev if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith(("rx.", "shard.")))


def _check_nesting(ann, calls):
    roots = [a for a in ann if a[2] == "rx.call"]
    assert len(roots) == calls
    for s, e, _ in roots:
        inner = [a for a in ann if s <= a[0] and a[1] <= e
                 and a[2] != "rx.call"]
        assert [a[2] for a in inner] == STAGES
    # every stage span lies inside a root span
    stages = [a for a in ann if a[2] in STAGES]
    assert len(stages) == calls * len(STAGES)


@pytest.mark.parametrize("entry", ["rx_pipeline", "rx_pipeline_auto"])
def test_profiler_trace_holds_the_stage_spans(batch, entry, tmp_path):
    call = _calls(batch)[entry]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            assert fetch(call())["ok"].all()
    _check_nesting(_annotations(prof, tmp_path), 2)
    t = spans.totals()
    assert {n: v["calls"] for n, v in t["spans"].items()} == {
        n: 2 for n in ["rx.call"] + STAGES}
    # the CPU spans time no device
    assert all(v["device_ms"] is None and v["host_ms"] > 0
               for v in t["spans"].values())
    assert t["counters"]["viterbi.steps_run"] > 0


def test_sharded_trace_holds_the_stage_spans_and_gather(batch, world1,
                                                         tmp_path):
    call = _calls(batch, world1)["rx_pipeline_sharded"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            got = fetch(tsh.gather_rows(call(), world1))
    assert got["ok"].all()
    ann = _annotations(prof, tmp_path)
    _check_nesting([a for a in ann if a[2] != "shard.gather"], 2)
    # one gather span per call, not one per leaf of the tree, after it
    gathers = [a for a in ann if a[2] == "shard.gather"]
    roots = [a for a in ann if a[2] == "rx.call"]
    assert len(gathers) == 2
    assert all(r[1] <= g[0] for r, g in zip(roots, gathers))
    assert spans.totals()["spans"]["shard.gather"]["calls"] == 2


@pytest.mark.parametrize("T,block,overlap", [(4100, 1024, 64),
                                             (2000, 512, 64),
                                             (300, 304, 0)])
def test_steps_run_counts_the_windows(T, block, overlap):
    soft = torch.from_numpy(np.random.default_rng(T).normal(
        size=(3, T, 2)).astype(np.float32))
    with spans.capture(), spans.span("t"):
        a = dvit.decode_auto(soft, terminated=True)
    want = 3 * -(-T // block) * (block + 2 * overlap)
    assert spans.totals()["counters"] == {"viterbi.steps_run": want}
    # the geometry decode_auto chose: the same bits from decode_blocks,
    # called outside a recording span and so not counted
    b = vc.decode_blocks(soft, block=block, overlap=overlap,
                         terminated=True)
    assert torch.equal(a, b)
    assert spans.totals()["counters"]["viterbi.steps_run"] == want


def test_steps_run_counts_every_leading_row_inside_a_span():
    soft = torch.zeros(2, 3, 40, 2)
    with spans.capture():
        with spans.span("t"):
            vc.decode_blocks(soft, block=16, overlap=8)
        vc.decode_blocks(soft, block=16, overlap=8)   # no span: not counted
    vc.decode_blocks(soft, block=16, overlap=8)       # not recording
    assert spans.totals()["counters"] == {
        "viterbi.steps_run": 6 * 3 * (16 + 16)}


def test_outputs_equal_with_spans_on_and_off(batch):
    for name, call in _calls(batch).items():
        off = fetch(call())
        with spans.capture():
            on = fetch(call())
        assert sorted(on) == sorted(off)
        for k in off:
            assert np.array_equal(on[k], off[k]), (name, k)


def test_capture_nests_and_reset_clears():
    with spans.capture():
        with spans.capture():
            with spans.span("a"):
                spans.count("c", 2)
        with spans.span("a"):
            pass
    with spans.span("a"):
        spans.count("c", 5)
        spans.stage("s")
    t = spans.totals()
    assert t["spans"]["a"]["calls"] == 2 and t["counters"] == {"c": 2}
    spans.reset()
    assert spans.totals() == {"spans": {}, "counters": {}}


def test_stages_split_the_innermost_span(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans.stage("outside")                  # no span open: nothing
        with spans.span("root"):
            spans.stage("one")
            with spans.span("inner"):
                spans.stage("deep")
            spans.stage("two")
        with spans.span("bare"):
            pass
    t = spans.totals()["spans"]
    assert {n: v["calls"] for n, v in t.items()} == {
        "root": 1, "one": 1, "inner": 1, "deep": 1, "two": 1, "bare": 1}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in json.loads(
        path.read_text())["traceEvents"] if e.get("cat") == "user_annotation"}
    within = lambda a, b: ev[b][0] <= ev[a][0] and ev[a][1] <= ev[b][1]
    assert all(within(n, "root") for n in ("one", "inner", "deep", "two"))
    assert within("inner", "one") and within("deep", "inner")
    assert ev["one"][1] <= ev["two"][0]
    assert not within("bare", "root") and "outside" not in ev


def _stretch(calls=4, steps=12096 * 8):
    return btrace.Stretch(calls=calls, steps=steps, window=(0.0, 1.0),
                          device=[], host=[])


def _totals(calls=4, device_ms=2.0, steps_run=13824 * 8):
    names = ["rx.call"] + STAGES
    return {"spans": {n: {"calls": calls, "device_ms": device_ms * (i + 1),
                          "host_ms": 1.0} for i, n in enumerate(names)},
            "counters": {"viterbi.steps_run": steps_run}}


@pytest.mark.parametrize("metric", sorted(READERS) + ["viterbi_useful_pct"])
def test_readers_of_the_program_spans(metric, monkeypatch):
    read = brun.metric_reader(metric)
    t = _totals()
    monkeypatch.setattr(spans, "totals", lambda: t)
    if metric == "viterbi_useful_pct":
        want = 100.0 * 12096 / 13824
    else:
        want = t["spans"][READERS[metric]]["device_ms"] / 4
    assert read(_stretch()) == pytest.approx(want)
    # spans that cover another number of calls than the stretch's
    assert read(_stretch(calls=5)) is None
    # no spans recorded (a program without them, or tracing off)
    monkeypatch.setattr(spans, "totals",
                        lambda: {"spans": {}, "counters": {}})
    assert read(_stretch()) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_stage_readers_need_device_times(metric, monkeypatch):
    t = _totals()
    for v in t["spans"].values():
        v["device_ms"] = None
    monkeypatch.setattr(spans, "totals", lambda: t)
    assert brun.metric_reader(metric)(_stretch()) is None
