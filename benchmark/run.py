"""One run of one benchmark cell of the port.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads the cell's configuration,
traffic mix and limits by the names in ``BENCHMARK.json``, makes the pool
of input batches from the seed (the frozen golden transmitter, noise on
the card), warms up the receiver on every batch of the pool, then for
``--seconds`` keeps two batches in flight: it issues batch i + 1 before
it waits for batch i's outputs on the host (``util.xfer.Pending``).
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` traces
a stretch of the window with torch.profiler and reports its per-layer
metrics.  After the window the judged batches are held to the frames
sent and the plain reference (:mod:`benchmark.judge`); each compared
number and its limit go to the last lines of stderr and, under
``checks``, last in the result.  The result is the last line of stdout.
Before CUDA starts, each process is set to the CPUs beside its card
(``benchmark.affinity``).  A cell on several cards runs one process a
card (``benchmark.ranks``, which bounds every wait of the ranks): this
process is rank 0; it times the window, fetches the rows the ranks
all-gather, and judges them.

Exits nonzero without a result when CUDA or the cell's cards are
missing, when the program cannot be imported, and when the process holds
``jax``, ``jaxlib``, ``flax`` or ``sora_tpu`` after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sora_tpu"})
CPUS = os.sched_getaffinity(0)   # the CPUs the run was given
DEPTH = 2                    # batches in flight


def log(*a):
    """One line on stderr, written whole (ranks share the stream)."""
    sys.stderr.write(" ".join(str(v) for v in a) + "\n")
    sys.stderr.flush()


def fixed_caches() -> None:
    """Compile caches in fixed directories of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        d = CACHE / sub
        d.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(d)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    here: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under
    ``root/benchmark``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name, w["chips"],
                json.loads((root / conf["file"]).read_text()),
                json.loads((here / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
                json.loads((here / "limits" / f"{name}.json").read_text()),
                mine(spec["end_to_end"]), mine(spec["per_layer"]), here)


def metric_reader(name: str, here: Path = HERE):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_point(mix: dict, mesh=None, device=None):
    """The mix's receiver call as a function of the input batch; on a
    mesh the call takes this rank's Shard, the mesh and this rank's
    device, and its row chunks are all-gathered in row order
    (``gather_rows``)."""
    e = mix["entry"]
    mod, fn = e["call"].split(":")
    f = getattr(importlib.import_module(mod), fn)
    args, kwargs = e.get("args", []), e.get("kwargs", {})
    if mesh is None:
        return lambda x: f(x, *args, **kwargs)
    from sora_tpu_torch.parallel.shard import gather_rows

    return lambda x: gather_rows(f(x, mesh, *args, device=device,
                                   **kwargs), mesh)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


@dataclass
class Window:
    """What the measured window recorded (host clock, seconds)."""

    t0: float = 0.0
    t_last: float = 0.0
    latencies: list = field(default_factory=list)
    issue_s: list = field(default_factory=list)
    samples: int = 0
    rows: int = 0
    done: int = 0
    kept: list = field(default_factory=list)    # (pool index, outputs)
    stretch: object = None


class _Landed:
    """A rank that does not fetch waits for its call's work alone."""

    def __init__(self, tree):
        import torch

        self._event = None
        if torch.cuda.is_available():
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self):
        if self._event is not None:
            self._event.synchronize()


class Loop:
    """Issues receiver calls on the pool, DEPTH in flight, and fetches
    their outputs (on a mesh: rank 0 fetches the gathered rows, the other
    ranks only wait for their calls)."""

    def __init__(self, entry, inputs, traffic, torch, seed: int, keep: int,
                 fetch: bool = True):
        from sora_tpu_torch.util.xfer import Pending

        self.Pending = Pending if fetch else _Landed
        self.torch = torch
        self.entry = entry
        self.inputs = inputs
        self.batches = traffic.batches
        self.q = deque()
        self.i = 0
        self.keep = keep
        # a stream of its own, apart from the generator's children
        self.rng = np.random.default_rng(np.random.SeedSequence(
            int(seed) % (1 << 64), spawn_key=(1 << 20,)))

    def issue(self, win: Window | None):
        j = self.i % len(self.inputs)
        rf = self.torch.profiler.record_function
        tc = time.perf_counter()
        with rf("bench.rx_call"):
            out = self.entry(self.inputs[j])
        p = self.Pending(out)
        if win is not None:
            win.issue_s.append(time.perf_counter() - tc)
        self.q.append((j, tc, p))
        self.i += 1

    def complete(self, win: Window | None, t_end: float = float("inf")):
        """Wait for the oldest batch; count it in ``win`` if it landed
        by t_end.  Returns False when it landed after t_end."""
        j, tc, p = self.q.popleft()
        with self.torch.profiler.record_function("bench.fetch"):
            res = p.get()
        td = time.perf_counter()
        if win is None:
            return True
        if td > t_end:
            return False
        b = self.batches[j]
        win.latencies.append(td - tc)
        win.samples += b.samples
        win.rows += b.x.shape[0]
        win.t_last = td
        win.done += 1
        # reservoir sample of the window's batches for the judge
        if len(win.kept) < self.keep:
            win.kept.append((j, res))
        else:
            r = int(self.rng.integers(0, win.done))
            if r < self.keep:
                win.kept[r] = (j, res)
        return True

    def drain(self):
        while self.q:
            self.complete(None)

    def run(self, n: int, win: Window | None = None):
        """n calls, DEPTH in flight, starting and ending drained."""
        for _ in range(n):
            self.issue(win)
            if len(self.q) >= DEPTH:
                self.complete(win)
        self.drain()


class Plan:
    """When the traced stretch starts and when the window's calls stop,
    as call indices.  Rank 0 decides; on a mesh it posts its decisions in
    the ranks' store a few calls ahead (a rank runs at most DEPTH calls
    ahead of another: each waits for its own calls, and every call holds
    a collective), and the other ranks read them there."""

    AHEAD = DEPTH + 1

    def __init__(self, store=None, rank: int = 0):
        self.store, self.rank = store, rank
        self.trace_at = self.stop_at = None
        self.calls = 0

    def post(self, key: str, value: str) -> None:
        if self.store is not None:
            self.store.set(key, value)

    def decide_trace(self, i: int, calls: int) -> None:
        self.trace_at = i + (self.AHEAD if self.store else 0)
        self.calls = calls
        self.post("trace", f"{self.trace_at},{calls}")

    def decide_stop(self, i: int) -> None:
        self.stop_at = i + (self.AHEAD if self.store else 0)
        self.post("stop", str(self.stop_at))

    def read(self) -> None:
        """A following rank's look at the store (never waits)."""
        if self.trace_at is None and self.store.check(["trace"]):
            t, n = self.store.get("trace").decode().split(",")
            self.trace_at, self.calls = int(t), int(n)
        if self.stop_at is None and self.store.check(["stop"]):
            self.stop_at = int(self.store.get("stop").decode())


def measure(loop: Loop, seconds: float, trace: bool, steps_of,
            plan: Plan) -> Window:
    """The measured window; with ``trace`` a profiled stretch in it.
    Rank 0 times it; a following rank makes the same calls."""
    from benchmark import trace as T

    win = Window()
    win.t0 = time.perf_counter()
    t_end = win.t0 + seconds
    lead = plan.rank == 0
    while True:
        if not lead:
            plan.read()
        elif (trace and plan.trace_at is None and win.done >= 2
              and time.perf_counter() - win.t0 >= 0.25 * seconds):
            period = (win.t_last - win.t0) / win.done
            plan.decide_trace(loop.i, int(min(32, max(8, round(
                0.6 / period)))))
        if loop.i == plan.trace_at:
            loop.drain()
            first, n = loop.i, plan.calls
            dev, host, span = T.profile(lambda k: loop.run(k), n)
            steps = sum(steps_of((first + k) % len(loop.inputs))
                        for k in range(n))
            win.stretch = T.Stretch(n, steps, span, dev, host)
            continue
        if plan.stop_at is not None and loop.i >= plan.stop_at:
            break
        loop.issue(win if lead else None)
        if len(loop.q) >= DEPTH and not loop.complete(
                win if lead else None, t_end) and plan.stop_at is None:
            plan.decide_stop(loop.i)
    loop.drain()
    return win


def end_to_end(win: Window, setup_s: float) -> dict:
    """The end-to-end metrics of a window: the samples of every batch
    whose outputs reached the host in it over its time, the 95th
    percentile of all its batches' latencies, and the set-up time."""
    elapsed = win.t_last - win.t0
    return {"rx_msps": win.samples / elapsed / 1e6 if elapsed > 0 else 0.0,
            "batch_p95_ms": float(np.percentile(
                np.asarray(win.latencies) * 1e3, 95)),
            "setup_s": setup_s}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict | None = None,
             root: Path = ROOT) -> dict:
    """One run; returns the result line's object.  ``device`` None is the
    card (refused without CUDA or with fewer cards than the cell's), and
    the process then runs on the CPUs beside it (``benchmark.affinity``);
    ``overrides`` update the traffic mix (tests and calibration).  A cell
    on several chips starts one process per further card
    (``benchmark.ranks``, which bounds every wait of the ranks) and is
    rank 0 itself."""
    fixed_caches()
    cell = load_cell(name, root)
    if device is None:
        from benchmark import affinity

        affinity.pin(0, cell.chips, CPUS)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{name} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} found")
        device = "cuda"
    if cell.chips == 1:
        return run_rank(cell, seed, seconds, trace, device, overrides)
    from benchmark import ranks

    ctx = ranks.Context(0, cell.chips, ranks.free_port())
    ranks.guard(seconds)
    workers = ranks.start(name, seed, seconds, trace, ctx, device,
                          overrides, root, CPUS)
    watch = ranks.Watch(workers)
    try:
        result = run_rank(cell, seed, seconds, trace, device, overrides,
                          ctx)
    except BaseException:
        watch.close()
        ranks.stop(workers, "rank 0 failed")
        ranks.fail(0)
    watch.close()
    ranks.reap(workers)
    ranks.unguard()
    return result


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, ctx=None):
    """One rank's run (the only rank on one chip): set-up, the window,
    then on rank 0 the judge and the result; a following rank posts its
    peak memory and traced times to rank 0 and returns None."""
    import torch

    mix = {**cell.mix, **(overrides or {})}
    device = torch.device(device)
    cuda = device.type == "cuda"
    rank = ctx.rank if ctx else 0
    parts = {"import": time.perf_counter() - T_START}

    t = time.perf_counter()
    mesh = store = None
    if ctx:
        device, mesh, store = ctx.join(device, mix["entry"]["mesh"])
    if cuda:
        if device.index is not None:
            torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    parts["cuda_context"] = time.perf_counter() - t
    t = time.perf_counter()
    entry = entry_point(mix, mesh, device)
    if cuda:
        from sora_tpu_torch.ops import viterbi_cuda
        viterbi_cuda._library()
    parts["program_load"] = time.perf_counter() - t

    from benchmark import generator as G

    t = time.perf_counter()
    traffic = G.build(mix, cell.config, seed, device)
    phy = G.phy_module(cell.config)
    inputs = [phy.entry_input(b.x) for b in traffic.batches]
    rows = slice(None)
    if mesh is not None:
        inputs, rows = shard_inputs(inputs, mesh)
    sync()
    parts["inputs"] = time.perf_counter() - t

    t = time.perf_counter()
    loop = Loop(entry, inputs, traffic, torch, seed, mix["judged"],
                fetch=rank == 0)
    loop.run(len(inputs) + DEPTH)
    sync()
    parts["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    log(f"rank {rank}: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; total {setup_s:.3f} s")

    steps_of = lambda j: int(traffic.batches[j].row_steps[rows].sum())
    win = measure(loop, seconds, trace, steps_of, Plan(store, rank))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    st = win.stretch
    mine = {"peak": peak}
    if st is not None:
        mine.update(st.own())
    if rank:
        store.set(f"rank{rank}", json.dumps(mine))
        ctx.leave()
        return None
    peers = [mine]
    if ctx:
        peers += [json.loads(store.get(f"rank{r}"))
                  for r in range(1, ctx.world)]
        ctx.leave()
    peak = max(p["peak"] for p in peers)
    elapsed = win.t_last - win.t0
    log(f"window {elapsed:.3f} s: {win.done} batches, "
        f"{win.samples} samples, peak memory {peak} bytes")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the process holds {', '.join(bad)}")

    kept = win.kept
    del loop, entry, inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge_kept(kept, traffic, phy, mix)
    # a number the judge could not read counts as over its limit
    checks = {k: [numbers.get(k), lim] for k, lim in cell.limits.items()}
    correct = bool(kept) and all(v is not None and v <= lim
                                 for v, lim in checks.values())

    card = card_line() if cuda else "cpu"
    result = {"correct": correct, "attempted": win.rows,
              "failed": int(numbers.get("wrong", 0)), "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": len(peers) if cuda else 1,
                         "memory_peak_bytes": peak}}
    if not trace:
        values = end_to_end(win, setup_s)
        log(f"batch latency ms: median "
            f"{np.median(win.latencies) * 1e3:.3f}, p95 "
            f"{values['batch_p95_ms']:.3f} over {win.done} batches")
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        if st is None:
            raise SystemExit("the window ended before its traced stretch")
        st.issue_ms = [s * 1e3 for s in win.issue_s]
        st.ranks = peers
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.here)(st)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["device"].update({
            "busy_s": float(np.mean([p["busy_s"] for p in peers])),
            "window_s": float(np.mean([p["window_s"] for p in peers]))})
        result["breakdown"] = st.breakdown()
        log(f"traced stretch: {st.calls} calls, {len(st.kernels())} "
            f"kernels, window {st.window_s:.4f} s, busy {st.busy_s():.4f} s")
    log(f"card: {card}")
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} (limit {lim!r})")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def shard_inputs(inputs, mesh):
    """This rank's (dp, sp) blocks of the pool's global batches, and the
    rows of the global batch that its decode chunk holds."""
    from sora_tpu_torch.parallel.shard import Shard

    dp, sp = mesh.mesh.shape
    d, s = mesh.get_coordinate()
    out = []
    for x in inputs:
        B, N = x.shape[0], x.shape[-1]
        blk = x[d * B // dp: (d + 1) * B // dp][..., s * N // sp:
                                                 (s + 1) * N // sp]
        out.append(Shard(blk.contiguous(), tuple(x.shape)))
    B = inputs[0].shape[0]
    r = d * sp + s
    return out, slice(r * B // (dp * sp), (r + 1) * B // (dp * sp))


def judge_kept(kept, traffic, phy, mix) -> dict:
    """The judge's numbers over the kept batches: counts summed, gaps by
    their widest."""
    from benchmark import judge as J

    t = time.perf_counter()
    numbers = {}
    for j, out in kept:
        got = J.judge(out, traffic.batches[j], traffic, phy, mix)
        for k, v in got.items():
            numbers[k] = (v + numbers.get(k, 0) if k in ("wrong", "rows",
                                                        "ambiguous")
                          else max(v, numbers.get(k, 0.0)))
    log(f"reference and judge: {time.perf_counter() - t:.3f} s over "
        f"{len(kept)} batches, {numbers.get('rows', 0)} rows "
        f"({numbers.get('ambiguous', 0)} streams with an onset tie left "
        f"out of the candidate match)")
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
