"""Readings for the limits of ``correct`` and sizing sweeps, in one
process on the card (the benchmark's runs never call it).

    python3 -m benchmark.calibrate readings --workload a54-sat-8k \
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 3
    python3 -m benchmark.calibrate sweep --workload a54-sat-8k \
        --streams 2048,4096,8192 --seconds 5
    python3 -m benchmark.calibrate split --workload a54-sat-8k --calls 250

``readings`` runs the cell as a run does (a short window at the cell's
own size and load, the judged batches held to the reference) once per
seed and prints each seed's numbers; then, per control seed, puts the
reference in the program's place on every batch of the pool, in TF32
products and in bfloat16, and prints the numbers the judge gives them.
``sweep`` runs the cell at other stream counts and prints the window's
rate, the traced idle share and the peak memory.  ``split`` says who
leads at the cell's own size and load, on one card (a mesh cell's one
card's rows through its entry on a (1, 1) mesh): the host's issue ms a
call with the program's spans off, then the device ms a call of each of
its spans inside ``spans.capture()`` (no profiler), ``rounds`` times.
One JSON line each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def _ints(s: str):
    return [int(v) for v in s.split(",") if v]


def readings(a) -> None:
    import torch

    for seed in _ints(a.seeds):
        r = run.run_cell(a.workload, seed, a.seconds, False)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    from benchmark import generator as G
    from benchmark import judge as J
    from benchmark.reference import ofdm as R

    cell = run.load_cell(a.workload)
    phy = G.phy_module(cell.config)
    dev = torch.device("cuda")
    for seed in _ints(a.control_seeds):
        traffic = G.build(cell.mix, cell.config, seed, dev)
        for prec in (R.TF32, R.BF16):
            t = time.perf_counter()
            nums = {}
            for b in traffic.batches:
                got = J.judge(J.control(b, traffic, phy, cell.mix, prec), b,
                              traffic, phy, cell.mix)
                for k, v in got.items():
                    nums[k] = (nums.get(k, 0) + v
                               if k in ("wrong", "rows", "ambiguous")
                               else max(nums.get(k, 0.0), v))
            print(json.dumps({"side": f"control-{prec.name}", "seed": seed,
                              "numbers": nums,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
        del traffic
        torch.cuda.empty_cache()


def sweep(a) -> None:
    for B in _ints(a.streams):
        out = {"streams": B}
        for trace in (False, True):
            r = run.run_cell(a.workload, a.seed, a.seconds, trace,
                             overrides={"streams": B})
            out.update({k: v["value"] for k, v in r["metrics"].items()})
            out["memory_peak_bytes"] = r["device"]["memory_peak_bytes"]
            out["correct_" + ("trace" if trace else "plain")] = r["correct"]
            if trace:
                out["busy_s"] = r["device"]["busy_s"]
                out["window_s"] = r["device"]["window_s"]
                out["breakdown"] = r["breakdown"]
        print(json.dumps(out), flush=True)


def split(a) -> None:
    from benchmark import affinity

    affinity.pin(0, 1, run.CPUS)
    import numpy as np
    import torch
    from benchmark import generator as G
    from sora_tpu_torch.util import spans

    cell = run.load_cell(a.workload)
    mix, mesh, dev = dict(cell.mix), None, torch.device("cuda")
    if "mesh" in mix["entry"]:
        from sora_tpu_torch.parallel import shard

        m = mix["entry"]["mesh"]
        mix["streams"] //= m["dp"] * m["sp"]
        mesh = shard.make_mesh(1, dp=1, device="cuda")
    entry = run.entry_point(mix, mesh, dev)
    traffic = G.build(mix, cell.config, a.seed, dev)
    inputs = [G.phy_module(cell.config).entry_input(b.x)
              for b in traffic.batches]
    if mesh is not None:
        inputs, _ = run.shard_inputs(inputs, mesh)
    loop = run.Loop(entry, inputs, traffic, torch, a.seed, 0)
    loop.run(len(inputs) + run.DEPTH)
    for k in range(a.rounds):
        win = run.Window(t0=time.perf_counter())
        loop.run(a.calls, win)
        spans.reset()
        with spans.capture():
            loop.run(a.calls)
        torch.cuda.synchronize()
        dev_ms = {n: v["device_ms"] / v["calls"]
                  for n, v in spans.totals()["spans"].items()
                  if v["device_ms"] is not None}
        host = 1e3 * float(np.mean(win.issue_s))
        print(json.dumps({
            "workload": a.workload, "round": k, "streams": mix["streams"],
            "calls": a.calls, "host_issue_ms": host, "device_ms": dev_ms,
            "device_over_host": dev_ms["rx.call"] / host,
            "rx_msps": win.samples / (win.t_last - win.t0) / 1e6,
            "card": run.card_line()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", default="")
    r.add_argument("--control-seeds", default="")
    r.add_argument("--seconds", type=float, default=3.0)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--streams", required=True)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--seconds", type=float, default=5.0)
    p = sub.add_parser("split")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--calls", type=int, default=250)
    p.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    {"readings": readings, "sweep": sweep, "split": split}[a.cmd](a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
