"""Readings for the limits of ``correct`` and sizing sweeps, in one
process on the card (the benchmark's runs never call it).

    python3 -m benchmark.calibrate readings --workload a54-sat \
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 3
    python3 -m benchmark.calibrate sweep --workload a54-sat \
        --streams 512,1024,2048,4096 --seconds 5

``readings`` runs the cell as a run does (a short window at the cell's
own size and load, the judged batches held to the reference) once per
seed and prints each seed's numbers; then, per control seed, puts the
reference in the program's place on every batch of the pool, in TF32
products and in bfloat16, and prints the numbers the judge gives them.
``sweep`` runs the cell at other stream counts and prints the window's
rate, the traced idle share and the peak memory.  One JSON line each.
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
    a = ap.parse_args(argv)
    {"readings": readings, "sweep": sweep}[a.cmd](a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
