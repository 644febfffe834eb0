"""A run with the timed path broken underneath comes out not correct:
for each fault a receiver cell can have, the harness driven end to end
on the CPU (no look for a card) with the receiver's outputs altered
where they are produced."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import ONE_CHIP, TINY


def _stale(entry, mix):
    """A call that returns its state unchanged: the previous outputs."""
    last = {}

    def f(x):
        out = entry(x)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return f


def _half(entry, mix):
    """Half of the batch left out: the second half's rows (streams or
    windows) carry no result."""
    K = mix["entry"].get("kwargs", {}).get("n_frames", 1)

    def f(x):
        out = dict(entry(x))
        B = x.shape[0]
        if K > 1:
            src = out.get("src", torch.arange(out["det"].shape[0]))
            gone = (src.long() // K) >= B // 2
            for k in ("det", "ok"):
                out[k] = torch.where(gone, torch.zeros_like(out[k]), out[k])
            out["n_cand"] = (out["det"] >= 0.6).sum().to(torch.int32)
        else:
            for k, v in out.items():
                if v.dim() >= 1 and v.shape[0] == B:
                    v = v.clone()
                    v[B // 2:] = 0
                    out[k] = v
        return out
    return f


def _altered(entry, mix):
    """One answer altered where it is produced: a PSDU byte of the first
    row that decoded."""
    def f(x):
        out = dict(entry(x))
        r = int(torch.argmax(out["ok"].to(torch.int32)))
        psdu = out["psdu"].clone()
        psdu[r, 30] ^= 0x5A
        out["psdu"] = psdu
        return out
    return f


def _sound(entry, mix):
    return entry


FAULTS = {"sound": _sound, "stale": _stale, "half": _half,
          "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_fault_is_caught(cell, fault, cpu, monkeypatch):
    real = run.entry_point
    monkeypatch.setattr(run, "entry_point",
                        lambda mix, *a: FAULTS[fault](real(mix, *a), mix))
    r = run.run_cell(cell, 2 ** 31 + 3, 1.0, False, device=cpu,
                     overrides=TINY[cell])
    assert r["correct"] is (fault == "sound"), r["checks"]


# A four-rank run on the CPU (gloo) whose rank 2 never joins the process
# group or the ranks' store: rank 0's wait for it ends after WAIT_S, and
# the run fails with rank 2's stack on stderr.
_NEVER_JOINS = """
import sys, time
from benchmark import ranks

def never_joins(*a, **k):
    time.sleep(3600)

ranks.Context.join = never_joins
sys.exit(ranks.main(sys.argv[1:]))
"""

_RANK0 = """
import sys
from benchmark import ranks, run

ranks.WAIT_S = {wait}
real = ranks.rank_command
ranks.rank_command = lambda r, args: (
    [sys.executable, "-c", {stall!r}, "--rank", str(r), *args] if r == 2
    else real(r, args))
run.run_cell("a54-sat-8k-dp4", 2 ** 31 + 9, 1.0, False, device="cpu",
             overrides={tiny!r})
"""


def test_a_rank_that_never_joins_fails_the_run_inside_its_bound():
    import subprocess
    import sys
    import time

    wait = 10.0
    code = _RANK0.format(wait=wait, stall=_NEVER_JOINS,
                         tiny={"streams": 8, "pool": 2, "frames": 4,
                               "judged": 2})
    t = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=240)
    took = time.monotonic() - t
    assert r.returncode != 0 and r.stdout == ""
    assert took < wait + 60, took
    assert "rank 0 failed: the stacks of 3 live rank(s) follow" in r.stderr
    assert "in never_joins" in r.stderr, r.stderr[-4000:]
