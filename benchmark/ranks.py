"""The further ranks of a cell on several cards: one process per card,
rank 0 the run's own process.

    python3 -m benchmark.ranks --workload <name> --seed <n> --seconds <s>
        --trace <0|1> --rank <r> --world <n> --port <p> --store-port <q>
        --device <cuda|cpu> --root <checkout> --cpus <cpulist>

``benchmark.run`` starts these itself (``start``) and waits for them
(``reap``).  Every rank joins ``torch.distributed`` (NCCL on the card,
gloo on the CPU) at ``localhost`` and a TCP store beside it, makes the
same pool from the seed on its own card, runs the sharded receiver on its
block with the same calls as rank 0 (``run.Plan``), and posts its peak
memory and traced device times to rank 0 before it leaves.

Every wait of a rank is bounded, so that a stalled run fails with every
rank's stack on stderr well inside the 360 s a run may take:

* the process group's start and each of its collectives (NCCL's
  watchdog), the ranks' store and each read of it: ``WAIT_S``; the
  mesh's subgroups keep NCCL's default, under the run's own bound;
* a rank's process that ends with an error ends the run: rank 0 watches
  the others (:class:`Watch`), each other rank watches rank 0
  (:func:`watch_parent`);
* the ranks' exit once rank 0 has its result: ``REAP_S``;
* the whole run: ``RUN_S`` beyond its window, on every rank.

A rank that ends the run this way first has every live rank write its
stack (``SIGUSR1``, which each rank hands to ``faulthandler``).
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from benchmark import affinity

# Budgeted from the dp cell's runs on four H100s (PERF.md): a whole run
# of 47.3-62.6 s at 8192 rows a card (73.4 s with the kernels' build),
# set-up 18.7-40.4 s of it, the CUDA context and NCCL's start 7.7-14.9 s
# on rank 0.
WAIT_S = 90.0
REAP_S = 30.0
RUN_S = 200.0
POLL_S = 0.5


def log(*a):
    sys.stderr.write(" ".join(str(v) for v in a) + "\n")
    sys.stderr.flush()


@dataclass
class Context:
    rank: int
    world: int
    port: int
    store_port: int = 0

    def join(self, device, mesh_spec: dict):
        """(this rank's device, the (dp, sp) mesh, the ranks' store).
        The process group starts here, with its waits bounded, before the
        program's ``ensure_world`` finds it started."""
        import torch
        import torch.distributed as dist
        from sora_tpu_torch.parallel import shard

        os.environ.update({
            "RANK": str(self.rank), "LOCAL_RANK": str(self.rank),
            "WORLD_SIZE": str(self.world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(self.port)})
        cuda = torch.device(device).type == "cuda"
        if cuda:                              # rank r on card r
            torch.cuda.set_device(self.rank % torch.cuda.device_count())
        wait = datetime.timedelta(seconds=WAIT_S)
        dist.init_process_group("nccl" if cuda else "gloo", timeout=wait)
        dev = shard.ensure_world(device)
        mesh = shard.mesh_of(range(self.world), mesh_spec["dp"], dev.type)
        store = dist.TCPStore("127.0.0.1", self.store_port, self.world,
                              self.rank == 0, timeout=wait)
        return dev, mesh, store

    def leave(self) -> None:
        import torch.distributed as dist

        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_command(rank: int, args: list) -> list:
    """The command line of rank ``rank``'s process."""
    return [sys.executable, "-m", "benchmark.ranks", "--rank", str(rank),
            *args]


def start(name, seed, seconds, trace, ctx: Context, device, overrides,
          root: Path, cpus) -> list:
    """Ranks 1 .. world - 1 as processes (their stdout discarded); each
    pins itself to its share of ``cpus``, the CPUs the run may use."""
    from benchmark import run

    ctx.store_port = free_port()
    args = ["--workload", name, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(int(trace)), "--world",
            str(ctx.world), "--port", str(ctx.port), "--store-port",
            str(ctx.store_port), "--device", str(device), "--root",
            str(root), "--cpus", affinity.cpulist(cpus)]
    if overrides:
        args += ["--overrides", json.dumps(overrides)]
    return [subprocess.Popen(rank_command(r, args), cwd=run.ROOT,
                             stdout=subprocess.DEVNULL)
            for r in range(1, ctx.world)]


def guard(seconds: float) -> None:
    """This rank's stack on SIGUSR1 and on a fatal signal (NCCL's
    watchdog aborts), and its stack then exit once the run has lasted
    ``RUN_S`` beyond its window of ``seconds``."""
    faulthandler.enable(all_threads=True)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    faulthandler.dump_traceback_later(RUN_S + seconds, exit=True)


def unguard() -> None:
    faulthandler.cancel_dump_traceback_later()


def stop(procs, why: str) -> None:
    """Every live rank's stack on stderr, one rank after another (ranks 1
    .. n are ``procs``), then its end."""
    live = [(r, p) for r, p in enumerate(procs, 1) if p.poll() is None]
    log(f"{why}: the stacks of {len(live)} live rank(s) follow, then "
        f"they are stopped")
    for r, p in live:
        log(f"rank {r}'s stack:")
        p.send_signal(signal.SIGUSR1)
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


class Watch:
    """Rank 0's watch on the other ranks: when one ends with an error the
    run ends with it, every rank's stack on stderr (rank 0's own thread
    may be held in a collective, so this thread ends the process)."""

    def __init__(self, procs):
        self.procs = procs
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self.done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc:
                    stop(self.procs, f"rank {r} ended with {rc}")
                    log("rank 0's stack:")
                    faulthandler.dump_traceback(all_threads=True)
                    os._exit(1)

    def close(self) -> None:
        self.done.set()
        self.thread.join()


def watch_parent(rank: int) -> None:
    """A following rank's watch on rank 0: once rank 0's process has
    gone, this rank writes its stack and ends."""
    parent = os.getppid()

    def run():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        log(f"rank 0 (process {parent}) has gone; rank {rank}'s stack:")
        faulthandler.dump_traceback(all_threads=True)
        os._exit(1)
    threading.Thread(target=run, daemon=True).start()


def fail(rank: int) -> None:
    """End this rank's process at once after an error, with its
    traceback on stderr: the interpreter's own exit would wait for the
    collectives still in flight until NCCL's watchdog ended it."""
    log(f"rank {rank} failed:")
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)


def reap(procs) -> None:
    """Wait, ``REAP_S`` in all, for every rank's process to end; stop the
    ones that outstay it.  Raises when a rank failed or outstayed."""
    end = time.monotonic() + REAP_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            stop(procs, f"a rank outstayed rank 0 by {REAP_S} s")
            raise SystemExit("a rank's process did not end") from None
    failed = [p.returncode for p in procs if p.returncode]
    if failed:
        raise SystemExit(f"a rank's process failed ({failed})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for k in ("--workload", "--device", "--root", "--cpus"):
        ap.add_argument(k, required=True)
    for k in ("--seed", "--trace", "--rank", "--world", "--port",
              "--store-port"):
        ap.add_argument(k, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--overrides", default="")
    a = ap.parse_args(argv)
    guard(a.seconds)
    watch_parent(a.rank)
    if a.device != "cpu":
        affinity.pin(a.rank, a.world, affinity.parse_cpulist(a.cpus))
    from benchmark import run

    run.fixed_caches()
    cell = run.load_cell(a.workload, Path(a.root))
    ctx = Context(a.rank, a.world, a.port, a.store_port)
    try:
        run.run_rank(cell, a.seed, a.seconds, bool(a.trace), a.device,
                     json.loads(a.overrides) if a.overrides else None, ctx)
    except BaseException:
        fail(a.rank)
    return 0


if __name__ == "__main__":
    sys.exit(main())
