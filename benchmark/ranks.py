"""The further ranks of a cell on several cards: one process per card,
rank 0 the run's own process.

    python3 -m benchmark.ranks --workload <name> --seed <n> --seconds <s>
        --trace <0|1> --rank <r> --world <n> --port <p> --store-port <q>
        --device <cuda|cpu> --root <checkout>

``benchmark.run`` starts these itself (``start``) and waits for them
(``reap``).  Every rank joins ``torch.distributed`` (NCCL on the card,
gloo on the CPU) at ``localhost`` and a TCP store beside it, makes the
same pool from the seed on its own card, runs the sharded receiver on its
block with the same calls as rank 0 (``run.Plan``), and posts its peak
memory and traced device times to rank 0 before it leaves.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Context:
    rank: int
    world: int
    port: int
    store_port: int = 0

    def join(self, device, mesh_spec: dict):
        """(this rank's device, the (dp, sp) mesh, the ranks' store)."""
        import torch.distributed as dist
        from sora_tpu_torch.parallel import shard

        os.environ.update({
            "RANK": str(self.rank), "LOCAL_RANK": str(self.rank),
            "WORLD_SIZE": str(self.world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(self.port)})
        dev = shard.ensure_world(device)
        mesh = shard.mesh_of(range(self.world), mesh_spec["dp"], dev.type)
        store = dist.TCPStore("127.0.0.1", self.store_port, self.world,
                              self.rank == 0,
                              timeout=datetime.timedelta(seconds=300))
        return dev, mesh, store

    def leave(self) -> None:
        import torch.distributed as dist

        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(name, seed, seconds, trace, ctx: Context, device, overrides,
          root: Path) -> list:
    """Ranks 1 .. world - 1 as processes (their stdout discarded)."""
    from benchmark import run

    ctx.store_port = free_port()
    procs = []
    for r in range(1, ctx.world):
        cmd = [sys.executable, "-m", "benchmark.ranks", "--workload", name,
               "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(int(trace)), "--rank", str(r),
               "--world", str(ctx.world), "--port", str(ctx.port),
               "--store-port", str(ctx.store_port), "--device", str(device),
               "--root", str(root)]
        if overrides:
            cmd += ["--overrides", json.dumps(overrides)]
        procs.append(subprocess.Popen(cmd, cwd=run.ROOT,
                                      stdout=subprocess.DEVNULL))
    return procs


def reap(procs, timeout: float = 120.0) -> None:
    """Wait for every rank's process; kill one that outstays
    ``timeout``.  Raises when a rank failed."""
    failed = []
    for p in procs:
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        if rc:
            failed.append(rc)
    if failed:
        raise SystemExit(f"a rank's process failed ({failed})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for k in ("--workload", "--device", "--root"):
        ap.add_argument(k, required=True)
    for k in ("--seed", "--trace", "--rank", "--world", "--port",
              "--store-port"):
        ap.add_argument(k, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--overrides", default="")
    a = ap.parse_args(argv)
    from benchmark import run

    run.fixed_caches()
    cell = run.load_cell(a.workload, Path(a.root))
    ctx = Context(a.rank, a.world, a.port, a.store_port)
    run.run_rank(cell, a.seed, a.seconds, bool(a.trace), a.device,
                 json.loads(a.overrides) if a.overrides else None, ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
