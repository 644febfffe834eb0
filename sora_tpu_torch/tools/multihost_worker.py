"""One process of a multi-process sharded RX run (port of
``tools/multihost_worker.py``).

    python -m sora_tpu_torch.tools.multihost_worker --coordinator \\
        127.0.0.1:29500 --num-procs 2 --proc-id 0 --device cpu

Each process is one rank (one device) and one "host" of the mesh: it
builds the same deterministic global batch as every other process, keeps
its own rows (the per-host radio feed), puts them on the mesh with
``from_process_local`` and runs the sharded fixed-rate and mixed-rate
pipelines over a (num_procs, 1) mesh; the collectives ride NCCL on the
card or gloo with ``--device cpu``.  Prints ``RESULT {...}`` and
``PASS``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

# rows of the global batch per process (the JAX worker's 4 local devices)
ROWS_PER_PROC = 4


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-procs", type=int, required=True)
    p.add_argument("--proc-id", type=int, required=True)
    p.add_argument("--rate", type=int, default=12)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs gloo)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as tdist

    from sora_tpu_torch.golden import dot11a_np as g
    from sora_tpu_torch.mac import frame as fr
    from sora_tpu_torch.parallel import distributed as dist
    from sora_tpu_torch.parallel.shard import (rx_pipeline_sharded,
                                               rx_pipeline_sharded_auto)

    torch.set_num_threads(1)
    dist.initialize(coordinator=args.coordinator,
                    num_processes=args.num_procs, process_id=args.proc_id,
                    device=args.device)
    assert tdist.get_world_size() == args.num_procs
    mesh = dist.global_mesh(dp=args.num_procs)

    # deterministic global traffic; every process builds the same batch
    # and keeps its own rows (the per-host ring feed)
    rng = np.random.default_rng(42)
    B, N = ROWS_PER_PROC * args.num_procs, 4096
    psdus, x = [], np.zeros((B, N), np.complex64)
    for i in range(B):
        psdu = fr.build_data_frame(
            bytes(rng.integers(0, 256, 52, dtype=np.uint8)), seq=i)
        psdus.append(psdu)
        w = g.modulate(psdu, args.rate).astype(np.complex64)
        x[i, 40 + 13 * i: 40 + 13 * i + len(w)] = w
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * 0.01

    lo = args.proc_id * ROWS_PER_PROC
    xs = dist.from_process_local(x[lo: lo + ROWS_PER_PROC], mesh,
                                 device=args.device)

    t0 = time.perf_counter()
    out = rx_pipeline_sharded(xs, mesh, args.rate, max_psdu=128,
                              device=args.device)
    ok_local = out["ok"].cpu().numpy()           # this rank's rows
    dt = time.perf_counter() - t0
    n_ok = int(ok_local.sum())
    # mixed-rate runtime dispatch over the same multi-process mesh
    out_a = rx_pipeline_sharded_auto(xs, mesh, max_psdu=128,
                                     device=args.device)
    okau = out_a["ok"].cpu().numpy()
    assert int(okau.sum()) == len(okau), "sharded auto failed multi-process"
    psdu = out["psdu"].cpu().numpy()
    for i, want in enumerate(psdus[lo: lo + ROWS_PER_PROC]):
        assert bytes(psdu[i, : len(want)]) == want, f"row {lo + i}"
    result = {"proc": args.proc_id, "n_processes": tdist.get_world_size(),
              "global_ranks": int(mesh.mesh.numel()),
              "mesh": list(mesh.mesh.shape),
              "ok_local": n_ok, "expect_local": len(ok_local),
              "wall_s": round(dt, 3)}
    print("RESULT " + json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result))
    tdist.destroy_process_group()
    assert n_ok == len(ok_local), result
    print("PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
