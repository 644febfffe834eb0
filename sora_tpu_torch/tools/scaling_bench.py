"""Scaling measurements of the port (counterpart of
``tools/scaling_bench.py``).

Three sections:

* ``--cuda``: the batch curve of the 54 Mbps RX chain on one card —
  throughput against batch size at B = 16, 64, 128, 256 (how quickly the
  card saturates; the launch-overhead floor shows at small B);
* ``--cuda-sharded``: the sharding tax on the card — the (dp, sp)
  pipelines on a (1, 1) mesh of the one card (NCCL, a world of size 1)
  against the unsharded pipelines at the same shapes: the collectives
  have no peer, so what remains is the program's structure (halo concat,
  the size-1 collectives, the reshard copy);
* ``--cpu-mesh``: the sharding overhead on gloo ranks of this host at 1,
  2 and 8 ranks — T(n ranks) / T(1 rank) at fixed total work.  The ranks
  share the host's cores, so wall time cannot fall with the rank count;
  what is above 1.0 is what the collectives, halos and reshards cost.

Card times are CUDA events (median of 5 windows of 20 calls; the
sharded and unsharded windows interleaved); the CPU mesh times the host
clock.  Usage::

    python3 -m sora_tpu_torch.tools.scaling_bench --cuda --cuda-sharded
    python3 -m sora_tpu_torch.tools.scaling_bench --cpu-mesh
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
RATE, PSDU_LEN, MAX_PSDU = 54, 1500, 1504


def _log(*a):
    print(*a, flush=True)


def bench_cuda_batch_curve() -> int:
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.tools.bench import median_ms, saturated_batch
    from sora_tpu_torch.util.xfer import device_complex, fetch

    dev = torch.device("cuda")
    _log("single-card batch scaling, 54 Mbps saturated RX:")
    for B in (16, 64, 128, 256):
        x, _ = saturated_batch(RATE, B, PSDU_LEN, 1, dev)
        N = x.shape[1]
        xd = device_complex(x, dev)
        fn = lambda: arx.rx_pipeline(xd, RATE, max_psdu=MAX_PSDU)
        t0 = time.perf_counter()
        ok = fetch(fn()["ok"])
        tc = time.perf_counter() - t0
        assert ok.all(), (B, int(ok.sum()))
        ms, _ = median_ms(fn)
        _log(f"  B={B:4d}: {B * N / ms / 1e3:7.1f} Msamples/s  "
             f"({ms:7.3f} ms/batch, first call {tc:.2f} s)")
    return 0


def tax_ms(plain, sharded, windows: int = 5, reps: int = 20):
    """(unsharded ms, sharded ms) per call on the card: the medians of
    ``windows`` windows of ``reps`` back-to-back calls each (CUDA
    events), the two interleaved window by window after two warm-up
    calls each, so that a slow spell of the host falls on both."""
    from sora_tpu_torch.tools.bench import cuda_ms

    for _ in range(2):
        plain()
        sharded()
    a, b = [], []
    for _ in range(windows):
        a.append(cuda_ms(plain, reps))
        b.append(cuda_ms(sharded, reps))
    return sorted(a)[windows // 2], sorted(b)[windows // 2]


def sharded_tax(pairs) -> dict:
    """{name: (unsharded ms, sharded ms)} of each (name, unsharded fn,
    sharded fn) pair on the card, every call checked ok on all rows."""
    from sora_tpu_torch.util.xfer import fetch

    out = {}
    for name, plain, sharded in pairs:
        for fn in (plain, sharded):
            ok = fetch(fn()["ok"])
            assert ok.all(), (name, int(ok.sum()), ok.size)
        out[name] = tax_ms(plain, sharded)
    return out


def bench_cuda_sharded() -> int:
    from sora_tpu_torch.parallel import shard as psh
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.tools.bench import saturated_batch
    from sora_tpu_torch.util.xfer import device_complex

    dev = torch.device("cuda")
    B = 128
    x, _ = saturated_batch(RATE, B, PSDU_LEN, 1, dev)
    N = x.shape[1]
    mesh = psh.make_mesh(1)
    xd = device_complex(x, dev)
    _log(f"sharded-program cost on the card, (1, 1) mesh, B={B} x {N} @54 "
         "Mbps:")
    res = sharded_tax((
        ("fixed-rate", lambda: arx.rx_pipeline(xd, RATE, max_psdu=MAX_PSDU),
         lambda: psh.rx_pipeline_sharded(xd, mesh, RATE,
                                         max_psdu=MAX_PSDU)),
        ("auto", lambda: arx.rx_pipeline_auto(xd, max_psdu=MAX_PSDU),
         lambda: psh.rx_pipeline_sharded_auto(xd, mesh,
                                              max_psdu=MAX_PSDU))))
    for name, (plain, sharded) in res.items():
        _log(f"  {name:10s} unsharded {plain:7.3f} ms/batch, sharded "
             f"{sharded:7.3f} ms/batch ({B * N / sharded / 1e3:6.1f} "
             f"Msamples/s): sharding tax {sharded / plain:5.3f}x")
    torch.distributed.destroy_process_group()
    return 0


def _cpu_mesh_rank(n: int) -> None:
    """One gloo rank of the CPU mesh section; rank 0 prints its time."""
    import torch.distributed as tdist

    from sora_tpu_torch.parallel import shard as psh
    from sora_tpu_torch.tools.bench import saturated_batch

    torch.set_num_threads(1)
    rate, psdu_len, max_psdu, B = 12, 80, 128, 32
    x, _ = saturated_batch(rate, B, psdu_len, 1, torch.device("cpu"))
    mesh = psh.make_mesh(device="cpu")
    fn = lambda: psh.rx_pipeline_sharded(x, mesh, rate, max_psdu=max_psdu,
                                         device="cpu")
    ok = psh.gather_rows(fn()["ok"], mesh)
    assert bool(ok.all()), ok
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    tdist.barrier()
    dt = (time.perf_counter() - t0) / 3
    if tdist.get_rank() == 0:
        dp, sp = mesh.mesh.shape
        print(f"TIME {dt} {dp} {sp}", flush=True)
    tdist.destroy_process_group()


def bench_cpu_mesh(timeout: float = 600.0) -> int:
    _log("sharding overhead of gloo ranks sharing this host's cores "
         "(fixed total work; ideal factor = 1.0):")
    times = {}
    for n in (1, 2, 8):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for rank in range(n):
            env = dict(os.environ, OMP_NUM_THREADS="1",
                       PYTHONPATH=str(ROOT), RANK=str(rank),
                       LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "sora_tpu_torch.tools.scaling_bench",
                 "--cpu-mesh-rank", str(n)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode for p in procs):
            _log("\n".join(logs)[-3000:])
            return 1
        line = next(l for l in logs[0].splitlines() if l.startswith("TIME"))
        _, dt, dp, sp = line.split()
        dt = times[n] = float(dt)
        _log(f"  ranks={n} (mesh ({dp}, {sp})): {dt * 1e3:7.1f} ms/batch  "
             f"overhead factor {dt / times[1]:4.2f}x")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cuda", action="store_true")
    p.add_argument("--cuda-sharded", action="store_true")
    p.add_argument("--cpu-mesh", action="store_true")
    p.add_argument("--cpu-mesh-rank", type=int, default=0,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.cpu_mesh_rank:
        _cpu_mesh_rank(args.cpu_mesh_rank)
        return 0
    if (args.cuda or args.cuda_sharded) and not torch.cuda.is_available():
        _log("scaling_bench: CUDA is not available")
        return 1
    rc = 0
    if args.cuda:
        rc = bench_cuda_batch_curve() or rc
    if args.cuda_sharded:
        rc = bench_cuda_sharded() or rc
    if args.cpu_mesh:
        rc = bench_cpu_mesh() or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
