"""The port's multi-process sharded RX: two OS processes of
``sora_tpu_torch.tools.multihost_worker`` — two "hosts" of one rank each —
joined by torch.distributed over gloo, as tests/test_multihost.py runs
the JAX worker.  Each process keeps its 4 rows of the same 8-stream batch
and decodes them through the fixed-rate and mixed-rate sharded
pipelines on a (2, 1) mesh."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_rx(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sora_tpu_torch.tools.multihost_worker",
         "--coordinator", coord, "--num-procs", "2", "--proc-id", str(pid),
         "--device", "cpu", "--out", str(tmp_path / f"r{pid}.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid}:\n{out[-3000:]}"
        assert "PASS" in out, out[-3000:]
    for pid in range(2):
        r = json.loads((tmp_path / f"r{pid}.json").read_text())
        assert r["proc"] == pid
        assert r["n_processes"] == 2
        assert r["global_ranks"] == 2 and r["mesh"] == [2, 1]
        assert r["ok_local"] == r["expect_local"] == 4
