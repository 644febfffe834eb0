"""One rank of the port's sharding scenarios (run by test_torch_shard.py).

    python tests/torch_shard_ranks.py IN.npz OUT.npz
    python tests/torch_shard_ranks.py --compare A.npz B.npz

The launcher sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT for each
of 8 gloo ranks; with WORLD_SIZE unset the program is a world of size 1
and runs the fixed-rate scenario alone.  It imports only the port (never
JAX), reads the numpy inputs, runs every scenario of
tests/test_sharding.py on the mesh of ``make_mesh(device="cpu")`` and
rank 0 writes the gathered outputs (``<scenario>/<key>``).
``SHARD_DEVICE=cuda`` (and ``LOCAL_RANK``) runs the same scenarios on
NCCL ranks, one card each; ``--compare`` holds two such runs' outputs
to each other (every exact field equal, the float fields' largest
difference printed).
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sora_tpu_torch.parallel import distributed as pdist  # noqa: E402
from sora_tpu_torch.parallel import shard as psh  # noqa: E402
from sora_tpu_torch.util.xfer import fetch  # noqa: E402

DEVICE = os.environ.get("SHARD_DEVICE", "cpu")
FLOAT_KEYS = ("cfo", "det", "snr_db")


def main(src: str, dst: str) -> int:
    torch.set_num_threads(1)
    inp = dict(np.load(src))
    mesh = psh.make_mesh(device=DEVICE)
    out = {}

    def keep(name, tree, m=mesh):
        got = psh.gather_rows(tree, m)
        if got is None:
            return
        if isinstance(got, tuple):
            got = dict(zip(("lts1", "cfo", "det"), got))
        for k, v in fetch(got).items():
            out[f"{name}/{k}"] = v

    x = inp["frames"]
    keep("fixed", psh.rx_pipeline_sharded(x, mesh, 12, max_psdu=128,
                                          device=DEVICE))
    if "solo" not in inp:
        out["mesh"] = np.array(mesh.mesh.shape)
        keep("sync", psh.synchronize_sharded(x, mesh, device=DEVICE))
        keep("auto", psh.rx_pipeline_sharded_auto(inp["mixed"], mesh,
                                                  max_psdu=128, device=DEVICE))
        keep("straddle", psh.rx_pipeline_sharded_auto(
            inp["straddle"], mesh, max_psdu=128, device=DEVICE))
        keep("straddle_sync", psh.synchronize_sharded(inp["straddle"], mesh,
                                                      device=DEVICE))
        keep("auto40", psh.rx_pipeline_sharded_auto(
            inp["frames40"], mesh, max_psdu=128, input_rate="40m",
            device=DEVICE))
        keep("n9", psh.rx_pipeline_sharded_11n(inp["ht"], mesh, 9,
                                               max_psdu=128, device=DEVICE))
        keep("n9sync", psh.synchronize_sharded_11n(inp["ht"], mesh,
                                                   device=DEVICE))
        keep("nnoise", psh.rx_pipeline_sharded_11n_auto(
            inp["noise"], mesh, max_psdu=128, device=DEVICE))
        keep("b", psh.rx_pipeline_sharded_11b(inp["dsss"], mesh,
                                              max_psdu=128, device=DEVICE))
        # half the ranks "fail": the rebuilt mesh decodes the same work,
        # and the ranks outside it sit the call out
        small = pdist.surviving_mesh(exclude_devices=range(4, 8))
        res = psh.rx_pipeline_sharded(x, small, 12, max_psdu=128,
                                      device=DEVICE)
        if res is None:
            assert small.get_coordinate() is None
        else:
            out["small_mesh"] = np.array(small.mesh.shape)
        keep("small", res, small)
    if torch.distributed.get_rank() == 0:
        out["world"] = np.array(torch.distributed.get_world_size())
        np.savez(dst, **out)
    torch.distributed.destroy_process_group()
    return 0


def compare(a_path: str, b_path: str) -> int:
    """Exit 0 when the two outputs hold the same scenarios with every
    exact field equal; prints the largest difference of each float
    field."""
    with np.load(a_path) as fa, np.load(b_path) as fb:
        a, b = dict(fa), dict(fb)
    bad = sorted(set(a) ^ set(b))
    worst = {k: 0.0 for k in FLOAT_KEYS}
    for key in sorted(set(a) & set(b)):
        field = key.rpartition("/")[2]
        if field in FLOAT_KEYS:
            worst[field] = max(worst[field],
                               float(np.abs(a[key] - b[key]).max()))
        elif not np.array_equal(a[key], b[key]):
            bad.append(key)
    print(f"{len(set(a) & set(b))} fields compared; exact fields differ: "
          f"{bad or 'none'}; largest float differences: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(*sys.argv[2:4]))
    sys.exit(main(*sys.argv[1:3]))
