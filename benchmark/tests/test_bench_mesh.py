"""The four-card cell's path rehearsed on the CPU: four gloo ranks, each
in a process of its own, run the sharded receiver with the same calls;
rank 0 judges the gathered rows.  With the exchange between the ranks
left out (no all-gather: rank 0 keeps its own rows), ``correct`` comes
out false."""

import multiprocessing as mp

import pytest

from benchmark.tests.conftest import cell_parts

TINY_DP4 = {"streams": 8, "pool": 2, "frames": 4, "judged": 2}


def _rank(rank, world, port, store_port, fault, q):
    import torch

    torch.set_num_threads(1)
    from benchmark import ranks, run
    from sora_tpu_torch.parallel import shard

    if fault:
        shard.gather_rows = lambda tree, mesh: tree
    cell = run.load_cell("a54-sat-8k-dp4")
    ctx = ranks.Context(rank, world, port, store_port)
    r = run.run_rank(cell, 2 ** 31 + 9, 1.0, False, "cpu", TINY_DP4, ctx)
    if rank == 0:
        q.put((r["correct"], r["checks"], r["attempted"]))


@pytest.mark.parametrize("fault", [False, True])
def test_mesh_run_and_exchange_left_out(fault):
    from benchmark import ranks

    assert cell_parts("a54-sat-8k-dp4")[1]["entry"]["mesh"]["dp"] == 4
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port, store_port = ranks.free_port(), ranks.free_port()
    procs = [ctx.Process(target=_rank,
                         args=(r, 4, port, store_port, fault, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        correct, checks, attempted = q.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert attempted > 0
    assert correct is (not fault), checks
