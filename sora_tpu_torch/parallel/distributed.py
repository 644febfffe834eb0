"""Multi-process meshes over ``torch.distributed`` (port of
``sora_tpu.parallel.distributed``).

One process per device.  Each process feeds its host's radio or ring
streams into its block of one global batch, the mesh spans every
process, and the collectives of ``parallel.shard`` do the rest (halo
exchange over ``sp``, reshards inside ``sp``).

Usage (per process)::

    from sora_tpu_torch.parallel import distributed as dist
    dist.initialize(coordinator="host0:9999", num_processes=2,
                    process_id=rank)
    mesh = dist.global_mesh(dp=2)
    xs = dist.from_process_local(x_local, mesh)
    out = rx_pipeline_sharded(xs, mesh, rate)     # this rank's rows
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as tdist

from sora_tpu_torch.parallel import shard as psh
from sora_tpu_torch.util.xfer import resolve_device


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group over ``tcp://coordinator`` (NCCL on the
    card, gloo with ``device="cpu"``).  With no coordinator the
    environment names the world (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``).  Does nothing when this process already joined one."""
    if tdist.is_initialized():
        return
    dev = resolve_device(device)
    if coordinator is None:
        tdist.init_process_group(psh._backend(dev))
    else:
        tdist.init_process_group(psh._backend(dev),
                                 init_method=f"tcp://{coordinator}",
                                 world_size=num_processes, rank=process_id)
    psh._bind_device(dev)


def _device_type() -> str:
    return "cuda" if tdist.get_backend() == "nccl" else "cpu"


def _hosts(ranks) -> int:
    """The number of distinct hosts among ``ranks`` (every rank of the
    world takes part)."""
    names = [None] * tdist.get_world_size()
    tdist.all_gather_object(names, socket.gethostname())
    return len({names[r] for r in ranks})


def global_mesh(dp: int | None = None):
    """(dp, sp) mesh over every rank of the world.  By default one ``dp``
    row per host, so each host's streams stay on the host and only the
    small detection candidates cross hosts (ranks are numbered host by
    host, as torchrun numbers them)."""
    n = tdist.get_world_size()
    if dp is None:
        dp = _hosts(range(n))
    return psh.mesh_of(range(n), dp, _device_type())


def from_process_local(x_local: np.ndarray, mesh, device=None):
    """This rank's :class:`~sora_tpu_torch.parallel.shard.Shard` of the
    global batch, on its device.

    x_local: this process's rows of the global (B, N) or (B, 2, N) batch
    (its dp row: the host-local radio or ring feed) at full length; the
    global batch is the concatenation over dp rows.  The rank keeps its
    time block.  None outside the mesh."""
    lay = psh._layout(mesh, device)
    if lay is None:
        return None
    dev, dp, sp, _, s = lay
    x_local = np.asarray(x_local, np.complex64)
    n = x_local.shape[-1]
    if n % sp:
        raise ValueError(f"N={n} must divide by sp={sp}")
    nloc = n // sp
    block = torch.as_tensor(np.ascontiguousarray(
        x_local[..., s * nloc: (s + 1) * nloc])).to(dev)
    return psh.Shard(block, (dp * x_local.shape[0],) + x_local.shape[1:])


def surviving_mesh(exclude_processes=(), exclude_devices=(),
                   dp: int | None = None):
    """Host-failure recovery: a (dp, sp) mesh over the surviving ranks —
    drop-and-rebalance (SURVEY §5): a dead host's channels are dropped,
    the remaining streams reshard over the new mesh, and decode resumes
    at the live edge of each surviving ring.

    One process is one device here, so ``exclude_processes`` and
    ``exclude_devices`` both name ranks.  By default one dp row per
    surviving host; dp steps down until it divides the rank count.  Every
    live rank takes part in building the groups; a rank outside the new
    mesh sits out its calls."""
    dead = set(exclude_processes) | set(exclude_devices)
    ranks = [r for r in range(tdist.get_world_size()) if r not in dead]
    if not ranks:
        raise RuntimeError("no surviving devices")
    n = len(ranks)
    if dp is None:
        dp = max(1, _hosts(ranks))
    while n % dp:
        dp -= 1
    return psh.mesh_of(ranks, dp, _device_type())

