"""Multi-device sharding of the PHY pipelines over ``torch.distributed``
(port of ``sora_tpu.parallel.shard``).

One process per device.  The JAX package's ``Mesh(("dp", "sp"))``
becomes a :class:`~torch.distributed.device_mesh.DeviceMesh` with the
same dimension names:

* ``dp`` — stream parallelism: the rows of the batch (independent RX
  streams, the analogue of Sora's multiple radios) split over ranks;
* ``sp`` — time-block parallelism within a stream: each rank scans a
  contiguous time block and receives a halo of boundary samples from
  the rank holding the next block (overlap-save).

Detection runs on the (dp, sp) blocks; frame decode then reshards to
row chunks over every rank with one ``all_to_all`` inside the ``sp``
group (the rows of decode chunk ``d * sp + s`` all lie in dp block
``d``, so nothing crosses ``dp``).  The backend is NCCL on the card and
gloo with ``device="cpu"``.

Forms that differ from the JAX package (each held by
``tests/test_torch_shard.py``):

* the halo is a linear shift — block s + 1 sends its head to block s,
  block 0 sends nothing and the last block pads zeros — where JAX runs a
  ring ``ppermute`` and zeroes the wrapped-around halo; with sp = 1 no
  message is sent;
* a function takes the global batch (every rank passes the same one and
  keeps its block) or this rank's :class:`Shard`, and returns this
  rank's row chunk of the JAX result (rows ``[r * B / n, (r + 1) * B /
  n)`` for mesh index ``r = d * sp + s`` of ``n`` ranks); where JAX
  fetches a sharded ``jax.Array``, :func:`gather_rows` all-gathers the
  chunks in row order;
* a rank outside the mesh (a smaller mesh from
  ``distributed.surviving_mesh``) sits out a call and gets None.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sora_tpu_torch.dsp import filters as df
from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy import dot11b_common as B11
from sora_tpu_torch.phy import frontend as fe
from sora_tpu_torch.phy.dot11a import rx as arx
from sora_tpu_torch.phy.dot11b import rx as brx
from sora_tpu_torch.phy.dot11n import rx as nrx
from sora_tpu_torch.util import spans
from sora_tpu_torch.util.xfer import resolve_device

# halo: lag-16 autocorr + 64-wide window + 128-long LTS correlation
_HALO = 256
# the Barker pattern spans 10 chips past a block boundary
_HALO_11B = 16


@dataclass
class Shard:
    """This rank's block of a (dp, sp)-sharded global batch — the
    counterpart of a ``jax.Array``'s addressable shard.

    ``block`` holds rows ``[d * B / dp, (d + 1) * B / dp)`` and samples
    ``[s * N / sp, (s + 1) * N / sp)`` of the global (B, N) or (B, 2, N)
    batch of shape ``shape``."""
    block: torch.Tensor
    shape: tuple


# -----------------------------------------------------------------------------
# the mesh
# -----------------------------------------------------------------------------


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _bind_device(dev: torch.device) -> None:
    """One card per rank: rank r of a node uses card r mod cards."""
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def ensure_world(device=None) -> torch.device:
    """Join the process group, or bring up a world of size 1 when none
    exists and the environment names none (``WORLD_SIZE`` unset) — one
    card then gets a (1, 1) mesh, as ``jax.devices()`` gives one device.
    Returns the device this rank computes on."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(dev))
        else:
            dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
        _bind_device(dev)
    return rank_device(dev)


def rank_device(device) -> torch.device:
    """This rank's device of type ``device`` (its bound card for cuda)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_of(ranks, dp: int, device_type: str) -> DeviceMesh:
    """A ("dp", "sp") DeviceMesh over ``ranks`` (row-major).  Every rank
    of the world takes part in building its groups."""
    ranks = list(ranks)
    if dp < 1 or len(ranks) % dp:
        raise ValueError(f"{len(ranks)} ranks do not split into dp={dp} rows")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(dp, -1)
    return DeviceMesh(device_type, grid, mesh_dim_names=("dp", "sp"))


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device=None) -> DeviceMesh:
    """(dp, sp) mesh over the first ``n_devices`` ranks of the world (all
    by default); dp = 2 when the count is even and above 1.  Brings up a
    world of size 1 when no process group exists (:func:`ensure_world`).
    Default device cuda; raises without CUDA unless ``device="cpu"``."""
    dev = ensure_world(device)
    world = dist.get_world_size()
    n = min(n_devices, world) if n_devices else world
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    return mesh_of(range(n), dp, dev.type)


def _layout(mesh: DeviceMesh, device):
    """(device, dp, sp, d, s) of this rank, or None outside the mesh."""
    dev = rank_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run on "
                         f"{dev.type}")
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    dp, sp = mesh.mesh.shape
    return dev, dp, sp, coord[0], coord[1]


def _sp(mesh: DeviceMesh):
    """(group, global ranks in block order) of this rank's sp row."""
    g = mesh.get_group("sp")
    return g, dist.get_process_group_ranks(g)


# -----------------------------------------------------------------------------
# collectives
# -----------------------------------------------------------------------------


def _reduce(v: torch.Tensor, op, group) -> torch.Tensor:
    v = v.contiguous()
    if v.is_complex():
        dist.all_reduce(torch.view_as_real(v), op=op, group=group)
    else:
        dist.all_reduce(v, op=op, group=group)
    return v


def _gather(v: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *v.shape): v of every rank of ``group`` in group order."""
    out = v.new_empty((n * v.shape[0],) + tuple(v.shape[1:]))
    dist.all_gather_into_tensor(out, v.contiguous(), group=group)
    return out.reshape((n,) + tuple(v.shape))


def _halo(xl: torch.Tensor, halo: int, mesh: DeviceMesh, s: int
          ) -> torch.Tensor:
    """Block + the head (``halo`` samples of the last axis) of the next
    block; zeros after the last block.  A linear shift: block s + 1 sends
    to block s, block 0 sends nothing."""
    head = xl.new_zeros(xl.shape[:-1] + (halo,))
    group, ranks = _sp(mesh)
    ops = []
    if s > 0:
        ops.append(dist.P2POp(dist.isend, xl[..., :halo].contiguous(),
                              ranks[s - 1], group))
    if s < len(ranks) - 1:
        ops.append(dist.P2POp(dist.irecv, head, ranks[s + 1], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat([xl, head], dim=-1)


def _all_to_all(v: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over the leading axis (one slice per rank)."""
    v = v.contiguous()
    out = torch.empty_like(v)
    if v.is_complex():
        dist.all_to_all_single(torch.view_as_real(out), torch.view_as_real(v),
                               group=group)
    else:
        dist.all_to_all_single(out, v, group=group)
    return out


def _blocks_to_rows(xl: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(dp, sp) block (Bl, ..., nloc) -> this rank's row chunk (Bl / sp,
    ..., sp * nloc) at full length: the detect -> decode reshard."""
    group, ranks = _sp(mesh)
    nsp = len(ranks)
    parts = xl.reshape((nsp, xl.shape[0] // nsp) + tuple(xl.shape[1:]))
    got = _all_to_all(parts, group)        # [j] = my rows, time block j
    got = got.movedim(0, -2)               # (Bl / sp, ..., sp, nloc)
    return got.reshape(got.shape[:-2] + (nsp * xl.shape[-1],))


def _rows_to_blocks(xr: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The inverse of :func:`_blocks_to_rows`: this rank's row chunk at
    full length -> its (dp, sp) block."""
    group, ranks = _sp(mesh)
    nsp = len(ranks)
    n = xr.shape[-1]
    if n % nsp:
        raise ValueError(f"N={n} does not split into sp={nsp} blocks")
    parts = xr.reshape(xr.shape[:-1] + (nsp, n // nsp)).movedim(-2, 0)
    got = _all_to_all(parts, group)        # [j] = rows of rank j, my block
    return got.reshape((nsp * xr.shape[0],) + tuple(got.shape[2:]))


def gather_rows(tree, mesh: DeviceMesh):
    """Every rank's row chunk, all-gathered in row order: the global
    result (tensors in a dict / tuple / list tree).  The counterpart of
    fetching a sharded ``jax.Array``; None outside the mesh.  Runs in the
    span ``shard.gather`` (``util.spans``)."""
    if mesh.get_coordinate() is None:
        return None
    with spans.span("shard.gather", mesh.device_type):
        return _gather_tree(tree, mesh)


def _gather_tree(tree, mesh: DeviceMesh):
    if isinstance(tree, dict):
        return {k: _gather_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather_tree(v, mesh) for v in tree)
    dp, sp = mesh.mesh.shape
    v = _gather(tree, mesh.get_group("sp"), sp)
    v = v.reshape((sp * tree.shape[0],) + tuple(tree.shape[1:]))
    v2 = _gather(v, mesh.get_group("dp"), dp)
    return v2.reshape((dp * v.shape[0],) + tuple(v.shape[1:]))


def _chunk(v: torch.Tensor, nsp: int, s: int) -> torch.Tensor:
    """This rank's row chunk of a dp-block vector replicated over sp."""
    n = v.shape[0] // nsp
    return v[s * n: (s + 1) * n]


# -----------------------------------------------------------------------------
# putting a batch on the mesh
# -----------------------------------------------------------------------------


def _check(shape, dp: int, sp: int, halo: int) -> None:
    Bsz, n = int(shape[0]), int(shape[-1])
    if Bsz % (dp * sp):
        raise ValueError(f"B={Bsz} must divide by dp*sp={dp * sp}")
    if n % sp:
        raise ValueError(f"N={n} must divide by sp={sp}")
    if n // sp < halo:
        raise ValueError(f"N/sp={n // sp} is shorter than the halo {halo}")


def _take(x, rows: slice, cols: slice, dev: torch.device) -> torch.Tensor:
    """x[rows, ..., cols] of a host array or a tensor, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x[rows][..., cols].to(dev).contiguous()
    blk = np.asarray(x)[rows][..., cols]
    return torch.as_tensor(np.ascontiguousarray(blk, np.complex64)).to(dev)


def _shard_in(x, mesh: DeviceMesh, lay, input_rate: str, halo: int):
    """This rank's (dp, sp) block of the batch, after the 40 Msps front
    end when ``input_rate == "40m"``: it runs on this rank's row chunk at
    full length (the TDownSample2 -> TDCRemoveEx graph head,
    fb11ademod_config.hpp:148), then the inverse all-to-all reshards.
    Returns (block, global sample count after the front end)."""
    dev, dp, sp, d, s = lay
    if isinstance(x, Shard):
        xl = x.block.to(dev)
        if input_rate == "40m":
            xl = _rows_to_blocks(fe.ofdm_frontend_40m(
                _blocks_to_rows(xl, mesh)), mesh)
        _check((x.shape[0],) + tuple(xl.shape[1:-1]) + (sp * xl.shape[-1],),
               dp, sp, halo)
        return xl, sp * xl.shape[-1]
    shape = tuple(x.shape)
    if shape[0] % (dp * sp):
        raise ValueError(f"B={shape[0]} must divide by dp*sp={dp * sp}")
    bl = shape[0] // (dp * sp)
    if input_rate == "40m":
        r = d * sp + s
        xr = fe.ofdm_frontend_40m(_take(x, slice(r * bl, (r + 1) * bl),
                                        slice(None), dev))
        _check((shape[0],) + tuple(xr.shape[1:]), dp, sp, halo)
        return _rows_to_blocks(xr, mesh), xr.shape[-1]
    _check(shape, dp, sp, halo)
    n = shape[-1] // sp
    rows = slice(d * bl * sp, (d + 1) * bl * sp)
    return _take(x, rows, slice(s * n, (s + 1) * n), dev), shape[-1]


# -----------------------------------------------------------------------------
# sharded detection
# -----------------------------------------------------------------------------


def _sync_block(xl: torch.Tensor, mesh: DeviceMesh, s: int, nsp: int):
    """11a detection of this rank's (Bl, nloc) block: (lts1, cfo, det) of
    the dp block's Bl rows, equal on every rank of the sp row."""
    group, _ = _sp(mesh)
    nloc = xl.shape[1]
    dev = xl.device
    xx = _halo(xl, _HALO, mesh, s)
    # STS autocorrelation metric for offsets local to this block
    ac = xx[:, 16:] * torch.conj(xx[:, :-16])
    w = df.moving_sum(ac, 64)[:, :nloc]
    en = df.moving_sum(torch.abs(xx[:, :-16]) ** 2, 64)[:, :nloc].float()
    # energy gate against the global max (one small all-reduce)
    en_max = _reduce(en.max(dim=1).values, dist.ReduceOp.MAX, group)
    gate = en > 0.05 * en_max[:, None]
    m = torch.where(gate, torch.abs(w) / (en + 1e-9), 0.0)
    # the single-device first-plateau selection: the earliest global
    # offset reaching 90% of the global max, offsets too close to the end
    # excluded (a full preamble + SIGNAL must still fit)
    nglob = nsp * nloc
    base = s * nloc
    gpos = base + torch.arange(nloc, device=dev)[None, :]
    m = torch.where(gpos < max(1, nglob - 480), m, 0.0)
    gmax = _reduce(m.max(dim=1).values, dist.ReduceOp.MAX, group)
    return _lock(xx, m, w, gmax, s, nsp, group, strict=False, plateau=0,
                 win=None)


def _lock(xx, m, w, gmax, s: int, nsp: int, group, *, strict: bool,
          plateau: int, win: int | None):
    """Shared back half of the 11a and 11n block syncs: the first global
    offset over 90% of the plateau maximum (``strict``: above it), moved
    ``plateau`` samples into the plateau, its metric and CFO; then the
    LTS cross-correlation on the de-rotated block (the ramp uses the
    global float32 sample index so blocks line up), from the STS on (and
    within ``win`` of it), and the all-gathered best candidate."""
    dev = m.device
    nloc = m.shape[1]
    base, nglob = s * nloc, nsp * nloc
    hit = m > 0.9 * gmax[:, None] if strict else m >= 0.9 * gmax[:, None]
    first_loc = arx._first_true(hit)
    has = hit.any(dim=1)
    first = torch.where(has, base + first_loc, nglob + 1)
    onset = _reduce(first, dist.ReduceOp.MIN, group)
    sts = torch.clamp(onset + plateau, max=nglob - 1) if plateau else onset
    own = (sts >= base) & (sts < base + nloc)
    loc = torch.clamp(sts - base, 0, nloc - 1)[:, None]
    det = _reduce(torch.where(own, m.gather(1, loc)[:, 0], 0.0),
                  dist.ReduceOp.SUM, group)
    wsel = _reduce(torch.where(own, w.gather(1, loc)[:, 0], 0),
                   dist.ReduceOp.SUM, group)
    cfo = torch.angle(wsel).float() / 16.0
    gidx = (base + torch.arange(xx.shape[-1], device=dev)).float()
    rot = arx._rotate(cfo.reshape((-1,) + (1,) * (xx.dim() - 1)) * gidx)
    y = xx * rot
    c = torch.abs(df.correlate_stream(y.reshape(-1, xx.shape[-1]),
                                      arx._LTS_SYM))
    if xx.dim() == 3:                      # antenna-summed
        c = c.reshape(xx.shape[0], xx.shape[1], -1).sum(dim=1)
    c2 = (c[:, :-64] + c[:, 64:])[:, :nloc]
    pos = base + torch.arange(nloc, device=dev)[None, :]
    keep = pos >= sts[:, None]
    if win is not None:
        keep = keep & (pos <= sts[:, None] + win)
    c2 = torch.where(keep, c2, 0.0)
    lts_loc = torch.argmax(c2, dim=1)
    lval = c2.gather(1, lts_loc[:, None])[:, 0]
    cand_lv = _gather(lval, group, nsp)
    cand_li = _gather(lts_loc + base, group, nsp)
    # torch.argmax takes the first of equal maxima, as jnp.argmax does
    bl = torch.argmax(cand_lv, dim=0)
    lts1 = cand_li.gather(0, bl[None])[0]
    return lts1.to(torch.int32), cfo, det


def _sync_block_11n(xl: torch.Tensor, mesh: DeviceMesh, s: int, nsp: int):
    """2x2 HT detection of this rank's (Bl, 2, nloc) block: antennas stay
    on the rank, statistics are antenna-summed as in
    ``phy.dot11n.rx.synchronize`` (TCCA11n, cca_11n.hpp:7)."""
    group, _ = _sp(mesh)
    Bl, A, nloc = xl.shape
    xx = _halo(xl, _HALO, mesh, s)                  # (Bl, 2, nloc + halo)
    xf = xx.reshape(Bl * A, -1)
    ac = xf[:, 16:] * torch.conj(xf[:, :-16])
    w = df.moving_sum(ac, 64).reshape(Bl, A, -1).sum(dim=1)[:, :nloc]
    en = df.moving_sum(torch.abs(xf[:, :-16]) ** 2, 64).float().reshape(
        Bl, A, -1).sum(dim=1)[:, :nloc]
    en_max = _reduce(en.max(dim=1).values, dist.ReduceOp.MAX, group)
    gate = en > 0.05 * en_max[:, None]
    m = torch.where(gate, torch.abs(w) / (en + 1e-9), 0.0)
    nglob = nsp * nloc
    base = s * nloc
    gpos = base + torch.arange(nloc, device=xl.device)[None, :]
    m = torch.where(gpos < max(1, nglob - 900), m, 0.0)
    gmax = _reduce(m.max(dim=1).values, dist.ReduceOp.MAX, group)
    # the plateau onset, strictly over 90%, then 16 into the plateau
    return _lock(xx, m, w, gmax, s, nsp, group, strict=True, plateau=16,
                 win=320)


def _sync_call(x, mesh, device, block_sync):
    lay = _layout(mesh, device)
    if lay is None:
        return None
    _, _, sp, _, s = lay
    xl, _ = _shard_in(x, mesh, lay, "20m", _HALO)
    return tuple(_chunk(v, sp, s) for v in block_sync(xl, mesh, s, sp))


def synchronize_sharded(x, mesh: DeviceMesh, device=None):
    """Time-block-sharded packet detection with halo exchange.

    x: the global (B, N) batch (or this rank's :class:`Shard`), B over
    ``dp`` and N over ``sp``.  Each rank scores the window starts inside
    its block, pulling ``_HALO`` samples from the next block so windows
    that straddle the boundary are scored exactly once; the global pick
    is a small all-gather of per-block candidates.  Returns this rank's
    row chunk of (lts1, cfo, det)."""
    return _sync_call(x, mesh, device, _sync_block)


def synchronize_sharded_11n(x, mesh: DeviceMesh, device=None):
    """Time-block-sharded 2x2 HT packet detection: x is the global
    (B, 2, N) batch (antennas unsharded) or this rank's :class:`Shard`.
    Returns this rank's row chunk of (lts1, cfo, det)."""
    return _sync_call(x, mesh, device, _sync_block_11n)


# -----------------------------------------------------------------------------
# sharded pipelines
# -----------------------------------------------------------------------------


def _detect_rows(x, mesh, device, input_rate, block_sync):
    """Sharded detection, then the reshard to this rank's row chunk:
    (rows at full length, lts1, cfo, det, global N), or None outside the
    mesh."""
    lay = _layout(mesh, device)
    if lay is None:
        return None
    _, _, sp, _, s = lay
    xl, n = _shard_in(x, mesh, lay, input_rate, _HALO)
    lts1, cfo, det = block_sync(xl, mesh, s, sp)
    xd = _blocks_to_rows(xl, mesh)
    return (xd, _chunk(lts1, sp, s), _chunk(cfo, sp, s), _chunk(det, sp, s),
            n)


def rx_pipeline_sharded(x, mesh: DeviceMesh, rate_mbps: int,
                        max_psdu: int = 256, input_rate: str = "20m",
                        device=None):
    """Full sharded RX for a known rate: (dp, sp)-sharded detection, then
    frame decode on every rank's row chunk.

    x: the global (B, N) complex64 batch, host or device (raw 40 Msps
    with ``input_rate="40m"``: the front end runs first), or this rank's
    :class:`Shard`; B must divide by the rank count.  Returns this rank's
    row chunk of the dict psdu, ok, fcs_ok, length, snr_db.  Runs in the
    span ``rx.call`` with the stages of ``phy.dot11a.rx.rx_pipeline``;
    ``rx.sync`` holds the sharded detection and the reshard."""
    with spans.span("rx.call", device or "cuda"):
        spans.stage("rx.sync")
        got = _detect_rows(x, mesh, device, input_rate, _sync_block)
        if got is None:
            return None
        xd, l1, cf, _, _ = got
        rate = C.RATES[rate_mbps]
        nsym = arx.max_symbols(rate, max_psdu)
        spans.stage("rx.equalize")
        eq, snr_db, wgt = arx.extract_symbols(xd, l1, cf, nsym,
                                              return_weights=True)
        spans.stage("rx.demap")
        rate_bits, length, sig_ok = arx.decode_signal(eq[:, 0, :])
        length = torch.clamp(length, 0, max_psdu).to(torch.int32)
        psdu, fcs_ok, _ = arx.decode_data(eq[:, 1:, :], length, rate_mbps,
                                          wgt)
        ok = sig_ok & (rate_bits == rate.rate_bits) & fcs_ok
        u8 = lambda v: v.to(torch.uint8)
        return {"psdu": psdu, "ok": u8(ok), "fcs_ok": u8(fcs_ok),
                "length": length, "snr_db": snr_db}


def rx_pipeline_sharded_auto(x, mesh: DeviceMesh, max_psdu: int = 256,
                             input_rate: str = "20m", device=None):
    """Sharded mixed-rate RX: (dp, sp) detection with halo exchange, then
    the runtime rate-dispatch decode tail (``phy.dot11a.rx.auto_tail``)
    on every rank's row chunk.  x as :func:`rx_pipeline_sharded`."""
    got = _detect_rows(x, mesh, device, input_rate, _sync_block)
    if got is None:
        return None
    xd, l1, cf, dt, n = got
    nsym_win = max(1, (n - 208) // 80)
    nsym_max = arx._auto_tables(max_psdu, nsym_win)[3]
    eq, snr_db, wgt = arx.extract_symbols(xd, l1, cf, nsym_max,
                                          return_weights=True)
    out = arx.auto_tail(eq, dt, max_psdu, nsym_win, weights=wgt)
    out["snr_db"] = snr_db
    return out


def rx_pipeline_sharded_11n(x, mesh: DeviceMesh, mcs: int,
                            max_psdu: int = 256, input_rate: str = "20m",
                            device=None):
    """Full sharded 2x2 HT RX for MCS 8-15: (dp, antenna-local, sp)
    detection, then MIMO decode on every rank's row chunk
    (fb11ndemod_config.hpp:142-206).  x: the global (B, 2, N) batch or
    this rank's :class:`Shard`.  Returns this rank's row chunk of psdu,
    ok, fcs_ok, cs_ok, det, mcs, length, snr_db."""
    got = _detect_rows(x, mesh, device, input_rate, _sync_block_11n)
    if got is None:
        return None
    xd, l1, cf, dt, _ = got
    nsym = nrx.max_symbols(mcs, max_psdu)
    sig_eq, xdet, snr_db, wgt = nrx.extract_symbols(
        xd, l1, cf, nsym, return_weights=True)
    lsig_ok = nrx.decode_lsig(sig_eq[:, 0])
    mcs_rx, length, htsig_ok, _ = nrx.decode_htsig(sig_eq[:, 1:])
    length = torch.clamp(length, 0, max_psdu).to(torch.int32)
    psdu, fcs_ok = nrx.decode_data(xdet, length, mcs, max_psdu, wgt)
    cs_ok = dt >= nrx.CS_DET_THRESHOLD
    ok = cs_ok & lsig_ok & htsig_ok & (mcs_rx == mcs) & fcs_ok
    u8 = lambda v: v.to(torch.uint8)
    return {"psdu": psdu, "ok": u8(ok), "fcs_ok": u8(fcs_ok),
            "cs_ok": u8(cs_ok), "det": dt, "mcs": mcs_rx.to(torch.int32),
            "length": length, "snr_db": snr_db}


def rx_pipeline_sharded_11n_auto(x, mesh: DeviceMesh, max_psdu: int = 256,
                                 input_rate: str = "20m", device=None):
    """Sharded mixed-MCS 2x2 HT RX: antenna-local (dp, sp) detection, then
    the runtime MCS-dispatch decode tail (``phy.dot11n.rx.auto_tail``) on
    every rank's row chunk."""
    got = _detect_rows(x, mesh, device, input_rate, _sync_block_11n)
    if got is None:
        return None
    xd, l1, cf, dt, n = got
    nsym_win = max(1, (n - nrx._OFF_DATA) // 80)
    nsym_max = nrx._auto_tables_n(max_psdu, nsym_win)[3]
    sig_eq, xdet, snr_db, wgt = nrx.extract_symbols(
        xd, l1, cf, nsym_max, return_weights=True)
    out = nrx.auto_tail(sig_eq, xdet, dt, max_psdu, nsym_win, weights=wgt)
    out["snr_db"] = snr_db
    return out


def rx_pipeline_sharded_11b(x, mesh: DeviceMesh, max_psdu: int = 256,
                            device=None):
    """Sharded DSSS RX: the Barker chip-rate correlation — the dominant
    per-chip work of the 11b chain — runs on (dp, sp) blocks with a
    16-chip halo, then the mixed-rate decode tail
    (``phy.dot11b.rx.auto_tail``) on every rank's row chunk
    (fb11bdemod_config.hpp:92-142).

    x: the global (B, N) chips at 11 Msps or this rank's :class:`Shard`;
    B must divide by the rank count.  Returns this rank's row chunk of
    the ``rx_pipeline_auto`` dict."""
    lay = _layout(mesh, device)
    if lay is None:
        return None
    _, _, _, _, s = lay
    xl, n = _shard_in(x, mesh, lay, "11m", _HALO_11B)
    # the last block's zero halo matches the unsharded correlate_stream
    # once the surplus tail is cut off
    xx = _halo(xl, _HALO_11B, mesh, s)
    cl = df.correlate_stream(xx, B11.BARKER.astype(np.complex64))
    cl = cl[:, : xl.shape[1]]
    xd = _blocks_to_rows(xl, mesh)
    c2 = _blocks_to_rows(cl, mesh)[:, : n - 10]   # correlate_stream's length
    return brx.auto_tail(xd, c2, max_psdu)
