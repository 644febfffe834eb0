"""The port's sharding layer (``sora_tpu_torch.parallel``) on gloo ranks,
held to the JAX package's sharded functions on its 8-device CPU mesh.

One module fixture starts 8 gloo ranks of ``tests/torch_shard_ranks.py``
(the port only, never JAX) — a (2, 4) mesh, as ``make_mesh()`` makes of
JAX's 8 CPU devices (conftest.py) — and, beside them, one process that
brings up a world of size 1 itself.  The ranks run every scenario of
tests/test_sharding.py on the same numpy inputs and hand back their
gathered rows.  Each scenario is compared with JAX's sharded function and
with the port's unsharded pipeline: bits, bytes, flags, rates and lts1
equal; cfo within 1e-6 and det within 1e-4 (test_sharding.py:46-47,
139-142); snr_db within 1e-3 dB.  The JAX chain on the CPU runs its float
Viterbi, so bytes past a frame's length are held to the port's unsharded
pipeline (the same decoder) and not to JAX.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sora_tpu.golden import dot11a_np as ga
from sora_tpu.golden import dot11b_np as gb
from sora_tpu.golden import dot11n_np as gn
from sora_tpu.mac import frame as fr
from sora_tpu.parallel import distributed as jdist
from sora_tpu.parallel import shard as jsh
from sora_tpu.phy import frontend as jfe
from sora_tpu.phy.dot11a import tx as jtx
from sora_tpu.phy.dot11n import rx as jnrx
from sora_tpu_torch.parallel import distributed as tdist
from sora_tpu_torch.parallel import shard as tsh
from sora_tpu_torch.phy.dot11a import rx as tarx
from sora_tpu_torch.phy.dot11b import rx as tbrx
from sora_tpu_torch.phy.dot11n import rx as tnrx
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_shard_ranks.py"
N_RANKS = 8
SPAWN_TIMEOUT = 300           # seconds for the whole 8-rank run
CFO_ATOL, DET_ATOL, SNR_ATOL = 1e-6, 1e-4, 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    """The inputs of tests/test_sharding.py, with its seeds."""
    rng = np.random.default_rng(7)                      # frames fixture
    B, rate, psdu_len = 8, 12, 80
    psdus = [fr.build_data_frame(bytes(rng.integers(0, 256, psdu_len - 28,
                                                    dtype=np.uint8)), seq=i)
             for i in range(B)]
    arr = np.stack([np.frombuffer(p, np.uint8) for p in psdus])
    waves = np.asarray(jtx.modulate(arr, rate, arr.shape[1]))
    x = np.zeros((B, 4096), np.complex64)
    for i in range(B):
        off = 13 * i + 40
        x[i, off: off + waves.shape[1]] = waves[i]
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * 0.01
    x40 = np.array(jfe.upsample2(jnp.asarray(x)))
    # the same frames with their preambles across the first time-block
    # boundary (sample 1024 of the (2, 4) mesh), so the halo carries
    # the STS plateau and the LTS correlation
    straddle = np.zeros_like(x)
    for i in range(B):
        off = 760 + 40 * i
        straddle[i, off: off + waves.shape[1]] = waves[i]
    straddle += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
                 ).astype(np.complex64) * 0.01

    rng = np.random.default_rng(11)                     # 11n MCS 9
    ht = np.zeros((8, 2, 4096), np.complex64)
    for i in range(8):
        psdu = fr.build_data_frame(bytes(rng.integers(
            0, 256, 52, dtype=np.uint8)), seq=i)
        while True:
            H = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                 ) / np.sqrt(2.0)
            if abs(np.linalg.det(H)) > 0.3:
                break
        w = H @ np.asarray(gn.modulate(psdu, 9))
        off = 30 + 11 * i
        ht[i, :, off: off + w.shape[1]] = w
    ht += (rng.normal(size=ht.shape) + 1j * rng.normal(size=ht.shape)
           ).astype(np.complex64) * 0.01

    rng = np.random.default_rng(23)                     # 11n noise
    noise = (rng.normal(size=(8, 2, 4096))
             + 1j * rng.normal(size=(8, 2, 4096))).astype(np.complex64)

    rng = np.random.default_rng(0x50BA)                 # conftest's rng
    rates = [6, 12, 24, 54, 9, 18, 36, 48]
    psdus = [fr.build_data_frame(bytes(rng.integers(0, 256, 40,
                                                    dtype=np.uint8)),
                                 seq=i) for i in range(8)]
    mixed = np.zeros((8, 4096), np.complex64)
    for i, (p, r) in enumerate(zip(psdus, rates)):
        w = ga.modulate(p, r).astype(np.complex64)
        mixed[i, 40 + 11 * i: 40 + 11 * i + len(w)] = w
    mixed += (rng.normal(size=mixed.shape) + 1j * rng.normal(size=mixed.shape)
              ).astype(np.complex64) * 0.02

    rng = np.random.default_rng(0x50BA)
    specs = [(1, "long"), (2, "long"), (5.5, "long"), (11, "long"),
             (2, "short"), (5.5, "short"), (11, "short"), (11, "long")]
    psdus = [fr.build_data_frame(bytes(rng.integers(0, 256, 40,
                                                    dtype=np.uint8)),
                                 seq=i) for i in range(8)]
    dsss = np.zeros((8, 8192), np.complex64)
    for i, (p, (r, pre)) in enumerate(zip(psdus, specs)):
        w = gb.modulate(p, r, preamble=pre).astype(np.complex64)
        dsss[i, 60 + 13 * i: 60 + 13 * i + len(w)] = w
    dsss += (rng.normal(size=dsss.shape) + 1j * rng.normal(size=dsss.shape)
             ).astype(np.complex64) * 0.02
    return {"frames": x, "frames40": x40, "straddle": straddle, "ht": ht,
            "noise": noise, "mixed": mixed, "dsss": dsss}


def _launch(tmp: Path, name: str, inp: dict, n: int):
    """Start n ranks of the scenario program (n = 1: no WORLD_SIZE, the
    program brings up its own world of size 1)."""
    np.savez(tmp / f"{name}_in.npz", **inp)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    port = _free_port()
    procs = []
    for rank in range(n):
        e = dict(env)
        if n > 1:
            e.update(RANK=str(rank), LOCAL_RANK=str(rank),
                     WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(RANKS), str(tmp / f"{name}_in.npz"),
             str(tmp / f"{name}_out.npz")], cwd=ROOT, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, timeout: float):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    inp = _inputs()
    many = _launch(tmp, "mesh", inp, N_RANKS)
    solo = _launch(tmp, "solo", {"frames": inp["frames"],
                                 "solo": np.array(1)}, 1)
    _wait(many + solo, SPAWN_TIMEOUT)

    def load(name):
        got = {}
        with np.load(tmp / f"{name}_out.npz") as f:
            for key in f.files:
                scen, _, k = key.partition("/")
                if k:
                    got.setdefault(scen, {})[k] = f[key]
                else:
                    got[scen] = f[key]
        return got

    return inp, load("mesh"), load("solo")


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh()


def _host(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def _equal(got, want, keys, what):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _bytes_within_length(got, want, what):
    for i, n in enumerate(want["length"]):
        np.testing.assert_array_equal(got["psdu"][i, :n], want["psdu"][i, :n],
                                      err_msg=f"{what} psdu row {i}")


def _close(got, want, key, atol, what):
    np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                               err_msg=f"{what} {key}")


def _unsharded_fixed(x, rate):
    return fetch(tarx.rx_pipeline(torch.from_numpy(x), rate, max_psdu=128))


def check_mesh(inp, mesh, jm):
    assert int(mesh["world"]) == N_RANKS
    assert tuple(mesh["mesh"]) == tuple(jm.devices.shape) == (2, 4)


def check_sync(inp, mesh, jm):
    got = mesh["sync"]
    x = inp["frames"]
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jm, P("dp", "sp")))
    want = dict(zip(("lts1", "cfo", "det"),
                    (np.asarray(v) for v in jsh.synchronize_sharded(xs, jm))))
    _equal(got, want, ("lts1",), "sync vs JAX")
    _close(got, want, "cfo", CFO_ATOL, "sync vs JAX")
    _close(got, want, "det", DET_ATOL, "sync vs JAX")
    ref = dict(zip(("lts1", "cfo", "det"), fetch(tarx.synchronize(
        torch.from_numpy(x)))))
    _equal(got, ref, ("lts1",), "sync vs unsharded")
    _close(got, ref, "cfo", CFO_ATOL, "sync vs unsharded")
    _close(got, ref, "det", DET_ATOL, "sync vs unsharded")
    assert got["lts1"].dtype == np.int32


def _check_fixed(got, inp, jm, what):
    x = inp["frames"]
    assert got["ok"].all(), got["length"]
    want = _host(jsh.rx_pipeline_sharded(jnp.asarray(x), jm, 12,
                                         max_psdu=128))
    assert sorted(got) == sorted(want)
    _equal(got, want, ("ok", "fcs_ok", "length"), f"{what} vs JAX")
    _bytes_within_length(got, want, f"{what} vs JAX")
    _close(got, want, "snr_db", SNR_ATOL, f"{what} vs JAX")
    ref = _unsharded_fixed(x, 12)
    assert ref["cs_ok"].all()
    _equal(got, ref, ("psdu", "ok", "fcs_ok", "length"),
           f"{what} vs unsharded")
    _close(got, ref, "snr_db", SNR_ATOL, f"{what} vs unsharded")
    for k in ("ok", "fcs_ok"):
        assert got[k].dtype == np.uint8
    assert got["length"].dtype == np.int32


def check_fixed(inp, mesh, jm):
    _check_fixed(mesh["fixed"], inp, jm, "fixed rate 12")


def check_auto(inp, mesh, jm):
    got, x = mesh["auto"], inp["mixed"]
    assert got["ok"].all()
    assert [int(v) for v in got["rate_mbps"]] == [6, 12, 24, 54, 9, 18, 36,
                                                   48]
    want = _host(jsh.rx_pipeline_sharded_auto(jnp.asarray(x), jm,
                                              max_psdu=128))
    assert sorted(got) == sorted(want)
    keys = ("ok", "fcs_ok", "sig_ok", "cs_ok", "rate_mbps", "length")
    _equal(got, want, keys, "auto vs JAX")
    _bytes_within_length(got, want, "auto vs JAX")
    _close(got, want, "det", DET_ATOL, "auto vs JAX")
    ref = fetch(tarx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=128))
    _equal(got, ref, keys + ("psdu",), "auto vs unsharded")
    _close(got, ref, "snr_db", SNR_ATOL, "auto vs unsharded")


def check_straddle(inp, mesh, jm):
    got, x = mesh["straddle"], inp["straddle"]
    assert got["ok"].all() and (got["rate_mbps"] == 12).all()
    want = _host(jsh.rx_pipeline_sharded_auto(jnp.asarray(x), jm,
                                              max_psdu=128))
    keys = ("ok", "fcs_ok", "sig_ok", "cs_ok", "rate_mbps", "length")
    _equal(got, want, keys, "straddle vs JAX")
    _bytes_within_length(got, want, "straddle vs JAX")
    _close(got, want, "det", DET_ATOL, "straddle vs JAX")
    ref = fetch(tarx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=128))
    _equal(got, ref, keys + ("psdu",), "straddle vs unsharded")
    _close(got, ref, "snr_db", SNR_ATOL, "straddle vs unsharded")


def check_straddle_sync(inp, mesh, jm):
    got, x = mesh["straddle_sync"], inp["straddle"]
    # the STS onset lies in block 0 and the LTS peak in block 1 for the
    # later rows: the lock crosses the boundary
    assert (got["lts1"] >= 1024).any() and (got["lts1"] < 1024).any()
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jm, P("dp", "sp")))
    want = dict(zip(("lts1", "cfo", "det"),
                    (np.asarray(v) for v in jsh.synchronize_sharded(xs, jm))))
    ref = dict(zip(("lts1", "cfo", "det"), fetch(tarx.synchronize(
        torch.from_numpy(x)))))
    for r, what in ((want, "JAX"), (ref, "unsharded")):
        _equal(got, r, ("lts1",), f"straddle sync vs {what}")
        _close(got, r, "cfo", CFO_ATOL, f"straddle sync vs {what}")
        _close(got, r, "det", DET_ATOL, f"straddle sync vs {what}")


def check_auto40(inp, mesh, jm):
    got, x40 = mesh["auto40"], inp["frames40"]
    assert got["ok"].all() and (got["rate_mbps"] == 12).all()
    want = _host(jsh.rx_pipeline_sharded_auto(jnp.asarray(x40), jm,
                                              max_psdu=128, input_rate="40m"))
    keys = ("ok", "fcs_ok", "sig_ok", "cs_ok", "rate_mbps", "length")
    _equal(got, want, keys, "auto 40m vs JAX")
    _bytes_within_length(got, want, "auto 40m vs JAX")
    ref = fetch(tarx.rx_pipeline_auto(torch.from_numpy(x40), max_psdu=128,
                                      input_rate="40m"))
    _equal(got, ref, keys + ("psdu",), "auto 40m vs unsharded")


def check_n9(inp, mesh, jm):
    got, x = mesh["n9"], inp["ht"]
    assert got["ok"].all() and (got["mcs"] == 9).all()
    want = _host(jsh.rx_pipeline_sharded_11n(jnp.asarray(x), jm, 9,
                                             max_psdu=128))
    assert sorted(got) == sorted(want)
    keys = ("ok", "fcs_ok", "cs_ok", "mcs", "length")
    _equal(got, want, keys, "11n MCS 9 vs JAX")
    _bytes_within_length(got, want, "11n MCS 9 vs JAX")
    _close(got, want, "det", DET_ATOL, "11n MCS 9 vs JAX")
    ref = fetch(tnrx.rx_pipeline(torch.from_numpy(x), 9, max_psdu=128))
    _equal(got, ref, keys, "11n MCS 9 vs unsharded")
    _bytes_within_length(got, ref, "11n MCS 9 vs unsharded")
    _close(got, ref, "snr_db", SNR_ATOL, "11n MCS 9 vs unsharded")


def check_n9sync(inp, mesh, jm):
    got, x = mesh["n9sync"], inp["ht"]
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jm, P("dp", None,
                                                            "sp")))
    want = dict(zip(("lts1", "cfo", "det"), (np.asarray(v) for v in
                                             jsh.synchronize_sharded_11n(
                                                 xs, jm))))
    single = dict(zip(("lts1", "cfo", "det"), (np.asarray(v) for v in
                                               jnrx.synchronize(
                                                   jnp.asarray(x)))))
    for ref, what in ((want, "JAX sharded"), (single, "JAX single"),
                      (dict(zip(("lts1", "cfo", "det"), fetch(
                          tnrx.synchronize(torch.from_numpy(x))))),
                       "unsharded")):
        _equal(got, ref, ("lts1",), f"11n sync vs {what}")
        _close(got, ref, "cfo", CFO_ATOL, f"11n sync vs {what}")
        _close(got, ref, "det", DET_ATOL, f"11n sync vs {what}")


def check_nnoise(inp, mesh, jm):
    got, x = mesh["nnoise"], inp["noise"]
    assert not got["cs_ok"].any(), got["det"]
    assert not got["ok"].any()
    want = _host(jsh.rx_pipeline_sharded_11n_auto(jnp.asarray(x), jm,
                                                  max_psdu=128))
    assert sorted(got) == sorted(want)
    _equal(got, want, ("ok", "cs_ok", "fcs_ok"), "11n noise vs JAX")
    _close(got, want, "det", DET_ATOL, "11n noise vs JAX")
    ref = fetch(tnrx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=128))
    _equal(got, ref, ("ok", "cs_ok", "fcs_ok"), "11n noise vs unsharded")


def check_b(inp, mesh, jm):
    got, x = mesh["b"], inp["dsss"]
    assert got["ok"].all()
    assert [float(v) for v in got["rate_mbps"]] == [1, 2, 5.5, 11, 2, 5.5,
                                                     11, 11]
    want = _host(jsh.rx_pipeline_sharded_11b(jnp.asarray(x), jm,
                                             max_psdu=128))
    assert sorted(got) == sorted(want)
    keys = ("ok", "fcs_ok", "plcp_ok", "length", "signal", "length_us", "t0",
            "preamble", "data_chip0", "rate_mbps")
    _equal(got, want, keys, "11b vs JAX")
    _bytes_within_length(got, want, "11b vs JAX")
    ref = fetch(tbrx.rx_pipeline_auto(torch.from_numpy(x), max_psdu=128))
    _equal(got, ref, keys + ("psdu",), "11b vs unsharded")


def check_small(inp, mesh, jm):
    full = jdist.surviving_mesh()
    assert full.devices.size == N_RANKS
    small = jdist.surviving_mesh(exclude_devices=list(jax.devices())[4:])
    assert tuple(mesh["small_mesh"]) == tuple(small.devices.shape) == (1, 4)
    _check_fixed(mesh["small"], inp, small, "surviving mesh")
    _equal(mesh["small"], mesh["fixed"], ("psdu", "ok", "length"),
           "surviving mesh vs full mesh")


def check_solo(inp, solo, jm):
    assert int(solo["world"]) == 1
    _check_fixed(solo["fixed"], inp, jm, "world of size 1")


SCENARIOS = ("mesh", "sync", "fixed", "auto", "straddle", "straddle_sync",
             "auto40", "n9", "n9sync", "nnoise", "b", "small", "solo")


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jax_and_unsharded(runs, jmesh, name):
    inp, mesh, solo = runs
    globals()[f"check_{name}"](inp, solo if name == "solo" else mesh,
                               jmesh)


# -----------------------------------------------------------------------------
# in this process: a world of size 1 with gloo
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world1():
    assert not torch.distributed.is_initialized()
    mesh = tsh.make_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_make_mesh_brings_up_world_of_one(world1):
    assert torch.distributed.get_world_size() == 1
    assert torch.distributed.get_backend() == "gloo"
    assert tuple(world1.mesh.shape) == (1, 1)
    assert world1.mesh_dim_names == ("dp", "sp")
    with pytest.raises(ValueError, match="a cpu mesh cannot run on meta"):
        tsh.rx_pipeline_sharded(np.zeros((1, 512), np.complex64), world1, 12,
                                device="meta")


def test_shard_input_matches_global_input(world1):
    """A Shard from from_process_local decodes as the global batch does,
    through the 40 Msps front end too."""
    inp = _inputs()
    x, x40 = inp["frames"], inp["frames40"]
    for arr, rate in ((x, "20m"), (x40, "40m")):
        sh = tdist.from_process_local(arr, world1, device="cpu")
        assert isinstance(sh, tsh.Shard) and sh.shape == arr.shape
        a = fetch(tsh.rx_pipeline_sharded_auto(sh, world1, max_psdu=128,
                                               input_rate=rate,
                                               device="cpu"))
        b = fetch(tsh.rx_pipeline_sharded_auto(arr, world1, max_psdu=128,
                                               input_rate=rate,
                                               device="cpu"))
        assert a["ok"].all()
        _equal(a, b, sorted(b), f"Shard vs global at {rate}")


def test_shape_checks_raise(world1):
    x = np.zeros((8, 200), np.complex64)
    with pytest.raises(ValueError, match="shorter than the halo"):
        tsh.rx_pipeline_sharded(x, world1, 12, device="cpu")
    with pytest.raises(ValueError, match="dp=3"):
        tsh.mesh_of([0], 3, "cpu")


def test_blocks_and_rows_are_inverse(world1):
    v = torch.arange(24).reshape(2, 3, 4).to(torch.complex64)
    rows = tsh._blocks_to_rows(v, world1)
    assert torch.equal(rows, v)
    assert torch.equal(tsh._rows_to_blocks(rows, world1), v)
