"""sora_tpu_torch stands alone and never runs quietly on the CPU.

* Importing every module of the package — the sharding layer, the
  golden-model copies, the SDL layer, the apps and the tools among them —
  pulls in
  neither JAX nor any module of the JAX package ``sora_tpu`` (checked in
  a fresh process).
* No source of the package, nor chip_smoke.py, nor the program the
  sharding tests run as gloo ranks, imports them.
* Entry points that take host data default to CUDA and raise without it;
  the bench and scaling tools exit nonzero.
* The kernel module imports without nvcc, and a build without nvcc raises.
* The native ring library builds only at first use, never on import, and
  a build without g++ raises.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sora_tpu_torch
from sora_tpu_torch.ops import viterbi_cuda as vc
from sora_tpu_torch import sdl
from sora_tpu_torch.apps import demod11, sniffer, speanalyzer, tvws
from sora_tpu_torch.apps import node as tapp
from sora_tpu_torch.parallel import distributed as pdist
from sora_tpu_torch.parallel import shard as psh
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.phy.dot11b import rx as brx
from sora_tpu_torch.phy.dot11n import rx as nrx
from sora_tpu_torch.tools import (bench, ping_over_air, scaling_bench,
                                  sensitivity_sweep)
from sora_tpu_torch.runtime import device_air, native, node, radio
from sora_tpu_torch.util import xfer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sora_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import sora_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sora_tpu_torch.__path__,
                                               "sora_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "sora_tpu" or m.startswith("sora_tpu.")]
print(len(names), bad)
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|sora_tpu)\b(?!_)|from\s+(jax|sora_tpu)\b(?!_))",
    re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sora_tpu_torch.__path__, "sora_tpu_torch."))


def test_package_imports_no_jax_nor_sora_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(maxsplit=1)
    assert int(n) == len(_modules()) >= 73
    for name in ("parallel.shard", "parallel.distributed", "golden.dot11a_np",
                 "golden.dot11b_np", "golden.dot11n_np", "apps.tvws",
                 "apps.sniffer", "apps.demod11", "tools.multihost_worker",
                 "tools.scaling_bench", "sdl", "util.hwveri", "util.render",
                 "util.trace", "apps.speanalyzer", "apps.plotview",
                 "apps.srview", "apps.usereg", "tools.sensitivity_sweep",
                 "tools.ping_over_air"):
        assert f"sora_tpu_torch.{name}" in _modules()
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PKG.rglob("*.py"), ROOT / "chip_smoke.py",
        ROOT / "tests" / "torch_shard_ranks.py"]))
def test_source_has_no_jax_or_sora_tpu_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_forbidden_pattern_spares_the_port_itself():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from sora_tpu.dsp import crc")
    assert _FORBIDDEN.search("  import sora_tpu")
    assert not _FORBIDDEN.search("from sora_tpu_torch.dsp import crc")
    assert not _FORBIDDEN.search("import sora_tpu_torch")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(600, np.complex64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfer.device_complex(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trx.demodulate(x)
    x2 = np.zeros((2, 1000), np.complex64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrx.demodulate(x2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_air.DeviceAir([x2], window=512, batch=2, overlap=128,
                             phy="n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.synthetic_traffic(1, b"\x02SORA1", False, 9, phy="n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfer.device_complex(x, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfer.device_complex8(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        radio.SoftRadio()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.synthetic_traffic(1, b"\x02SORA1", False, 24)
    # 802.11b: the receiver, the air, the traffic and the node
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        brx.demodulate(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_air.DeviceAir([x], window=512, batch=2, overlap=128,
                             phy="b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.synthetic_traffic(1, b"\x02SORA1", False, 11, phy="b")
    ring_b = native.RxRing(capacity=1 << 12)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        node.StreamingNode(ring_b, node.NodeConfig(
            phy="b", input_rate="11m", max_psdu=64, batch=1))
    assert brx.demodulate(x, device="cpu").reason == "no_frame"
    assert node.StreamingNode(ring_b, node.NodeConfig(
        phy="b", input_rate="11m", max_psdu=64, batch=1),
        device="cpu").device.type == "cpu"
    ring_b.close()
    # the bench tool exits nonzero and prints no result
    assert bench.main() == 1
    assert scaling_bench.main(["--cuda-sharded"]) == 1
    ring = native.RxRing(capacity=1 << 12)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        node.StreamingNode(ring, node.NodeConfig(max_psdu=64, batch=1))
    # the CPU only when asked for
    assert xfer.device_complex(x, "cpu").device.type == "cpu"
    assert trx.demodulate(x, device="cpu").reason == "cs_timeout"
    assert nrx.demodulate(x2, device="cpu").reason == "cs_timeout"
    assert device_air.DeviceAir([x2], window=512, batch=2, overlap=128,
                                phy="n", device="cpu").n_ant == 2
    rings = [native.RxRing(capacity=1 << 12) for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        node.StreamingNode(rings, node.NodeConfig(phy="n", max_psdu=64,
                                                  batch=1))
    assert node.StreamingNode(rings, node.NodeConfig(
        phy="n", max_psdu=64, batch=1), device="cpu").device.type == "cpu"
    for r in rings:
        r.close()
    assert node.StreamingNode(ring, node.NodeConfig(max_psdu=64, batch=1),
                              device="cpu").device.type == "cpu"
    ring.close()


def test_sharding_and_apps_raise_without_cuda(monkeypatch, tmp_path):
    """make_mesh, the sharded pipelines, the three apps and the
    multi-process helpers need CUDA unless the caller names the CPU; no
    process group is brought up on the way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 1024), np.complex64)
    for call in (lambda: psh.make_mesh(),
                 lambda: psh.make_mesh(1),
                 lambda: pdist.initialize("127.0.0.1:1", 1, 0),
                 lambda: tvws.decode_band(x[0], [-10e6, 10e6], 40e6),
                 lambda: tvws.synth_band(2, [0.0], 20e6),
                 lambda: demod11.main(["--mode", "ack"]),
                 lambda: demod11.main(["--mode", "demod", "--chain",
                                       "torch"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for fn in (psh.rx_pipeline_sharded, psh.rx_pipeline_sharded_11n):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x, None, 12)
    for fn in (psh.rx_pipeline_sharded_auto, psh.rx_pipeline_sharded_11n_auto,
               psh.rx_pipeline_sharded_11b, psh.synchronize_sharded,
               psh.synchronize_sharded_11n):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x, None)
    ring = native.RxRing(capacity=1 << 12)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sniffer.Sniffer(ring, node.NodeConfig(max_psdu=64, batch=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sniffer.main(["--synthetic", "2"])
    sn = sniffer.Sniffer(ring, node.NodeConfig(max_psdu=64, batch=1),
                         pcap_path=str(tmp_path / "c.pcap"), device="cpu")
    assert sn.node.device.type == "cpu"
    sn.close()
    ring.close()
    # the golden chain of the harness is numpy: no device needed
    assert demod11.main(["--mode", "mod", "--outfile",
                         str(tmp_path / "w.dmp")]) == 0
    assert not torch.distributed.is_initialized()


def test_kernel_module_imports_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent")
    env.pop("CUDA_HOME", None)
    code = ("import sora_tpu_torch.ops.viterbi_cuda as vc; "
            "print(vc.LAUNCHES)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0"


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(vc.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(vc.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        vc.build(force=True)


_IMPORT_NO_BUILD = r"""
import subprocess
calls = []
run = subprocess.run
subprocess.run = lambda *a, **k: calls.append(a) or run(*a, **k)
import sora_tpu_torch.runtime.native as native
import sora_tpu_torch.runtime.node, sora_tpu_torch.apps.bridge
import sora_tpu_torch.tools.node_soak, sora_tpu_torch.tools.bench
print(native._lib is None, len(calls))
"""


def test_ring_module_imports_without_building():
    env = dict(os.environ, PATH="/nonexistent")
    env.pop("CXX", None)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_NO_BUILD], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "0"]


def test_ring_build_without_gxx_raises(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(force=True)


def test_sdl_spectrum_and_sweep_raise_without_cuda(monkeypatch, tmp_path):
    """``sdl.Radio``, ``Signal.resample``, ``Signal.spectrum``,
    ``welch_spectrum``, the speanalyzer CLI, the sensitivity sweep and the
    ping tool's nodes need CUDA unless the caller names the CPU; the Radio
    allocates no ring on the way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.exp(2j * np.pi * 0.1 * np.arange(2048)).astype(np.complex64)
    made = []
    orig_ring = sdl.RxRing
    monkeypatch.setattr(sdl, "RxRing",
                        lambda *a, **k: made.append(1) or orig_ring(*a, **k))
    sig = sdl.Signal(x, 20e6)
    for call in (lambda: sdl.Radio(phy="a"),
                 lambda: sdl.Radio(phy="n"),
                 lambda: sig.resample(40e6),
                 lambda: sig.resample(40e6, device="cuda"),
                 lambda: sig.spectrum(256),
                 lambda: speanalyzer.welch_spectrum(x, 256, 20e6),
                 lambda: speanalyzer.main(["--tone", "1e6", "--msps", "20"]),
                 lambda: sensitivity_sweep.sweep_11a([30], n=1, rates=(6,)),
                 lambda: sensitivity_sweep.sweep_11b([30], n=1),
                 lambda: sensitivity_sweep.sweep_11n([30], mcs_list=(0,),
                                                     n=1),
                 lambda: sensitivity_sweep.sweep_11n_mixed([30], n=1),
                 lambda: sensitivity_sweep.sweep_11a_multipath([30], n=1),
                 lambda: sensitivity_sweep.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert made == []
    monkeypatch.setattr("os.geteuid", lambda: 0)
    monkeypatch.setattr("os.path.exists", lambda p: True)
    monkeypatch.setattr("shutil.which", lambda name: f"/usr/sbin/{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ping_over_air.main([])
    monkeypatch.undo()
    # the CPU only when asked for
    assert sig.resample(40e6, device="cpu").sample_rate == 40e6
    f, p = speanalyzer.welch_spectrum(x, 256, 20e6, device="cpu")
    assert abs(f[int(np.argmax(p))] - 2e6) < 1e5
    with sdl.Radio(phy="a", max_psdu=64, batch=1, device="cpu") as r:
        assert r.node.device.type == "cpu" and len(r.rings) == 1
