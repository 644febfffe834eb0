"""The correlator: ``dsp/filters.py::correlate_stream`` and its kernel's
wrapper ``ops/correlate_cuda.py``.

The kernel itself (``csrc/correlate.cu``) runs only on a CUDA card, where
``chip_smoke.py`` holds it to the plain loop bit for bit.  Here: the plain
loop against numpy's correlation, a CPU tensor never reaching the build,
the module importing without nvcc, and the wrapper's input check.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sora_tpu_torch.dsp import filters as df
from sora_tpu_torch.ops import correlate_cuda as cc
from sora_tpu_torch.phy.dot11a import rx as arx
from sora_tpu_torch.phy.dot11b import rx as brx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PATTERNS = {64: arx._LTS_SYM, 11: brx._BARKER}


def _cplx(rng, shape, scale=20.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("nwin", [1, 705, 4977])
@pytest.mark.parametrize("w", [64, 11])
def test_reference_matches_numpy(w, nwin, lead):
    rng = np.random.default_rng(w * 10007 + nwin)
    p = PATTERNS[w]
    x = _cplx(rng, lead + (nwin + w - 1,))
    got = df.correlate_stream(torch.from_numpy(x), p).numpy()
    assert got.shape == lead + (nwin,) and got.dtype == np.complex64
    rows = x.reshape(-1, x.shape[-1]).astype(np.complex128)
    want = np.stack([np.correlate(r, p.astype(np.complex128), "valid")
                     for r in rows]).reshape(got.shape)
    mag = np.stack([np.correlate(np.abs(r), np.abs(p).astype(np.float64),
                                 "valid") for r in rows]).reshape(got.shape)
    # fp32: w rounded complex products and w rounded adds, each off by at
    # most 2^-24 of its size, so at most (w + 2) 2^-23 of sum |x| |p|
    assert (np.abs(got - want) <= (w + 2) * 2.0 ** -23 * mag).all()


@pytest.mark.parametrize("w", [64, 11])
def test_cpu_tensor_never_builds(monkeypatch, w):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's build was reached")

    monkeypatch.setattr(cc, "build", refuse)
    monkeypatch.setattr(cc, "_library", refuse)
    monkeypatch.setattr(cc, "correlate", refuse)
    x = torch.from_numpy(_cplx(np.random.default_rng(w), (4, 300)))
    before = cc.LAUNCHES
    got = df.correlate_stream(x, PATTERNS[w])
    assert torch.equal(got, df.correlate_stream_reference(x, PATTERNS[w]))
    assert cc.LAUNCHES == before


@pytest.mark.parametrize("module", ["sora_tpu_torch.ops.correlate_cuda",
                                    "sora_tpu_torch.dsp.filters"])
def test_imports_without_nvcc(module):
    env = dict(os.environ, PATH="/nonexistent")
    env.pop("CUDA_HOME", None)
    code = (f"import {module}; "
            "import sora_tpu_torch.ops.correlate_cuda as cc; "
            "print(cc.LAUNCHES, cc.LIBRARY.name)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "libsora_correlate.so"]


@pytest.mark.parametrize("x, pattern, match", [
    (torch.zeros(2, 200, dtype=torch.complex64), np.ones(65, np.complex64),
     "pattern must have one of"),
    (torch.zeros(2, 200, dtype=torch.complex64), np.ones(12, np.complex64),
     "pattern must have one of"),
    (torch.zeros(2, 200, dtype=torch.complex64),
     np.ones((2, 64), np.complex64), "pattern must have one of"),
    (torch.zeros(2, 200, dtype=torch.complex128), np.ones(64), "complex64"),
    (torch.zeros(2, 200), np.ones(11), "complex64"),
    (torch.zeros(2, 63, dtype=torch.complex64), np.ones(64), "shorter"),
    (torch.zeros(2, 200, dtype=torch.complex64), np.ones(64),
     "CUDA device"),
])
def test_wrapper_refuses(x, pattern, match):
    before = cc.LAUNCHES
    with pytest.raises(ValueError, match=match):
        cc.correlate(x, pattern)
    assert cc.LAUNCHES == before


@pytest.mark.parametrize("w", [64, 11])
def test_taps_are_the_conjugated_pattern(w):
    p = PATTERNS[w]
    taps = np.asarray(cc._taps(p.tobytes()), np.float32)
    np.testing.assert_array_equal(taps.view(np.complex64), np.conj(p))
