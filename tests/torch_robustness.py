"""Shared by tests/test_torch_{channel,sfo,fuzz_loopback}.py: run a JAX
suite's own test function with its receiver calls recorded, then feed
each recorded input to the port's receiver on the CPU and hold the two
outputs to each other.

The recorded input is also checked against the port's builder of the
same scenario (``sora_tpu_torch/tools/robustness.py``), which is what
chip_smoke.py runs on the card: equal sample for sample where both
modulate with the golden models.  Exact fields: those of
``robustness.EXACT_KEYS`` that the receiver returns, and the PSDU bytes
of each ok row up to its length.  Float fields: cfo within 1e-5
rad/sample and snr_db within 0.05 dB, as in test_torch_dot11a_auto.py.
"""

import dataclasses
import importlib

import numpy as np

from sora_tpu_torch.tools import robustness as rb

CLOSE = {"cfo": 1e-5, "snr_db": 0.05}


def record(monkeypatch, phy: str, names) -> list:
    """Wraps the JAX package's ``sora_tpu.phy.dot11{phy}.rx.<name>`` for
    each name; returns the list that collects (name, host input, host
    output) of every outermost call."""
    mod = importlib.import_module(f"sora_tpu.phy.dot11{phy}.rx")
    calls, depth = [], [0]

    def wrap(name, orig):
        def spy(x, *args, **kwargs):
            depth[0] += 1
            try:
                out = orig(x, *args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((name, np.array(x), out if not isinstance(
                    out, dict) else {k: np.asarray(v)
                                     for k, v in out.items()}))
            return out
        if hasattr(orig, "clear_cache"):
            spy.clear_cache = orig.clear_cache
        return spy

    for name in names:
        monkeypatch.setattr(mod, name, wrap(name, getattr(mod, name)))
    return calls


def port_equals_jax(got: dict, want: dict) -> None:
    """The port's outputs equal the JAX receiver's on every exact field
    and agree within CLOSE on the float fields."""
    assert sorted(got) == sorted(want)
    assert rb.exact_errors(got, want) == []
    for key, tol in CLOSE.items():
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=tol, err_msg=key)


def check(batch, call, x_atol: float = 0.0) -> dict:
    """The recorded JAX call of ``batch``'s scenario: the builder made the
    same input (within ``x_atol``), the port's receiver on that input
    equals the JAX receiver's output and meets the suite's truth.
    Returns the port's outputs."""
    name, x, want = call
    assert name == batch.fn
    assert batch.x.dtype == x.dtype == np.complex64
    if x_atol:
        np.testing.assert_allclose(batch.x, x, rtol=0, atol=x_atol)
    else:
        np.testing.assert_array_equal(batch.x, x)
    got = rb.run(dataclasses.replace(batch, x=x), "cpu")
    port_equals_jax(got, want)
    assert rb.truth_errors(batch, got) == []
    return got
