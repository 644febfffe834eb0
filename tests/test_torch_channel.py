"""The port's receivers (sora_tpu_torch, CPU) against the JAX package's
on tests/test_channel.py's frequency-selective channels: 11a multipath
at 6/12/24/54 Mbps, multipath plus a +20 ppm sample clock on a long
frame, 2x2 per-tap mixing at MCS 9 and 13, and 11b two-ray.

Each test runs the JAX suite's own test function (its scenario from the
``rng`` fixture and its asserts), records the JAX receiver's input and
output, and holds the port to them: the builder of
``sora_tpu_torch/tools/robustness.py`` makes the same input, the port's
receiver gives the same exact fields and bytes, cfo and snr_db within
tests/torch_robustness.py's tolerances, and every frame decodes to its
true bytes.
"""

import pytest
import torch

from sora_tpu_torch.tools import robustness as rb
from torch_robustness import check, record

torch.set_num_threads(2)


@pytest.mark.parametrize("rate", rb.CHANNEL_RATES)
def test_11a_multipath_matches_jax(rate, rng, monkeypatch):
    from test_channel import test_11a_multipath_loopback as jax_case

    calls = record(monkeypatch, "a", ["rx_pipeline"])
    jax_case(rate, rng)
    assert len(calls) == 1
    check(rb.channel_11a(rate), calls[0])


def test_11a_multipath_plus_sfo_matches_jax(rng, monkeypatch):
    from test_channel import test_11a_multipath_plus_sfo as jax_case
    from test_channel import _multipath
    from test_sfo import sfo_resample

    calls = record(monkeypatch, "a", ["rx_pipeline"])
    jax_case(rng)
    assert len(calls) == 1
    check(rb.channel_11a_sfo(), calls[0])
    # the builder's helpers are the suite's
    w = rb.channel_11a(6).x[0]
    assert (rb.multipath(w, rb.TAPS) == _multipath(None, w, rb.TAPS)).all()
    assert (rb.sfo_resample(w, -20.0) == sfo_resample(w, -20.0)).all()


@pytest.mark.parametrize("mcs", rb.CHANNEL_MCS)
def test_11n_mimo_multipath_matches_jax(mcs, rng, monkeypatch):
    from test_channel import test_11n_mimo_multipath_loopback as jax_case

    calls = record(monkeypatch, "n", ["rx_pipeline"])
    jax_case(mcs, rng)
    assert len(calls) == 1
    check(rb.channel_11n(mcs), calls[0])


def test_11b_two_ray_matches_jax(rng, monkeypatch):
    from test_channel import test_11b_two_ray_loopback as jax_case

    calls = record(monkeypatch, "b", ["rx_pipeline_auto"])
    jax_case(rng)
    assert len(calls) == 1
    check(rb.channel_11b(), calls[0])
