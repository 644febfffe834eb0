"""The port's receivers (sora_tpu_torch, CPU) against the JAX package's
on tests/test_sfo.py's sample-clock offsets: +-20 ppm (with the carrier
offset it brings) on MTU frames (2500-byte PSDU) at all 8 rates through
``rx_pipeline_auto`` and at MCS 8-15 through the 11n ``rx_pipeline_auto``,
and the 6 Mbps MTU frame that fails without pilot-slope tracking.

Each test runs the JAX suite's own test function, records the JAX
receiver's input and output, and holds the port to them as
tests/torch_robustness.py says; beyond the suite's asserts every row
decodes to its true rate or MCS, length and bytes.  The 11n suite
modulates with the JAX package's HT TX, the port's builder with the
port's (within 2.5e-7 of it, tests/test_torch_dot11n.py), so that input
is held within 1e-5 and the port also decodes the builder's own.
"""

import numpy as np
import pytest
import torch

from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.tools import robustness as rb
from torch_robustness import check, port_equals_jax, record

torch.set_num_threads(2)


@pytest.mark.parametrize("ppm", rb.SFO_PPM)
def test_sfo_11a_all_rates_mtu_matches_jax(ppm, rng, monkeypatch):
    from test_sfo import test_sfo_11a_all_rates_mtu as jax_case

    calls = record(monkeypatch, "a", ["rx_pipeline_auto"])
    jax_case(ppm, rng)
    assert len(calls) == 1
    check(rb.sfo_11a(ppm), calls[0])


@pytest.mark.parametrize("ppm", rb.SFO_PPM)
def test_sfo_11n_all_mcs_mtu_matches_jax(ppm, rng, monkeypatch):
    from test_sfo import test_sfo_11n_all_mcs_mtu as jax_case

    calls = record(monkeypatch, "n", ["rx_pipeline_auto"])
    jax_case(ppm, rng)
    assert len(calls) == 1
    batch = rb.sfo_11n(ppm)
    check(batch, calls[0], x_atol=1e-5)
    assert rb.truth_errors(batch, rb.run(batch, "cpu")) == []


def test_sfo_without_slope_tracking_is_needed_on_the_port(rng, monkeypatch):
    """With the port's slope estimate forced to zero, the +20 ppm MTU
    frame at 6 Mbps fails, as it does in the JAX chain; with the slope
    restored it decodes.  Both runs equal the JAX chain's."""
    from test_sfo import test_sfo_without_slope_tracking_is_needed as jax_case

    calls = record(monkeypatch, "a", ["rx_pipeline"])
    jax_case(rng)
    assert len(calls) == 2           # without, then with slope tracking
    batch = rb.sfo_11a_slope()
    np.testing.assert_array_equal(batch.x, calls[0][1])
    assert not calls[0][2]["ok"][0] and calls[1][2]["ok"][0]

    with monkeypatch.context() as m:
        m.setattr(trx, "_pilot_slope", lambda pv, window=8: torch.zeros(
            pv.shape[:2], dtype=torch.float32, device=pv.device))
        flat = rb.run(batch, "cpu")
    assert not flat["ok"][0], "+20 ppm MTU@6Mbps decoded without slope " \
        "tracking"
    port_equals_jax(flat, calls[0][2])
    check(batch, calls[1])
