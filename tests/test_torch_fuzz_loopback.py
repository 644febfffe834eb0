"""The port's receivers (sora_tpu_torch, CPU) against the JAX package's
on tests/test_fuzz_loopback.py's sweeps: 24 11a frames of 5-600 bytes
over all rates in one ``rx_pipeline_auto`` batch, 21 11b
rate/preamble/length combinations, 12 + 12 11n frames over both stream
classes, and four garbage inputs through every ``demodulate``.

Each test runs the JAX suite's own test function, records the JAX
receiver's inputs and outputs, and holds the port to them as
tests/torch_robustness.py says.  Garbage must give ``not ok`` with a
``str`` reason and no exception, with the JAX chain's reason, rate or
MCS, length and (11a, 11n) sync position.
"""

import numpy as np
import torch

from sora_tpu_torch.tools import robustness as rb
from torch_robustness import check, record

torch.set_num_threads(2)


def test_fuzz_11a_lengths_and_rates_matches_jax(rng, monkeypatch):
    from test_fuzz_loopback import test_fuzz_11a_lengths_and_rates as jax_case

    calls = record(monkeypatch, "a", ["rx_pipeline_auto"])
    jax_case(rng)
    assert len(calls) == 1
    check(rb.fuzz_11a(), calls[0])


def test_fuzz_11b_lengths_rates_preambles_matches_jax(rng, monkeypatch):
    from test_fuzz_loopback import \
        test_fuzz_11b_lengths_rates_preambles as jax_case

    calls = record(monkeypatch, "b", ["rx_pipeline_auto"])
    jax_case(rng)
    assert len(calls) == 1
    check(rb.fuzz_11b(), calls[0])


def test_fuzz_11n_lengths_both_stream_classes_matches_jax(rng, monkeypatch):
    from test_fuzz_loopback import \
        test_fuzz_11n_lengths_both_stream_classes as jax_case

    calls = record(monkeypatch, "n", ["rx_pipeline_auto",
                                      "rx_pipeline_auto_1ss"])
    jax_case(rng)
    batches = rb.fuzz_11n()
    assert len(calls) == len(batches) == 2
    for batch, call in zip(batches, calls):
        check(batch, call)


def test_fuzz_garbage_never_crashes_matches_jax(rng, monkeypatch):
    from test_fuzz_loopback import test_fuzz_garbage_never_crashes as jax_case

    calls = {phy: record(monkeypatch, phy, ["demodulate"])
             for phy in ("a", "b", "n")}
    jax_case(rng)
    cases = rb.garbage()
    assert all(len(c) == len(cases) for c in calls.values())
    for i, x in enumerate(cases):
        np.testing.assert_array_equal(x, calls["a"][i][1])
        got = rb.demodulate_garbage(x, "cpu")
        for phy, r in got.items():
            want = calls[phy][i][2]
            assert not r.ok and isinstance(r.reason, str), (i, phy, r)
            fields = ["ok", "reason", "rate_mbps", "length_us"] \
                if phy == "b" else ["ok", "reason", "length", "start",
                                    "mcs" if phy == "n" else "rate_mbps"]
            for key in fields:
                assert getattr(r, key) == getattr(want, key), (i, phy, key)
