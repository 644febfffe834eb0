"""The plain reference agrees with the frozen golden receivers, and
imports nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generator as G
from benchmark import judge as J
from benchmark import run
from benchmark.golden import dot11a_np as ga
from benchmark.golden import dot11n_np as gn
from benchmark.reference import ofdm as R
from benchmark.tests.conftest import TINY, cell_parts


@pytest.mark.parametrize("cell, golden", [("a54-sat-8k", ga),
                                          ("n15-sat", gn)])
def test_reference_agrees_with_golden(cell, golden, cpu):
    config, mix, _ = cell_parts(cell)
    mix = {**mix, **TINY[cell], "streams": 2, "pool": 1}
    t = G.build(mix, config, 17, cpu)
    b = t.batches[0]
    phy = G.phy_module(config)
    est = J.fixed_estimates(b.x, phy, R.FLOAT64)
    for r in range(b.x.shape[0]):
        xr = b.x[r].numpy().astype(np.complex128)
        lts1, _ = golden.sync(xr if cell == "n15-sat" else xr[0])
        assert est["lts1"][r] == lts1
        res = phy.demodulate(xr)
        assert res.ok and res.psdu == t.psdus[b.truth["fidx"][r]].tobytes()
        if cell == "a54-sat-8k":
            assert abs(est["snr_db"][r] - res.snr_est_db) < 0.01


def test_onset_range_covers_a_tie():
    en = torch.full((1, 40), 10.0, dtype=torch.float64)
    en[0, :5] = 0.0
    m = torch.zeros(1, 40, dtype=torch.float64)
    m[0, 5:] = 1.0
    m[0, 7] = 0.9 * (1 - 1e-7)        # on the threshold, to rounding
    lo, hi = R.onsets(en, m, 40, 1e-4)
    assert int(lo) == 5
    m[0, 5:7] = 0.0
    lo, hi = R.onsets(en, m, 40, 1e-4)
    assert (int(lo), int(hi)) == (7, 8)
    assert int(R.pick(lo, hi, m, torch.tensor([1.0]))) == 8


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.judge, benchmark.generator\n"
            "import benchmark.reference.ofdm, benchmark.roofline\n"
            "import benchmark.phy.dot11a, benchmark.phy.dot11n\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'sora_tpu_torch', 'sora_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=run.ROOT).stdout
    assert out.strip() == "[]"
