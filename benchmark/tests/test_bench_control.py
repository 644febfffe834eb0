"""The controls of ``correct``: the reference put in the program's place
in a lower precision must fail the cell's limits.  TF32 products (the
configurations state float32 products with TF32 off) must fail
``snr_db_gap``; bfloat16 arithmetic must fail ``det_gap`` and
``cfo_gap``.  On the CPU TF32 is emulated by rounding the products'
inputs to its 10-bit mantissa; the card test uses the card's TF32."""

import numpy as np
import pytest
import torch

from benchmark import generator as G
from benchmark import judge as J
from benchmark.reference import ofdm as R
from benchmark.tests.conftest import TINY, cell_parts


def _numbers(cell, prec, dev, overrides):
    config, mix, limits = cell_parts(cell)
    mix = {**mix, **overrides}
    t = G.build(mix, config, 2 ** 31 + 21, dev)
    phy = G.phy_module(config)
    nums = {}
    for b in t.batches:
        got = J.judge(J.control(b, t, phy, mix, prec), b, t, phy, mix)
        for k, v in got.items():
            nums[k] = max(v, nums.get(k, 0))
    return nums, limits


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.fixture
def emulated_tf32(monkeypatch):
    real = R.dft64

    def dft64(y, prec):
        if prec.name != "tf32":
            return real(y, prec)
        k = np.arange(64)
        ang = -2.0 * np.pi * np.outer(k, k) / 64.0
        c = _tf32_round(torch.as_tensor(np.cos(ang), dtype=torch.float32))
        s = _tf32_round(torch.as_tensor(np.sin(ang), dtype=torch.float32))
        yr = _tf32_round(y.real.float())
        yi = _tf32_round(y.imag.float())
        return torch.complex(yr @ c - yi @ s, yr @ s + yi @ c)
    monkeypatch.setattr(R, "dft64", dft64)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tf32_control_fails(cell, cpu, emulated_tf32):
    nums, lim = _numbers(cell, R.TF32, cpu, {**TINY[cell], "streams": 16})
    assert nums["snr_db_gap"] > lim["snr_db_gap"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_bf16_control_fails(cell, cpu):
    nums, lim = _numbers(cell, R.BF16, cpu, TINY[cell])
    assert nums["det_gap"] > lim["det_gap"]
    assert nums["cfo_gap"] > lim["cfo_gap"]


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(TINY))
def test_controls_fail_on_the_card(cell, card):
    over = {"streams": 256 if cell != "a-node-air-2k" else 64, "pool": 1}
    tf32, lim = _numbers(cell, R.TF32, card, over)
    assert tf32["snr_db_gap"] > lim["snr_db_gap"]
    bf16, _ = _numbers(cell, R.BF16, card, over)
    assert bf16["det_gap"] > lim["det_gap"]
    assert bf16["cfo_gap"] > lim["cfo_gap"]
