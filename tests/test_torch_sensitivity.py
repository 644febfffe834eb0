"""The port's sensitivity sweep (``sora_tpu_torch.tools.sensitivity_sweep``)
against the repository's reference tool (``tools/sensitivity_sweep.py``,
the JAX chains on the CPU) at a reduced grid: fewer SNR points, fewer
MCS, smaller ``n``, the same seeds, so the same noisy input.

A table cell that reads ``ok`` or ``fail`` must be equal.  A ``fer`` cell
may differ by at most one frame in ``n``: on the CPU the JAX chain
decodes with its float Viterbi, the port with the radix-4 decoder of the
kernel's plain version, and near the waterfall a frame can close its FCS
under one and not the other.

The Viterbi decode count per receiver call is the kernel's launch count
on the card: 1 per 11a call, 2 per 11n call (HT-SIG and data), 0 per 11b
call.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sora_tpu_torch.ops import viterbi_cuda as vc
from sora_tpu_torch.tools import sensitivity_sweep as tsw

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_sensitivity_sweep", ROOT / "tools" / "sensitivity_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tool()

# (sweep name, kwargs, frames per point, decodes per point)
GRID = [
    ("sweep_11a", dict(snrs=[3, 24], n=4), 4, 8),
    ("sweep_11b", dict(snrs=[0, 8], n=4), 4, 0),
    ("sweep_11n", dict(snrs=[9, 30], n=4, mcs_list=(7, 15)), 4, 4),
    ("sweep_11n_mixed", dict(snrs=[24, 36], n=4, mcs_list=(15,)), 4, 4),
    ("sweep_11a_multipath", dict(snrs=[15, 30], n=4, rates=(54,)), 4, 2),
]


def _cells(rows, snrs):
    """{row: [cell text]} of the tool's markdown table."""
    out = {}
    for line in REF._table("t", rows, snrs).splitlines()[4:]:
        parts = [c.strip() for c in line.strip("|").split("|")]
        out[parts[0]] = parts[1:]
    return out


@pytest.mark.parametrize("name,kw,n,decodes", GRID,
                         ids=[g[0] for g in GRID])
def test_sweep_equals_reference_tool(monkeypatch, name, kw, n, decodes):
    calls = []
    orig = vc.decode_blocks
    monkeypatch.setattr(vc, "decode_blocks",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = getattr(tsw, name)(device="cpu", **kw)
    monkeypatch.setattr(vc, "decode_blocks", orig)
    want = getattr(REF, name)(**kw)
    assert list(got) == list(want)
    assert len(calls) == decodes * len(kw["snrs"])
    for row in want:
        for (s_g, fer_g, ber_g), (s_w, fer_w, _) in zip(got[row], want[row]):
            assert s_g == s_w
            assert abs(fer_g - fer_w) * n <= 1 + 1e-9, (row, s_g)
            assert 0.0 <= ber_g <= 1.0
    cg, cw = _cells(got, kw["snrs"]), _cells(want, kw["snrs"])
    assert list(cg) == list(cw)
    for row in cw:
        for a, b in zip(cg[row], cw[row]):
            if {a, b} & {"ok", "fail"}:
                assert a == b, (row, a, b)


def test_sweep_rows_and_noise_equal_reference():
    """The port draws the reference tool's frames and noise: the same
    seeds give the same PSDUs and the same noisy samples, bit for bit."""
    rng_t, rng_r = np.random.default_rng(17), np.random.default_rng(17)
    assert tsw._frames(rng_t, 3, 40) == REF._frames(rng_r, 3, 40)
    x = np.ones((2, 64), np.complex64)
    assert np.array_equal(tsw._noisy(x, 1.0, 6.0, rng_t),
                          REF._noisy(x, 1.0, 6.0, rng_r))
    ch_t, ch_r = np.random.default_rng(5), np.random.default_rng(5)
    v = np.ones((2, 100), np.complex64)
    assert np.array_equal(tsw._multipath_2x2(v, ch_t),
                          REF._multipath_2x2(v, ch_r))
    assert tsw.SNRS_A == [0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30]
    assert tsw.A_RATES == (6, 9, 12, 18, 24, 36, 48, 54)


def test_table_equals_reference():
    rows = {"6 Mbps": [(0, 1.0, 0.4), (3, 0.25, 0.01), (6, 0.0, 0.0),
                       (9, 0.0, 2e-4)]}
    assert tsw._table("802.11a", rows, [0, 3, 6, 9]) == \
        REF._table("802.11a", rows, [0, 3, 6, 9])


def test_sweep_waterfall_on_one_row():
    """One 11a row over the waterfall: fails at 0 dB, decodes at 30."""
    rows = tsw.sweep_11a([0, 30], n=4, rates=(54,), device="cpu")
    assert list(rows) == ["54 Mbps"]
    (s0, fer0, _), (s1, fer1, ber1) = rows["54 Mbps"]
    assert (s0, fer0) == (0, 1.0) and (s1, fer1, ber1) == (30, 0.0, 0.0)


def test_sweep_main_prints_the_tables(monkeypatch, capsys):
    """main() at a grid cut to one point per table."""
    for attr in ("SNRS_A", "SNRS_B", "SNRS_N", "SNRS_AM", "SNRS_NM"):
        monkeypatch.setattr(tsw, attr, [30])
    for name in ("sweep_11a", "sweep_11b", "sweep_11n", "sweep_11n_mixed",
                 "sweep_11a_multipath"):
        fn = getattr(tsw, name)
        monkeypatch.setattr(tsw, name,
                            lambda snrs, fn=fn, **k: fn(snrs, n=2, **k))
    assert tsw.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# Sensitivity waterfall (loopback, AWGN)")
    assert out.count("\n## ") == 5
    for row in ("| 54 Mbps | ok |", "| 11 Mbps short | ok |",
                "| MCS 15 | ok |", "| MCS 7 (1ss) | ok |"):
        assert row in out, row
