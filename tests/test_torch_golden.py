"""The port's own copies of the numpy golden models
(``sora_tpu_torch/golden/``) against ``sora_tpu.golden``: ``modulate``
equal bit for bit, and ``demodulate`` equal field for field, at several
rates of 802.11a, b and n."""

import dataclasses

import numpy as np
import pytest

from sora_tpu.golden import dot11a_np as ja
from sora_tpu.golden import dot11b_np as jb
from sora_tpu.golden import dot11n_np as jn
from sora_tpu.mac import frame as fr
from sora_tpu_torch.golden import dot11a_np as ta
from sora_tpu_torch.golden import dot11b_np as tb
from sora_tpu_torch.golden import dot11n_np as tn


def _psdu(seed: int, n: int = 60) -> bytes:
    rng = np.random.default_rng(seed)
    return fr.build_data_frame(bytes(rng.integers(0, 256, n,
                                                  dtype=np.uint8)), seq=seed)


def _air(w: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pad = lambda n: np.zeros(w.shape[:-1] + (n,), w.dtype)
    x = np.concatenate([pad(37), w, pad(100)], axis=-1)
    return x + (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
                ) * 0.01


def _fields(res) -> dict:
    d = dataclasses.asdict(res)
    d.pop("_debug", None)
    return d


def _same_result(got, want):
    g, w = _fields(got), _fields(want)
    assert sorted(g) == sorted(w)
    for k in g:
        if isinstance(w[k], float):
            assert g[k] == w[k] or (np.isnan(g[k]) and np.isnan(w[k])), k
        else:
            assert g[k] == w[k], k


@pytest.mark.parametrize("rate", [6, 24, 54])
def test_dot11a_copy_equals_golden(rate):
    psdu = _psdu(rate)
    w = ta.modulate(psdu, rate)
    np.testing.assert_array_equal(w, ja.modulate(psdu, rate))
    x = _air(w, rate)
    got, want = ta.demodulate(x), ja.demodulate(x)
    assert want.ok and want.psdu == psdu
    _same_result(got, want)


@pytest.mark.parametrize("rate,preamble", [(1, "long"), (5.5, "long"),
                                           (11, "short")])
def test_dot11b_copy_equals_golden(rate, preamble):
    psdu = _psdu(int(rate * 2))
    w = tb.modulate(psdu, rate, preamble=preamble)
    np.testing.assert_array_equal(w, jb.modulate(psdu, rate,
                                                 preamble=preamble))
    x = _air(w, int(rate * 2))
    got, want = tb.demodulate(x), jb.demodulate(x)
    assert want.ok and want.psdu == psdu
    _same_result(got, want)


@pytest.mark.parametrize("mcs,short_gi", [(3, False), (9, False),
                                          (15, True)])
def test_dot11n_copy_equals_golden(mcs, short_gi):
    psdu = _psdu(40 + mcs)
    w = tn.modulate(psdu, mcs, short_gi=short_gi)
    np.testing.assert_array_equal(w, jn.modulate(psdu, mcs,
                                                 short_gi=short_gi))
    x = _air(w if w.shape[0] == 2 else np.repeat(w, 2, axis=0), mcs)
    got, want = tn.demodulate(x), jn.demodulate(x)
    assert want.ok and want.psdu == psdu
    _same_result(got, want)
