"""The traffic generator is deterministic by seed and gives every seed
the same work."""

import json

import numpy as np
import pytest
import torch

from benchmark import generator as G
from benchmark.tests.conftest import TINY, cell_parts


def _traffic(cell, seed, dev):
    config, mix, _ = cell_parts(cell)
    return G.build({**mix, **TINY[cell]}, config, seed, dev)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_same_seed_same_batches(cell, cpu):
    a, b = _traffic(cell, 2 ** 31 + 11, cpu), _traffic(cell, 2 ** 31 + 11, cpu)
    for x, y in zip(a.batches, b.batches):
        assert torch.equal(x.x, y.x)
        assert json.dumps({k: np.asarray(v).tolist()
                           for k, v in x.truth.items()}) == json.dumps(
            {k: np.asarray(v).tolist() for k, v in y.truth.items()})
    assert all(np.array_equal(p, q) for p, q in zip(a.psdus, b.psdus))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_other_seed_same_work(cell, cpu):
    a, b = _traffic(cell, 5, cpu), _traffic(cell, 6, cpu)
    assert not torch.equal(a.batches[0].x, b.batches[0].x)
    assert a.formats == b.formats
    assert [x.x.shape for x in a.batches] == [x.x.shape for x in b.batches]
    if cell_parts(cell)[1]["layout"] == "streams":
        assert [x.steps for x in a.batches] == [x.steps for x in b.batches]
        assert [x.samples for x in a.batches] == \
            [x.samples for x in b.batches]


@pytest.mark.parametrize("seed", [-3, 0, 2 ** 31 + 5, 2 ** 70 + 1])
def test_any_whole_number_seeds(seed, cpu):
    t = _traffic("a54-sat-8k", seed, cpu)
    assert torch.isfinite(t.batches[0].x.real).all()


def test_frames_fit_their_streams(cpu):
    t = _traffic("a54-sat-8k", 1, cpu)
    b = t.batches[0]
    x = b.x[:, 0].abs()
    for r, s in enumerate(b.truth["starts"]):
        # the frame's first STS samples stand well above the noise
        assert float(x[r, s: s + 16].mean()) > 10 * float(x[r, : 20].mean())
