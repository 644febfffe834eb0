"""Shared fixtures of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests -q``).  They run at tiny sizes
on the CPU; a test marked ``card`` needs an NVIDIA card and skips
without one."""

import json

import pytest

from benchmark import run

# each cell's mix cut to a few streams for a CPU run
TINY = {
    "a54-sat-8k": {"streams": 4, "pool": 2, "frames": 4, "judged": 2},
    "n15-sat": {"streams": 4, "pool": 2, "frames": 4, "judged": 2},
    "a-node-air-2k": {"streams": 8, "pool": 2, "frames": 4, "judged": 2,
                      "entry": {"call": "sora_tpu_torch.phy.dot11a.rx:"
                                        "rx_pipeline_auto",
                                "kwargs": {"max_psdu": 256, "n_frames": 11,
                                           "n_decode": 32,
                                           "min_rate_mbps": 24}}},
}


# the one-chip cells of BENCHMARK.json (the four-card cell's path has a
# test of its own), and the 11n cell kept as files only: it is out
# of BENCHMARK.json while the program decodes a few of its frames wrongly
# (PERF.md, Open questions), so only its generator, reference and controls
# are tested here
ONE_CHIP = ["a54-sat-8k", "a-node-air-2k"]
FILES_ONLY = {"n15-sat": ("dot11n-ht20-2x2", "sat-n15-1500-unitary")}


def cell_parts(name: str):
    """(config, mix, limits) of a cell, from BENCHMARK.json or its files."""
    if name not in FILES_ONLY:
        c = run.load_cell(name)
        return c.config, c.mix, c.limits
    conf, mix = FILES_ONLY[name]
    read = lambda *p: json.loads(run.HERE.joinpath(*p).read_text())
    return (read("configs", f"{conf}.json"), read("traffic", f"{mix}.json"),
            read("limits", f"{name}.json"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; CUDA is not available")
    return torch.device("cuda")


@pytest.fixture
def cpu():
    import torch

    torch.set_num_threads(2)
    return torch.device("cpu")
