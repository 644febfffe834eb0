"""The port's TV-whitespace app (``sora_tpu_torch.apps.tvws``) against
``sora_tpu.apps.tvws`` on the CPU: ``synth_band`` within float32
tolerance, and ``decode_band``'s frames field for field on the same band
(tests/test_tvws.py:30-38); the CLI end to end with ``--device cpu``."""

import numpy as np
import pytest
import torch

from sora_tpu.apps import tvws as jtvws
from sora_tpu_torch.apps import tvws as ttvws
from sora_tpu_torch.ops import viterbi_cuda as vc

torch.set_num_threads(2)

OFFS = [-10e6, 10e6]
BAND_ATOL = 1e-5          # the port's halfband interpolation against JAX's
SNR_ATOL = 1e-3


@pytest.fixture(scope="module")
def band():
    return jtvws.synth_band(6, OFFS, 40e6)


def test_synth_band_matches_jax(band):
    x, n = ttvws.synth_band(6, OFFS, 40e6, device="cpu")
    want, n_want = band
    assert n == n_want == 6
    assert x.dtype == want.dtype == np.complex64 and x.shape == want.shape
    assert np.abs(x - want).max() < BAND_ATOL


def test_decode_band_matches_jax(band, monkeypatch):
    x, _ = band
    calls = []
    ref = vc.decode_blocks_reference
    monkeypatch.setattr(vc, "decode_blocks_reference",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    got = ttvws.decode_band(x, OFFS, 40e6, device="cpu")
    want = jtvws.decode_band(x, OFFS, 40e6)
    assert len(calls) == 1            # one Viterbi call for every channel
    assert len(got) == len(want) == 6
    chans = [f["channel_hz"] for f in got]
    for ch in OFFS:
        assert chans.count(ch) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("channel_hz", "rate_mbps", "length", "psdu"):
            assert g[k] == w[k], k
        assert abs(g["snr_db"] - w["snr_db"]) < SNR_ATOL


def test_cli_decodes_every_frame(capsys):
    assert ttvws.main(["--synthetic", "4", "--device", "cpu"]) == 0
    assert "decoded 4/4 frames across 2 channels" in capsys.readouterr().out
