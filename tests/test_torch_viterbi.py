"""The port's Viterbi decoders (sora_tpu_torch) against the JAX package's.

The radix-4 plain version (``ops.viterbi_cuda.decode_blocks_reference``,
which the CUDA kernel is held to on the card by chip_smoke.py) must equal
the Pallas kernel run in interpret mode bit for bit, in the three window
regimes ``decode_auto`` picks, ``terminated`` both ways, at noise up to
sigma 0.9.  The float butterfly decoders and the encoder must equal their
JAX counterparts exactly (same fp32 operations in the same order).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from sora_tpu.dsp import viterbi as jv
from sora_tpu.ops import viterbi_pallas as vp
from sora_tpu_torch.dsp import viterbi as tv
from sora_tpu_torch.ops import viterbi_cuda as vc

torch.set_num_threads(2)

# (T, block, overlap) of the three decode_auto regimes: one window with no
# overlap (T <= 1024), block 512 / overlap 64 (1024 < T < 4096) and
# block 1024 / overlap 64 (T >= 4096)
REGIMES = {"one_window": (200, 200, 0), "block512": (1500, 512, 64),
           "block1024": (4200, 1024, 64)}
SIGMAS = (0.25, 0.9)


def _noisy_codewords(T: int, seed: int):
    """One terminated random codeword per sigma, as soft pairs + noise."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (len(SIGMAS), T), dtype=np.uint8)
    bits[:, -6:] = 0
    coded = np.asarray(jv.encode(bits)).reshape(len(SIGMAS), T, 2)
    noise = rng.normal(size=coded.shape) * np.array(SIGMAS)[:, None, None]
    return bits, (2.0 * coded - 1.0 + noise).astype(np.float32)


@lru_cache(maxsize=None)
def _oracle(regime: str, terminated: bool):
    """(bits, soft, Pallas interpret-mode output) — one interpret call
    decodes every sigma row of a (regime, terminated) case."""
    T, block, overlap = REGIMES[regime]
    bits, soft = _noisy_codewords(T, seed=T + terminated)
    want = np.asarray(vp.decode_blocks(soft, block=block, overlap=overlap,
                                       bt=8, terminated=terminated,
                                       interpret=True))
    return bits, soft, want


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_reference_matches_pallas_interpret(regime, terminated, sigma):
    bits, soft, want = _oracle(regime, terminated)
    _, block, overlap = REGIMES[regime]
    i = SIGMAS.index(sigma)
    got = vc.decode_blocks_reference(torch.from_numpy(soft[i]), block,
                                     overlap, terminated)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want[i])
    if sigma < 0.5:                       # clean enough to be error-free
        np.testing.assert_array_equal(got.numpy(), bits[i])


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_decode_auto_cpu_matches_tpu_branch(regime, terminated):
    """decode_auto on a CPU tensor makes the TPU branch's window choices
    (the oracle was run with exactly those) through the plain version."""
    _, soft, want = _oracle(regime, terminated)
    before = vc.LAUNCHES
    got = tv.decode_auto(torch.from_numpy(soft), terminated=terminated)
    np.testing.assert_array_equal(got.numpy(), want)
    assert vc.LAUNCHES == before          # the CPU path launches nothing


def test_wrapper_takes_reference_on_cpu_and_keeps_lead_axes():
    _, soft, _ = _oracle("block512", True)
    s = torch.from_numpy(np.stack([soft, soft]))          # (2, 2, T, 2)
    got = vc.decode_blocks(s, 512, 64, True)
    want = vc.decode_blocks_reference(s.reshape(4, -1, 2), 512, 64, True)
    assert got.shape == s.shape[:-1]
    np.testing.assert_array_equal(got.reshape(4, -1).numpy(), want.numpy())


def test_acs_matrix_equals_jax():
    np.testing.assert_array_equal(vc._acs_matrix(),
                                  np.asarray(vp._acs_matrix()))


def test_quantization_rounds_half_to_even():
    s = torch.tensor([0.0625, 0.1875, -0.0625, 0.3125, 2.0, -2.0])
    np.testing.assert_array_equal(vc._quantize(s).numpy(),
                                  [0, 2, 0, 2, 7, -7])


@pytest.mark.parametrize("block, overlap", [(12, 0), (0, 0), (64, 4)])
def test_decode_blocks_rejects_bad_geometry(block, overlap):
    with pytest.raises(ValueError):
        vc.decode_blocks(torch.zeros(1, 64, 2), block, overlap)


def test_decode_blocks_rejects_other_devices():
    with pytest.raises(ValueError):
        vc.decode_blocks(torch.zeros(1, 64, 2, device="meta"), 64, 0)


def test_encode_matches_jax(rng):
    bits = rng.integers(0, 2, (3, 77), dtype=np.uint8)
    np.testing.assert_array_equal(tv.encode(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jv.encode(bits)))


@pytest.mark.parametrize("terminated", [True, False])
def test_float_decode_matches_jax(rng, terminated):
    soft = rng.normal(size=(2, 300, 2)).astype(np.float32)
    got = tv.decode(torch.from_numpy(soft), terminated=terminated)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jv.decode(soft, terminated=terminated)))


@pytest.mark.parametrize("block, overlap, terminated",
                         [(512, 96, True), (256, 32, False)])
def test_float_decode_blocks_matches_jax(rng, block, overlap, terminated):
    bits = rng.integers(0, 2, (2, 1300), dtype=np.uint8)
    bits[:, -6:] = 0
    coded = np.asarray(jv.encode(bits)).reshape(2, 1300, 2)
    soft = (2.0 * coded - 1.0
            + rng.normal(size=coded.shape) * 0.8).astype(np.float32)
    got = tv.decode_blocks(torch.from_numpy(soft), block=block,
                           overlap=overlap, terminated=terminated)
    want = jv.decode_blocks(soft, block=block, overlap=overlap,
                            terminated=terminated)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
