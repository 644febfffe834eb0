"""The port's Viterbi decoders (sora_tpu_torch) against the JAX package's.

The radix-4 plain version (``ops.viterbi_cuda.decode_blocks_reference``,
which the CUDA kernel is held to on the card by chip_smoke.py) must equal
the Pallas kernel run in interpret mode bit for bit, in the three window
regimes ``decode_auto`` picks, ``terminated`` both ways, at noise up to
sigma 0.9.  A numpy model of the CUDA kernel's per-lane arithmetic (four
radix-2 sub-steps per radix-4 step, survivor marks, three traceback
walks) must equal both, on noisy and on tie-heavy input.  The float
butterfly decoders and the encoder must equal their JAX counterparts
exactly (same fp32 operations in the same order).
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


# =============================================================================
# The CUDA kernel's per-lane arithmetic, modelled in numpy
# =============================================================================
#
# csrc/viterbi.cu runs each radix-4 step as four radix-2 sub-steps on one
# warp per window: lane u holds the packed keys (metric << 22 | j << 18 |
# three 6-bit state marks) of states u and u + 32 in two registers (a, b),
# swapped on odd lanes; the predecessors 2u, 2u + 1 arrive by two shuffles;
# the branch metric of the butterfly is one value +-(sA +- sB) whose signs
# are fixed per lane; the end state's marks start three traceback walks.
# The model below follows the kernel register for register (lanes are the
# last axis) so that the kernel's logic is checked here, where there is no
# card.

G0, G1 = 0o133, 0o171
VAL_SHIFT, J_SHIFT = 22, 18
VAL_MASK, MARK_MASK = ~((1 << VAL_SHIFT) - 1), (1 << J_SHIFT) - 1
KEY_CLAMP = vc.PM_CLAMP << VAL_SHIFT


def _lane_constants():
    u = np.arange(32)
    h, odd = u >> 4, u & 1
    sigma = (2 * h - 1) * (1 - 2 * odd)
    e_a = 2 * vc._parity(2 * u, G0) - 1
    e_b = 2 * vc._parity(2 * u, G1) - 1
    variant = 2 * (sigma * e_a < 0) + (sigma * e_b < 0)
    src1 = (2 * u + h) & 31
    src2 = (2 * u + 1 - h) & 31
    state_a = np.where(odd == 1, u + 32, u)
    state_b = np.where(odd == 1, u, u + 32)
    return h, variant, src1, src2, state_a, state_b


def _lane_model(soft, block, overlap, terminated):
    """(B, T, 2) float32 soft pairs -> (B, T) uint8 bits, computed as the
    kernel computes them."""
    B, T, _ = soft.shape
    q = np.clip(np.rint(soft.astype(np.float32) * 8.0), -7, 7).astype(
        np.int32)
    nblk = -(-T // block)
    win = block + 2 * overlap
    nstep = win // 4
    q = np.concatenate([np.zeros((B, overlap, 2), np.int32), q,
                        np.zeros((B, nblk * block - T + overlap, 2),
                                 np.int32)], axis=1)
    wins = np.stack([q[:, k * block: k * block + win] for k in range(nblk)],
                    axis=1).reshape(B * nblk, win, 2)
    qa, qb = wins[..., 0], wins[..., 1]
    # the four signed branch metrics of a step: the kernel's table
    metric = np.stack([qa + qb, qa - qb, qb - qa, -qa - qb], axis=-1)
    h, variant, src1, src2, state_a, state_b = _lane_constants()
    lane_metric = metric[:, :, variant].astype(np.int64) << VAL_SHIFT
    R = B * nblk
    rows = np.arange(R)
    first = (rows % nblk == 0)[:, None]
    ra = np.where(first & (state_a != 0), KEY_CLAMP, 0).astype(np.int64)
    rb = np.where(first & (state_b != 0), KEY_CLAMP, 0).astype(np.int64)
    # the kept block is radix-4 steps m_lo..m_hi; marks split it in thirds
    m_lo, m_hi = overlap // 4, (overlap + block) // 4 - 1
    third = (m_hi - m_lo + 3) // 3
    marks = (m_hi - 2 * third, m_hi - third, m_hi)
    dec = np.zeros((nstep, R, 32), np.int64)
    for m in range(nstep):
        for k in range(4):
            d = lane_metric[:, 4 * m + k]
            bit = 1 << (J_SHIFT + k)
            qk, rk = h * bit, bit - h * bit
            r1, r2 = ra[:, src1], rb[:, src2]
            ra = np.minimum(r1 + d + qk, r2 - d + rk)
            rb = np.minimum(r1 - d + qk, r2 + d + rk)
        lo = (np.where(state_a < 32, ra, rb) >> J_SHIFT) & 15
        hi = (np.where(state_a < 32, rb, ra) >> J_SHIFT) & 15
        dec[m] = lo | (hi << 4)
        fa, fb = ra & VAL_MASK, rb & VAL_MASK
        mn = np.minimum(fa, fb).min(axis=1, keepdims=True)
        ra = np.minimum(fa - mn, KEY_CLAMP) | (ra & MARK_MASK)
        rb = np.minimum(fb - mn, KEY_CLAMP) | (rb & MARK_MASK)
        for f, mk in enumerate(marks):
            if m == mk:
                ra = (ra & ~(63 << 6 * f)) | (state_a << 6 * f)
                rb = (rb & ~(63 << 6 * f)) | (state_b << 6 * f)
    end = np.minimum(((ra >> 16) & ~63) | state_a,
                     ((rb >> 16) & ~63) | state_b).min(axis=1) & 63
    if terminated:
        end[rows % nblk == nblk - 1] = 0
    owner = end & 31
    end_key = np.where(state_a[owner] == end, ra[rows, owner],
                       rb[rows, owner])
    bits = np.zeros((R, win), np.uint8)
    for f in range(3):                    # the walk of lane f
        state = (end_key >> 6 * f) & 63
        bottom = marks[f - 1] + 1 if f else m_lo
        for m in range(marks[f], bottom - 1, -1):
            for i in range(4):
                bits[:, 4 * m + i] = (state >> (2 + i)) & 1
            d2 = dec[m, rows, state & 31]
            d = (d2 >> np.where(state & 32, 4, 0)) & 15
            state = 16 * (state & 3) + d
    bits = bits[:, overlap: overlap + block].reshape(B, nblk * block)
    return bits[:, :T]


TIE_KINDS = ("zeros", "erased7", "saturated", "sigma2")


@lru_cache(maxsize=None)
def _tie_oracle(regime: str, terminated: bool):
    """Tie-heavy soft inputs (one row per kind in TIE_KINDS) and the
    Pallas interpret-mode output for them."""
    T, block, overlap = REGIMES[regime]
    rng = np.random.default_rng(7 * T + terminated)
    bits = rng.integers(0, 2, (3, T), dtype=np.uint8)
    bits[:, -6:] = 0
    coded = 2.0 * np.asarray(jv.encode(bits)).reshape(3, T, 2) - 1.0
    noise = rng.normal(size=coded.shape)
    erased = coded[0] + 0.9 * noise[0]
    erased[::7] = 0.0                          # every 7th step erased
    saturated = 4.0 * coded[1] + 3.0 * noise[1]   # mostly beyond +-7/8
    soft = np.stack([np.zeros((T, 2)), erased, saturated,
                     coded[2] + 2.0 * noise[2]]).astype(np.float32)
    want = np.asarray(vp.decode_blocks(soft, block=block, overlap=overlap,
                                       bt=8, terminated=terminated,
                                       interpret=True))
    return soft, want


@pytest.mark.parametrize("kind", TIE_KINDS)
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_lane_model_matches_pallas_on_ties(regime, terminated, kind):
    """The kernel's four-sub-step arithmetic equals the interpret-mode
    Pallas kernel and the plain version bit for bit on tie-heavy input."""
    soft, want = _tie_oracle(regime, terminated)
    _, block, overlap = REGIMES[regime]
    row = soft[TIE_KINDS.index(kind)][None]
    got = _lane_model(row, block, overlap, terminated)
    np.testing.assert_array_equal(got[0], want[TIE_KINDS.index(kind)])
    ref = vc.decode_blocks_reference(torch.from_numpy(row), block, overlap,
                                     terminated)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_lane_model_matches_pallas_on_noisy_codewords(regime, terminated):
    _, soft, want = _oracle(regime, terminated)
    _, block, overlap = REGIMES[regime]
    np.testing.assert_array_equal(
        _lane_model(soft, block, overlap, terminated), want)


def test_lane_model_signal_shape(rng):
    """The 24-step SIGNAL window (block 24, overlap 0) at batch 33."""
    soft = rng.normal(size=(33, 24, 2)).astype(np.float32)
    soft[:, ::5] = 0.0
    want = vc.decode_blocks_reference(torch.from_numpy(soft), 24, 0, True)
    np.testing.assert_array_equal(_lane_model(soft, 24, 0, True),
                                  want.numpy())


def test_lane_constants_pair_each_butterfly():
    """Each lane's two shuffles fetch states 2u and 2u + 1 (in either
    order), and flipping the input bit or the dropped bit negates both
    code signs of the butterfly: one branch metric per lane suffices."""
    h, _, src1, src2, state_a, state_b = _lane_constants()
    u = np.arange(32)
    got = np.sort(np.stack([state_a[src1], state_b[src2]]), axis=0)
    np.testing.assert_array_equal(got, np.stack([2 * u, 2 * u + 1]))
    np.testing.assert_array_equal(state_a[src1] & 1, h)   # x of shuffle 1
    for g in (G0, G1):
        base = vc._parity(2 * u, g)
        for b, x in ((0, 1), (1, 0), (1, 1)):
            reg = (b << 6) | (2 * u + x)
            np.testing.assert_array_equal(vc._parity(reg, g), base ^ b ^ x)


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
