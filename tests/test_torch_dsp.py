"""The port's DSP primitives and constant tables against the JAX package's.

Inputs are made with numpy from a seed and fed to both.  Integer and bit
results (CRC, scrambler, tables, mapping levels) must be equal.  Float
results may differ by the order in which fp32 sums are taken (XLA's CPU
matmuls and reductions against PyTorch's), so each has a tolerance
stated beside it, relative to the input's scale.
"""

import zlib

import numpy as np
import pytest
import torch

from sora_tpu.dsp import crc as jcrc
from sora_tpu.dsp import fft as jfft
from sora_tpu.dsp import filters as jfilt
from sora_tpu.dsp import mapping as jmap
from sora_tpu.dsp import scramble as jscr
from sora_tpu.io import dumpfile as jdump
from sora_tpu.mac import frame as jframe
from sora_tpu.phy import common as JC
from sora_tpu_torch.dsp import crc as tcrc
from sora_tpu_torch.dsp import fft as tfft
from sora_tpu_torch.dsp import filters as tfilt
from sora_tpu_torch.dsp import mapping as tmap
from sora_tpu_torch.dsp import scramble as tscr
from sora_tpu_torch.io import dumpfile as tdump
from sora_tpu_torch.mac import frame as tframe
from sora_tpu_torch.phy import common as TC

torch.set_num_threads(2)

CAPTURE = "tests/data/fsample54.dmp"


def _cplx(rng, *shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * scale).astype(np.complex64)


# ---- constant tables (the port's "weights") ---------------------------------

_COMMON_TABLES = ["NFFT", "SC_IDX", "PILOT_SC", "DATA_SC", "PILOT_VAL",
                  "DATA_BINS", "PILOT_BINS", "OCC_BINS", "LTS_FREQ",
                  "STS_FREQ", "STS_TIME_PERIOD", "STS_TIME", "LTS_TIME_SYM",
                  "LTS_TIME", "PREAMBLE_TIME", "PILOT_POLARITY", "G0", "G1",
                  "CONV_OUT_A", "CONV_OUT_B", "CONV_NEXT", "BFLY_PRED",
                  "BFLY_OUT_A", "BFLY_OUT_B", "_BPSK_LVL", "_QPSK_LVL",
                  "_QAM16_LVL", "_QAM64_LVL"]


@pytest.mark.parametrize("name", _COMMON_TABLES)
def test_common_table_equal(name):
    np.testing.assert_array_equal(getattr(TC, name), getattr(JC, name))


def test_common_rates_puncture_kmod_equal():
    assert sorted(TC.RATES) == sorted(JC.RATES)
    for m, r in JC.RATES.items():
        t = TC.RATES[m]
        assert [getattr(t, a) for a in r.__slots__] == \
            [getattr(r, a) for a in r.__slots__]
    assert sorted(TC.RATE_BY_BITS) == sorted(JC.RATE_BY_BITS)
    assert TC.PUNCTURE.keys() == JC.PUNCTURE.keys()
    for k, (pa, pb) in JC.PUNCTURE.items():
        np.testing.assert_array_equal(TC.PUNCTURE[k][0], pa)
        np.testing.assert_array_equal(TC.PUNCTURE[k][1], pb)
    assert TC.KMOD == JC.KMOD


@pytest.mark.parametrize("mbps", sorted(JC.RATES))
def test_interleaver_permutation_equal(mbps):
    r = JC.RATES[mbps]
    np.testing.assert_array_equal(
        TC.interleaver_permutation(r.ncbps, r.nbpsc),
        JC.interleaver_permutation(r.ncbps, r.nbpsc))


def test_scrambler_tables_equal():
    for seed in (1, 0x5D, 0x7F):
        np.testing.assert_array_equal(TC.scrambler_sequence(300, seed),
                                      JC.scrambler_sequence(300, seed))
    np.testing.assert_array_equal(tscr._PERIOD, jscr._PERIOD)
    np.testing.assert_array_equal(tscr._PHASE, jscr._PHASE)
    np.testing.assert_array_equal(tscr._PHASES_TABLE, jscr._PHASES_TABLE)


@pytest.mark.parametrize("inverse", [False, True])
def test_dft_mats_equal(inverse):
    for a, b in zip(tfft._dft_mats(64, inverse), jfft._dft_mats(64, inverse)):
        np.testing.assert_array_equal(a, b)


def test_crc32_mats_equal():
    for a, b in zip(tcrc._crc32_mats(2500), jcrc._crc32_mats(2500)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tframe.crc32_table(), jframe.crc32_table())


# ---- crc, scrambler, frame, dump file: exact --------------------------------


def test_crc32_batch_matches_jax_and_zlib(rng):
    B, N = 9, 300
    data = rng.integers(0, 256, (B, N), dtype=np.uint8)
    lengths = np.concatenate([[0, N, 1, N - 1],
                              rng.integers(0, N + 1, B - 4)]).astype(np.int32)
    got = tcrc.crc32_batch(torch.from_numpy(data),
                           torch.from_numpy(lengths)).numpy()
    want = np.asarray(jcrc.crc32_batch(data, lengths)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    for row, n, c in zip(data, lengths, got):
        assert c == tframe.fcs32(row[:n].tobytes())


def test_crc32_bytes_matches_jax(rng):
    data = rng.integers(0, 256, 40, dtype=np.uint8)
    got = int(tcrc.crc32_bytes(torch.from_numpy(data)))
    assert got == int(jcrc.crc32_bytes(data)) == tframe.fcs32(data.tobytes())


@pytest.mark.parametrize("nbits", [32, 1, 7, 48, 257])
def test_crc16_bits_matches_jax(nbits, rng):
    """The 11b PLCP CRC-16 equals the JAX package's ``crc16_bits`` and both
    packages' ``crc16_plcp`` on random 32-bit headers and on shorter and
    longer bit vectors, four draws each."""
    from sora_tpu.phy import dot11b_common as JB
    from sora_tpu_torch.phy import dot11b_common as TB

    for _ in range(4):
        bits = rng.integers(0, 2, nbits, dtype=np.uint8)
        got = tcrc.crc16_bits(bits)
        assert got == jcrc.crc16_bits(bits) == JB.crc16_plcp(bits)
        assert got == TB.crc16_plcp(bits)


@pytest.mark.parametrize("seed", [1, 0x2A, 0x7F])
def test_scramble_sequence_matches_jax(seed):
    np.testing.assert_array_equal(tscr.sequence(400, seed).numpy(),
                                  np.asarray(jscr.sequence(400, seed)))


def test_seed_from_prefix_matches_jax():
    for seed in (1, 0x33, 0x7F):
        prefix = TC.scrambler_sequence(7, seed)
        got = int(tscr.seed_from_prefix(torch.from_numpy(prefix)))
        assert got == int(jscr.seed_from_prefix(prefix)) == seed


def test_mac_frame_matches_jax():
    psdu = tframe.build_data_frame(b"payload bytes", seq=3)
    assert psdu == jframe.build_data_frame(b"payload bytes", seq=3)
    assert tframe.check_fcs(psdu) and not tframe.check_fcs(psdu[:-1] + b"x")
    assert tframe.fcs32(psdu) == jframe.fcs32(psdu)


@pytest.mark.parametrize("n", [0, 1, 31, 300])
def test_fcs32_np_matches_jax_and_zlib(rng, n):
    data = rng.integers(0, 256, n, dtype=np.uint8)
    got = tframe.fcs32_np(data)
    assert got == jframe.fcs32_np(data) == zlib.crc32(data.tobytes())


def test_ack_frame_and_header_match_jax():
    addr = bytes(range(2, 8))
    ack = tframe.build_ack_frame(addr)
    assert ack == jframe.build_ack_frame(addr) and tframe.check_fcs(ack)
    hdr = tframe.MacHeader(frame_control=0x0088, duration=44, addr1=addr,
                           seq_ctrl=0x1234)
    packed = hdr.pack()
    assert packed == jframe.MacHeader(0x0088, 44, addr,
                                      seq_ctrl=0x1234).pack()
    assert tframe.MacHeader.unpack(packed) == hdr


def test_dumpfile_matches_jax():
    np.testing.assert_array_equal(tdump.raw_blocks(CAPTURE),
                                  jdump.raw_blocks(CAPTURE))
    for ext in (True, False):
        np.testing.assert_array_equal(tdump.load_dump(CAPTURE, ext),
                                      jdump.load_dump(CAPTURE, ext))


# ---- mapping ----------------------------------------------------------------


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16", "qam64"])
def test_map_bits_matches_jax(rng, mod):
    bits = rng.integers(0, 2, (3, 48 * tmap.NBPSC[mod]), dtype=np.uint8)
    np.testing.assert_array_equal(
        tmap.map_bits(torch.from_numpy(bits), mod).numpy(),
        np.asarray(jmap.map_bits(bits, mod)))


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16", "qam64"])
def test_demap_soft_matches_jax(rng, mod):
    sym = _cplx(rng, 4, 10, 48)
    got = tmap.demap_soft(torch.from_numpy(sym), mod).numpy()
    want = np.asarray(jmap.demap_soft(sym, mod))
    # the same elementwise fp32 ops: agreement to rounding, 1e-5 of the
    # input scale (unit-variance symbols, soft values scaled by <= 6.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- fft --------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["fft64", "ifft64"])
def test_fft64_matches_jax(rng, fn):
    x = _cplx(rng, 5, 7, 64, scale=3.0)
    got = getattr(tfft, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jfft, fn)(x))
    # fp32 matmuls summed in another order: rtol 1e-5 and 1e-4 of max|x|
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-4 * np.abs(x).max())


def test_dft_matches_numpy(rng):
    x = _cplx(rng, 3, 128)
    got = tfft.dft(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-5,
                               atol=1e-4 * np.abs(x).max() * 128 ** 0.5)
    with pytest.raises(ValueError):
        tfft.fft64(torch.zeros(2, 32, dtype=torch.complex64))


# ---- filters ----------------------------------------------------------------


@pytest.mark.parametrize("width", [64, 100])
def test_moving_sum_matches_jax(rng, width):
    x = _cplx(rng, 3, 700, scale=50.0)
    got = tfilt.moving_sum(torch.from_numpy(x), width).numpy()
    want = np.asarray(jfilt.moving_sum(x, width))
    # doubling tree: the same adds in the same order; the cumsum form sums
    # in another order, so 1e-5 of the input scale times the window
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * 50.0 * width)


def test_correlate_stream_matches_jax(rng):
    x = _cplx(rng, 3, 600, scale=20.0)
    p = np.asarray(TC.LTS_TIME_SYM, dtype=np.complex64)
    got = tfilt.correlate_stream(torch.from_numpy(x), p).numpy()
    want = np.asarray(jfilt.correlate_stream(x, p))
    # 64 complex multiply-adds per output in the same order: 1e-5 of the
    # input scale times the pattern length
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 20.0 * 64)


def test_correlate_and_fir_match_jax(rng):
    x = _cplx(rng, 2, 300)
    p = _cplx(rng, 16)
    # fp32 matmuls in another order: 1e-5 relative to |x| * len(p)
    tol = 1e-5 * 16 * 4
    np.testing.assert_allclose(
        tfilt.correlate(torch.from_numpy(x), p).numpy(),
        np.asarray(jfilt.correlate(x, p)), rtol=0, atol=tol)
    taps = rng.normal(size=9).astype(np.float32)
    np.testing.assert_allclose(
        tfilt.fir(torch.from_numpy(x), taps).numpy(),
        np.asarray(jfilt.fir(x, taps)), rtol=0, atol=tol)
    np.testing.assert_allclose(
        tfilt.fir_centered(torch.from_numpy(x), taps).numpy(),
        np.asarray(jfilt.fir_centered(x, taps)), rtol=0, atol=tol)


def test_views_and_resample_match_jax(rng):
    x = _cplx(rng, 2, 101)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tfilt.decimate2(xt, 1).numpy(),
                                  np.asarray(jfilt.decimate2(x, 1)))
    np.testing.assert_array_equal(tfilt.window_view(xt, 8, 3).numpy(),
                                  np.asarray(jfilt.window_view(x, 8, 3)))
    np.testing.assert_array_equal(tfilt.frame_blocks(xt, 32, 5).numpy(),
                                  np.asarray(jfilt.frame_blocks(x, 32, 5)))
    taps = np.hanning(23).astype(np.float32) / 6.0
    got = tfilt.resample_poly(xt, 3, 2, taps).numpy()
    want = np.asarray(jfilt.resample_poly(x, 3, 2, taps))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 23)
