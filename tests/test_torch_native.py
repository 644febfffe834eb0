"""The port's native host runtime (sora_tpu_torch.runtime.native, its own
copy of the C++ ring built into sora_tpu_torch/_build/) against the JAX
package's (sora_tpu.runtime.native), loaded side by side in this process.

The same writes go into both rings; reads, windowed int16/int8 reads (at
several gains, saturating), availability and overrun drops must be equal
exactly, and both dump parsers must read tests/data/fsample54.dmp
exactly as io.dumpfile.load_dump does.

One recorded difference: under a replay producer that laps the reader,
the port's windowed read never returns a window that the producer
overwrote while it was copied (it drops that span, and the next read
takes the newest one); the JAX package's ring can splice two stretches of
the stream into one window there.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from sora_tpu.runtime import native as jn
from sora_tpu_torch.io.dumpfile import load_dump
from sora_tpu_torch.runtime import native as tn

DUMP = str(Path(__file__).resolve().parent / "data" / "fsample54.dmp")


def _pair(capacity):
    rings = (jn.RxRing(capacity=capacity), tn.RxRing(capacity=capacity))
    return rings, [r.alloc_vstream() for r in rings]


def _samples(rng, n, scale=1.0):
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * scale
            ).astype(np.complex64)


def test_two_libraries_load_side_by_side():
    jl, tl = jn.load(), tn.load()
    assert jl is not tl
    assert Path(tl._name) == tn.LIBRARY != Path(jl._name)
    assert tn.LIBRARY.name == "libsora_host_torch.so"


def test_ring_read_and_available_equal(rng):
    (a, b), (va, vb) = _pair(1 << 12)
    x = _samples(rng, 3000)
    for r in (a, b):
        r.write(x[:1000])
        r.write(x[1000:])
    assert a.available(va) == b.available(vb) == 3000
    for n in (1, 999, 4096):
        np.testing.assert_array_equal(a.read(va, n), b.read(vb, n))
        assert a.available(va) == b.available(vb)
    for r in (a, b):
        r.close()


def test_ring_overrun_drops_equal(rng):
    (a, b), (va, vb) = _pair(256)
    x = (np.arange(1000) + 0j).astype(np.complex64)
    for r in (a, b):
        r.write(x)
    assert a.available(va) == b.available(vb) == 256
    np.testing.assert_array_equal(a.read(va, 4096), b.read(vb, 4096))
    assert a.drops(va) == b.drops(vb) == 1000 - 256
    for r in (a, b):
        r.close()


@pytest.mark.parametrize("dtype,scale", [
    (np.int16, 2048.0), (np.int16, 2048.0 * 40.0), (np.int16, 0.7),
    (np.int8, 32.0), (np.int8, 32.0 * 9.0), (np.int8, 0.5)])
def test_read_windows_equal(rng, dtype, scale):
    (a, b), (va, vb) = _pair(1 << 16)
    x = _samples(rng, 14000, scale=2.0)
    x[:4] = [1e6, -1e6 + 1e6j, 0.0, 1.5 / 2048]
    for r in (a, b):
        r.write(x)
    window, hop, batch = 2048, 1536, 4
    assert a.read_windows(va, window, hop, 16, scale, dtype) is None
    assert b.read_windows(vb, window, hop, 16, scale, dtype) is None
    for k in range(2):                  # the overlap stays in the ring
        (ha, sa), (hb, sb) = (a.read_windows(va, window, hop, batch, scale,
                                             dtype),
                              b.read_windows(vb, window, hop, batch, scale,
                                             dtype))
        assert sa == sb == k * hop * batch and ha.dtype == hb.dtype == dtype
        np.testing.assert_array_equal(ha, hb)
        assert a.available(va) == b.available(vb)
    # the last batch's first window: float32 gain, saturation, truncation
    lim = float(np.iinfo(dtype).max)
    w = x[hop * batch: hop * batch + window]
    want = np.stack([np.clip(w.real * np.float32(scale), -lim, lim),
                     np.clip(w.imag * np.float32(scale), -lim, lim)],
                    axis=-1).astype(dtype)
    np.testing.assert_array_equal(hb[0], want)
    for r in (a, b):
        r.close()


def test_read_windows_span_over_capacity_raises():
    ring = tn.RxRing(capacity=1 << 12)
    vs = ring.alloc_vstream()
    with pytest.raises(ValueError, match="capacity"):
        ring.read_windows(vs, 1 << 12, 1 << 11, 8, 1.0)
    ring.close()


def test_parse_dump_equals_jax_and_python():
    got = tn.parse_dump(DUMP)
    np.testing.assert_array_equal(got, jn.parse_dump(DUMP))
    np.testing.assert_array_equal(got, load_dump(DUMP))
    raw = tn.parse_dump(DUMP, sign_extend_14bit=False)
    np.testing.assert_array_equal(raw, jn.parse_dump(
        DUMP, sign_extend_14bit=False))


def test_replay_paced_and_monotonic_ns():
    ring = tn.RxRing(capacity=1 << 16)
    vs = ring.alloc_vstream()
    x = (np.ones(50000) + 0j).astype(np.complex64)
    t0 = time.monotonic()
    ring.start_replay(x, rate_sps=1e6)        # 50 ms of samples
    got = 0
    while got < 50000 and time.monotonic() - t0 < 5.0:
        got += len(ring.read(vs, 8192))
        time.sleep(0.002)
    dt = time.monotonic() - t0
    ring.stop()
    ring.close()
    assert got == 50000
    assert dt >= 0.04                          # pacing actually paced
    a, b = tn.monotonic_ns(), tn.monotonic_ns()
    assert b >= a > 0


@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_read_windows_never_torn_by_an_overrunning_replay(dtype):
    """A ramp replayed, looped, at 50 Msps into a ring of 2^16 that the
    reader lets overrun: every window returned is one contiguous stretch
    of the ramp, starting at the position the read reports, and the
    samples skipped count as drops."""
    period = 120 if dtype == np.int8 else 32000
    ramp = (np.arange(period) % period).astype(np.complex64)
    ring = tn.RxRing(capacity=1 << 16)
    vs = ring.alloc_vstream()
    window, hop, batch = 8192, 8192, 6
    ring.start_replay(ramp, rate_sps=5e7, loop=True)
    good = torn = 0
    t_end = time.monotonic() + 0.5
    try:
        while time.monotonic() < t_end:
            got = ring.read_windows(vs, window, hop, batch, 1.0, dtype)
            if got is None:
                continue
            h, start = got
            v = h[..., 0].astype(np.int64)
            first = (start + hop * np.arange(batch)) % period
            if ((np.diff(v, axis=1) % period == 1).all()
                    and (v[:, 0] == first).all()):
                good += 1
            else:
                torn += 1
            time.sleep(0.002)        # the reader falls behind: overrun
    finally:
        ring.stop()
    drops = ring.drops(vs)
    ring.close()
    assert torn == 0 and good > 0
    assert drops > 0


@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_read_windows_after_a_finished_replay_keeps_every_sample(dtype):
    """A replay that is not looped fills the ring to its last sample and
    ends; a read of the whole ring then returns every sample, in order, and
    drops none (no producer writes any more, so none can be in flight)."""
    cap = 1 << 14
    period = 120 if dtype == np.int8 else 32000
    ramp = (np.arange(cap) % period).astype(np.complex64)
    ring = tn.RxRing(capacity=cap)
    vs = ring.alloc_vstream()
    ring.start_replay(ramp, rate_sps=0.0, loop=False)
    t_end = time.monotonic() + 10.0
    while ring.available(vs) < cap and time.monotonic() < t_end:
        time.sleep(0.001)
    time.sleep(0.05)                  # the producer returns after its write
    try:
        got = ring.read_windows(vs, cap // 2, cap // 2, 2, 1.0, dtype)
    finally:
        ring.stop()
    drops = ring.drops(vs)
    ring.close()
    assert got is not None and drops == 0
    h, start = got
    assert start == 0
    assert np.array_equal(h[..., 0].reshape(-1), ramp.real.astype(dtype))
