"""The port's device-resident air (sora_tpu_torch.runtime.device_air, CPU)
against the JAX package's, and its BatchMac.

torch cannot reproduce ``jax.random``, so parity is held on noise-free
air (``noise_rms=0``): the same waves and descriptors go into both, over
two rounds with a frame straddling the round boundary.  Flags, lengths,
rates, positions and the header bytes of decoded rows must be equal; the
air carry agrees within 1e-6 (one fp32 add per sample, or a few where
multipath descriptors overlap and the sum is taken in another order),
and the initial carry, drawn with numpy in both, bit for bit.  The noisy
air is checked on its own: continuity across rounds, quiet empty air,
on-device TX staging and multipath taps.  phy "n" (two antennas, the 2x2
mixed-MCS receiver per window) is held to the JAX air the same way, on
the scenario of tests/test_device_air.py, and so is phy "b" (11 Msps
chips, the mixed-rate DSSS receiver per window).  Sizes are small (4 or 8
windows of 4096 or 4608 samples), as in tests/test_device_air.py.
"""

import numpy as np
import pytest
import torch

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.mac import frame as jfr
from sora_tpu.runtime import device_air as jda
from sora_tpu_torch.runtime import device_air as tda
from sora_tpu_torch.util.xfer import fetch

torch.set_num_threads(2)

W, OV, B = 4096, 1536, 4          # hop 2560, advance 10240
KW = dict(window=W, batch=B, overlap=OV, n_frames=3, slots=8,
          max_psdu=256, min_rate_mbps=54)
EXACT = ["ok", "length", "rate_mbps", "lts1", "truncated"]
# det: ratio of fp32 moving sums; snr_db of noise-free frames is a log of
# a large ratio of small fp32 sums
CLOSE = {"det": 1e-4, "snr_db": 0.05}
CARRY_ATOL = 1e-6
TAPS = [(0, 1.0), (3, 0.45 * np.exp(0.9j)), (7, 0.2 * np.exp(-2.1j)),
        (11, 0.08 * np.exp(0.3j))]


def _port(waves, **kw):
    return tda.DeviceAir(waves, device="cpu", **{**KW, **kw})


def _jax(waves, **kw):
    return jda.DeviceAir(waves, **{**KW, **kw})


def _match(air, out, base, global_off, tol=600):
    """True iff some ok candidate sits at the scheduled position."""
    ok = np.asarray(out["ok"]).astype(bool)
    pos = air.cand_pos(out, base)
    return bool(np.any(ok & (np.abs(pos - (global_off + 192)) < tol)))


def _has_header(out, psdu, hdr_bytes=64):
    hdr = np.asarray(out["hdr"])
    ok = np.asarray(out["ok"]).astype(bool)
    want = np.frombuffer(psdu[:hdr_bytes], np.uint8)
    return any(np.array_equal(hdr[i][: len(want)], want)
               for i in range(len(ok)) if ok[i])


@pytest.fixture(scope="module")
def frames():
    psdus = [jfr.build_data_frame(bytes([i]) * 80, seq=i) for i in range(3)]
    return psdus, [golden.modulate(p, 54).astype(np.complex64)
                   for p in psdus]


def _assert_outs_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in EXACT:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ok = want["ok"].astype(bool)
    np.testing.assert_array_equal(got["hdr"][ok], want["hdr"][ok])
    for key, tol in CLOSE.items():
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)


def _two_rounds(waves, rounds, **kw):
    """Both airs over the same rounds: [(port outs, jax outs, port base,
    jax base, port carry, jax carry)] and the two airs."""
    ta, ja = _port(waves, **kw), _jax(waves, **kw)
    res = []
    for tx in rounds:
        to, tb = ta.step(tx)
        jo, jb = ja.step(tx)
        res.append((fetch(to), [{k: np.asarray(v) for k, v in o.items()}
                                for o in jo], tb, jb,
                    ta._carry.numpy(), np.asarray(ja._carry)))
    return res, ta


@pytest.fixture(scope="module")
def noise_free(frames):
    psdus, waves = frames
    span = len(waves[0])
    adv = W - OV
    adv *= B
    # round 0: two clean frames and one straddling the round boundary
    # (its tail spills into round 1 through the carry); round 1: one more
    rounds = [[(0, 400, 1.0), (1, 5000, 1.0), (2, adv - span + 300, 1.0)],
              [(0, 3000, 1.0)]]
    res, ta = _two_rounds(waves, rounds, noise_rms=0.0)
    return res, ta, rounds


def test_initial_carry_equal_bit_for_bit(frames):
    _, waves = frames
    ta = _port(waves, noise_rms=0.02, seed=5)
    ja = jda.DeviceAir(waves, **{**KW, "noise_rms": 0.02, "seed": 5})
    np.testing.assert_array_equal(ta._carry.numpy(), np.asarray(ja._carry))
    assert ta.carry_len == ja.carry_len and ta.L == ja.L
    assert (ta.nsamp, ta.advance, ta.hop) == (ja.nsamp, ja.advance, ja.hop)


@pytest.mark.parametrize("rnd", [0, 1])
def test_noise_free_round_matches_jax(noise_free, rnd):
    res, _, _ = noise_free
    got, want, tb, jb, tcarry, jcarry = res[rnd]
    assert tb == jb
    _assert_outs_equal(got[0], want[0])
    np.testing.assert_allclose(tcarry, jcarry, rtol=0, atol=CARRY_ATOL)


def test_noise_free_rounds_decode_every_frame(noise_free, frames):
    res, ta, rounds = noise_free
    psdus, waves = frames
    (o0, _, b0, _, _, _), (o1, _, b1, _, _, _) = res
    assert _match(ta, o0[0], b0, 400) and _match(ta, o0[0], b0, 5000)
    assert _match(ta, o1[0], b1, b1 + 3000)
    straddle = b0 + rounds[0][2][1]
    assert _match(ta, o0[0], b0, straddle) or _match(ta, o1[0], b1, straddle)
    assert _has_header(o0[0], psdus[0])


def test_multipath_descriptors_match_jax(frames):
    """Overlapping descriptors (one per tap) sum in another order than the
    JAX package's slot loop: the air agrees within tolerance and the
    decode is equal."""
    psdus, waves = frames
    tx = [(1, 600 + d, c) for d, c in TAPS]
    res, ta = _two_rounds(waves, [tx], noise_rms=0.0)
    got, want, tb, _, tcarry, jcarry = res[0]
    _assert_outs_equal(got[0], want[0])
    np.testing.assert_allclose(tcarry, jcarry, rtol=0, atol=CARRY_ATOL)
    assert _match(ta, got[0], tb, 600) and _has_header(got[0], psdus[1])


def test_stage_tx_and_set_entries_match_jax(frames):
    psdus, waves = frames
    ta = _port([np.zeros(2048, np.complex64)], n_entries=4, noise_rms=0.0)
    ja = _jax([np.zeros(2048, np.complex64)], n_entries=4, noise_rms=0.0)
    arr = np.stack([np.frombuffer(jfr.build_data_frame(b"A" * 64, seq=s),
                                  np.uint8) for s in (9, 10)])
    ta.stage_tx([2, 0], arr, 54)
    ja.stage_tx([2, 0], arr, 54)
    np.testing.assert_allclose(ta._cache.numpy(), np.asarray(ja._cache),
                               rtol=0, atol=1e-6)
    ta.set_entries([3], [waves[0][:1500]])
    ja.set_entries([3], [waves[0][:1500]])
    np.testing.assert_allclose(ta._cache.numpy(), np.asarray(ja._cache),
                               rtol=0, atol=1e-6)


# ---- the noisy air on its own ----------------------------------------------


def test_noisy_air_boundary_continuity(frames):
    psdus, waves = frames
    span = len(waves[0])
    air = _port(waves, noise_rms=0.01)
    adv = air.advance
    offs0 = [(0, 400), (1, 5000), (2, adv - span + 300)]
    outs0, base0 = air.step([(e, o, 1.0) for e, o in offs0])
    outs1, base1 = air.step([(0, 3000, 1.0)])
    o0, o1 = fetch(outs0[0]), fetch(outs1[0])
    assert _match(air, o0, base0, 400) and _match(air, o0, base0, 5000)
    assert _match(air, o1, base1, base1 + 3000)
    straddle = base0 + adv - span + 300
    assert _match(air, o0, base0, straddle) or \
        _match(air, o1, base1, straddle)
    assert _has_header(o0, psdus[0])


def test_empty_air_is_quiet(frames):
    _, waves = frames
    air = _port(waves[:1], noise_rms=0.01)
    outs, _ = air.step([])
    assert int(outs[0]["ok"].sum()) == 0


def test_stage_tx_decodes(frames):
    psdu = jfr.build_data_frame(b"A" * 64, seq=9)
    air = _port([np.zeros(2048, np.complex64)], n_entries=4, noise_rms=0.01)
    air.stage_tx([2], np.frombuffer(psdu, np.uint8)[None, :], 54)
    outs, base = air.step([(2, 1200, 1.0)])
    out = fetch(outs[0])
    assert _match(air, out, base, 1200) and _has_header(out, psdu)


def test_noisy_multipath_decodes():
    psdu = jfr.build_data_frame(b"M" * 100, seq=2)
    air = _port([golden.modulate(psdu, 24)], min_rate_mbps=24,
                noise_rms=0.01)
    outs, base = air.step([(0, 600 + d, c) for d, c in TAPS])
    out = fetch(outs[0])
    assert _match(air, out, base, 600) and _has_header(out, psdu)


def test_same_seed_same_rounds(frames):
    _, waves = frames
    tx = [(0, 700, 1.0)]
    a, b, c = (_port(waves, noise_rms=0.02, seed=s, n_receivers=2)
               for s in (3, 3, 4))
    for _ in range(2):
        oa, ob, oc = (fetch(air.step(tx)[0]) for air in (a, b, c))
    for r in range(2):
        np.testing.assert_array_equal(oa[r]["det"], ob[r]["det"])
    assert not np.array_equal(oa[0]["det"], oc[0]["det"])
    assert not np.array_equal(oa[0]["det"], oa[1]["det"])   # two receivers
    np.testing.assert_array_equal(a._carry.numpy(), b._carry.numpy())


def test_unported_phys_and_bad_arguments_raise(frames):
    _, waves = frames
    # phy "b" is ported: one chain, one candidate per window
    dsss = _port(waves, phy="b")
    assert dsss.n_ant == 1 and dsss.n_frames == 1
    # phy "n" carries two antennas: one-chain waves are refused, on-card
    # TX staging stays the OFDM path
    with pytest.raises(ValueError, match="chains"):
        _port(waves, phy="n")
    ht = _port([np.stack([waves[0], waves[0]])], phy="n")
    assert ht.n_ant == 2 and ht.n_frames == 1
    with pytest.raises(ValueError, match="phy 'a'"):
        ht.stage_tx([0], np.zeros((1, 40), np.uint8), 54)
    with pytest.raises(ValueError, match="unknown phy"):
        _port(waves, phy="g")
    air = _port(waves)
    with pytest.raises(ValueError, match="descriptor slots"):
        air.step([(0, 10, 1.0)] * 9)
    with pytest.raises(ValueError, match="offset"):
        air.step([(0, air.nsamp, 1.0)])
    with pytest.raises(ValueError, match="entry"):
        air.step([(len(waves), 10, 1.0)])


def test_device_air_raises_without_cuda(monkeypatch, frames):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tda.DeviceAir(frames[1], **KW)


# ---- BatchMac ----------------------------------------------------------------


def _script(mod):
    """One scripted exchange: A sends, some frames get lost, B block-acks,
    A retransmits; returns both MACs' stats and state."""
    A, Bd = b"\x02AAAAA", b"\x02BBBBB"
    ma = mod.BatchMac(A, Bd, n_seq=40, payload=48, timeout_rounds=2,
                      window_frames=16, ba_bits=64)
    mb = mod.BatchMac(Bd, A, n_seq=0, payload=48, ba_bits=64)
    rng = np.random.default_rng(12)
    log = []
    for rnd in range(12):
        seqs = ma.want_tx_seqs(rnd, 6, span_limit=32)
        rows = [np.frombuffer(ma.data_psdu(s), np.uint8)[:64] for s in seqs]
        lost = rng.random(len(rows)) < 0.3
        hdr = np.zeros((len(rows) + 2, 64), np.uint8)
        for i, r in enumerate(rows):
            hdr[i, : len(r)] = r
        ok = np.concatenate([~lost, [True, False]]).astype(np.uint8)
        mb.consume(hdr, ok)
        ba = np.frombuffer(mb.block_ack_psdu(), np.uint8)[:64]
        hb = np.zeros((2, 64), np.uint8)
        hb[0, : len(ba)] = ba
        ma.consume(hb, np.array([rnd % 4 != 1, 0], np.uint8))
        log.append((seqs, sorted(mb.new_rx)))
    state = (ma.stats, mb.stats, sorted(ma.acked), sorted(mb.rx_seqs),
             sorted(ma.outstanding.items()), ma.next_seq, ma.done, log)
    return state


def test_batchmac_matches_jax():
    got, want = _script(tda), _script(jda)
    assert vars(got[0]) == vars(want[0]) and vars(got[1]) == vars(want[1])
    assert got[2:] == want[2:]
    assert got[0].acked > 0 and got[0].retransmits > 0


def test_batchmac_frames_equal_jax():
    A, Bd = b"\x02AAAAA", b"\x02BBBBB"
    t = tda.BatchMac(A, Bd, n_seq=4, payload=100)
    j = jda.BatchMac(A, Bd, n_seq=4, payload=100)
    for s in (0, 1, 4095, 4096):
        assert t.data_psdu(s) == j.data_psdu(s)
    t.rx_seqs.update({0, 1, 3, 70})
    j.rx_seqs.update({0, 1, 3, 70})
    assert t.block_ack_psdu() == j.block_ack_psdu()


# ---- phy "n": the two-antenna air -------------------------------------------

HT_KW = dict(window=4096, batch=8, overlap=2048, slots=8, max_psdu=128,
             hdr_bytes=64, phy="n")
HT_EXACT = ["ok", "length", "lts1"]


@pytest.fixture(scope="module")
def ht_frames():
    from sora_tpu.golden import dot11n_np as gn

    psdus = [jfr.build_data_frame(bytes([i]) * 60, seq=i) for i in range(2)]
    return psdus, [np.asarray(gn.modulate(p, 11)) for p in psdus]


def test_ht_phy_noise_free_rounds_match_jax(ht_frames):
    """The scenario of tests/test_device_air.py (two MCS 11 2x2 frames,
    gaps longer than the hop) on noise-free air, over two rounds with a
    frame straddling the boundary: both airs decode every frame with equal
    flags, lengths, positions and headers."""
    psdus, waves = ht_frames
    span = max(w.shape[1] for w in waves)
    ta = tda.DeviceAir(waves, device="cpu", noise_rms=0.0, **HT_KW)
    ja = jda.DeviceAir(waves, noise_rms=0.0, **HT_KW)
    assert span <= ta.overlap and ta.n_ant == ja.n_ant == 2
    assert (ta.L, ta.carry_len, ta.advance) == (ja.L, ja.carry_len,
                                                ja.advance)
    offs = [300, 300 + span + 2100]      # gaps > hop (2048)
    rounds = [[(i, o, 1.0) for i, o in enumerate(offs)]
              + [(1, ta.advance - span + 500, 1.0)], [(0, 4000, 1.0)]]
    for r, tx in enumerate(rounds):
        to, tb = ta.step(tx)
        jo, jb = ja.step(tx)
        got = fetch(to[0])
        want = {k: np.asarray(v) for k, v in jo[0].items()}
        assert tb == jb and sorted(got) == sorted(want)
        for key in HT_EXACT:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        ok = want["ok"].astype(bool)
        np.testing.assert_array_equal(got["hdr"][ok], want["hdr"][ok])
        for key, tol in CLOSE.items():
            np.testing.assert_allclose(got[key][ok], want[key][ok], rtol=0,
                                       atol=tol, err_msg=key)
        assert ta._carry.shape == (2, ta.carry_len)
        np.testing.assert_allclose(ta._carry.numpy(), np.asarray(ja._carry),
                                   rtol=0, atol=CARRY_ATOL)
        if r == 0:
            for off in offs:
                assert _match(ta, got, tb, off, tol=1200), off
            assert _has_header(got, psdus[0])
            o0, b0 = got, tb
        else:
            assert _match(ta, got, tb, tb + 4000, tol=1200)
            straddle = b0 + rounds[0][2][1]
            assert (_match(ta, o0, b0, straddle, tol=1200)
                    or _match(ta, got, tb, straddle, tol=1200))


def test_ht_phy_noisy_air_decodes(ht_frames):
    """The two-antenna air with receiver noise (torch.Generator), and a
    min_mcs cap that keeps the MCS 11 frames."""
    psdus, waves = ht_frames
    air = tda.DeviceAir(waves, device="cpu", noise_rms=0.01, min_mcs=11,
                        **HT_KW)
    span = max(w.shape[1] for w in waves)
    offs = [300, 300 + span + 2100]
    outs, base = air.step([(i, o, 1.0) for i, o in enumerate(offs)])
    out = fetch(outs[0])
    for off in offs:
        assert _match(air, out, base, off, tol=1200), off
    assert _has_header(out, psdus[1])
    quiet, _ = air.step([])
    assert int(quiet[0]["ok"].sum()) == 0


# ---- phy "b": the 11 Msps DSSS air -----------------------------------------

B_KW = dict(window=4608, batch=8, overlap=3072, slots=8, max_psdu=128,
            hdr_bytes=64, phy="b")
B_EXACT = ["ok", "length", "rate_mbps", "lts1"]


@pytest.fixture(scope="module")
def dsss_frames():
    from sora_tpu.golden import dot11b_np as gb

    psdus = [jfr.build_data_frame(bytes([i]) * 40, seq=i) for i in range(2)]
    return psdus, [gb.modulate(p, r).astype(np.complex64)
                   for p, r in zip(psdus, (11, 11))]


def test_dsss_phy_noise_free_rounds_match_jax(dsss_frames):
    """The scenario of tests/test_device_air.py:160-186 (two DSSS frames,
    gaps longer than the hop, the first-burst lock) on noise-free air,
    over two rounds with a frame straddling the boundary: both airs decode
    every frame with equal flags, lengths, rates, positions and headers."""
    psdus, waves = dsss_frames
    span = max(len(w) for w in waves)
    ta = tda.DeviceAir(waves, device="cpu", noise_rms=0.0, **B_KW)
    ja = jda.DeviceAir(waves, noise_rms=0.0, **B_KW)
    assert span <= ta.overlap and ta.n_frames == ja.n_frames == 1
    assert (ta.L, ta.carry_len, ta.advance) == (ja.L, ja.carry_len,
                                                ja.advance)
    offs = [500, 500 + span + 1700]          # gaps > hop (1536)
    rounds = [[(i, o, 1.0) for i, o in enumerate(offs)]
              + [(1, ta.advance - span + 400, 1.0)], [(0, 3000, 1.0)]]
    for r, tx in enumerate(rounds):
        to, tb = ta.step(tx)
        jo, jb = ja.step(tx)
        got = fetch(to[0])
        want = {k: np.asarray(v) for k, v in jo[0].items()}
        assert tb == jb and sorted(got) == sorted(want)
        for key in B_EXACT:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        ok = want["ok"].astype(bool)
        np.testing.assert_array_equal(got["hdr"][ok], want["hdr"][ok])
        np.testing.assert_allclose(ta._carry.numpy(), np.asarray(ja._carry),
                                   rtol=0, atol=CARRY_ATOL)
        if r == 0:
            for off in offs:
                assert _match(ta, got, tb, off - 192, tol=1500), off
            assert _has_header(got, psdus[0])
            o0, b0 = got, tb
        else:
            assert _match(ta, got, tb, tb + 3000 - 192, tol=1500)
            straddle = b0 + rounds[0][2][1] - 192
            assert (_match(ta, o0, b0, straddle, tol=1500)
                    or _match(ta, got, tb, straddle, tol=1500))


def test_dsss_phy_noisy_air_decodes(dsss_frames):
    """The DSSS air with receiver noise (torch.Generator): both frames
    decode, and empty air stays quiet."""
    psdus, waves = dsss_frames
    air = tda.DeviceAir(waves, device="cpu", noise_rms=0.01, **B_KW)
    span = max(len(w) for w in waves)
    offs = [500, 500 + span + 1700]
    outs, base = air.step([(i, o, 1.0) for i, o in enumerate(offs)])
    out = fetch(outs[0])
    for off in offs:
        assert _match(air, out, base, off - 192, tol=1500), off
    assert _has_header(out, psdus[1])
    quiet, _ = air.step([])
    assert int(quiet[0]["ok"].sum()) == 0


def test_rx_soak_tool_phy_b_delivers_every_frame(monkeypatch):
    """``tools/realtime_soak.py --phy b`` at a small width: the canonical
    11b air cut to 8 windows a round on the CPU, every scheduled frame
    position-matched, goodput counted on 278-byte PSDUs."""
    from sora_tpu_torch.tools import realtime_soak as soak

    class SmallAir(tda.DeviceAir):
        def __init__(self, waves, **kw):
            super().__init__(waves, **{**kw, "batch": 8, "device": "cpu"})

    monkeypatch.setattr(soak, "DeviceAir", SmallAir)
    monkeypatch.setattr(soak, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    air, psdus, span = soak.make_rx_soak_air(phy="b")
    assert (air.window, air.overlap, air.max_psdu) == (8192, 5120, 512)
    assert span == 4336 and len(psdus[0]) == soak.SOAK_PSDU["b"] == 278
    res = soak.run_rx_soak(0.01, 2, lambda *a: None, phy="b")
    assert res["phy"] == "b" and res["frames_scheduled"] > 0
    assert res["frames_delivered"] == res["frames_scheduled"]
