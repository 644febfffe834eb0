"""The port's live streaming node (sora_tpu_torch.runtime.node, phy "a" and
"n", on the CPU) against the JAX package's (sora_tpu.runtime.node).

The same ring samples (traffic from sora_tpu.golden.dot11a_np, and for
11n from dot11n_np on two rings, the scenarios of tests/test_node.py) go
into a JAX node and a port node with the same NodeConfig; after both
drain, the outcome counts (frame_ok, dup, cs_timeout, crc_fail, acks_tx,
...) and the delivered payloads must be equal.  Timing-dependent MAC state (when a
pending detect is ready, backoff draws, retries) is not compared: the
two-node conversations assert what tests/test_node.py asserts.  The
port's ACK waveforms come from its own TX: they must equal the golden
model's within 1e-5 and decode to the right bytes.  NodeConfig sizes all
three PHYs exactly as the JAX package does.  Sizes are small (windows of
4096, batch 2), as in tests/test_node.py.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.mac.frame import MacHeader, append_fcs, build_ack_frame
from sora_tpu.runtime import native as jnative
from sora_tpu.runtime import node as jnode
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.runtime import native as tnative
from sora_tpu_torch.runtime import node as tnode

torch.set_num_threads(2)

ADDR = b"\x02SORA1"
PEER = b"\x02PEER0"
BASE = dict(window=4096, batch=2, overlap=2816, max_psdu=256, addr=ADDR,
            rate_mbps=None, min_rate_mbps=24)
COUNTS = ("windows", "cs_timeout", "decoded_batches", "frame_ok",
          "plcp_fail", "crc_fail", "truncated", "compaction_drop", "dup",
          "not_for_us", "acks_tx", "backlog_dropped")
ACK_ATOL = 1e-5           # the port's TX against the float64 golden model


def _traffic(n_frames, rng, rate=12, to=ADDR, gap=700):
    pieces = []
    for i in range(n_frames):
        hdr = MacHeader(addr1=to, addr2=PEER, addr3=to,
                        seq_ctrl=(i & 0xFFF) << 4)
        psdu = append_fcs(hdr.pack()
                          + bytes(rng.integers(0, 256, 80, dtype=np.uint8)))
        pieces.append(np.zeros(gap, np.complex64))
        pieces.append(golden.modulate(psdu, rate).astype(np.complex64))
    pieces.append(np.zeros(3 * gap, np.complex64))
    x = np.concatenate(pieces)
    x += (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x))
          ).astype(np.complex64) * 0.01
    return x


def _drain(node):
    idle = 0
    while idle < 3:
        idle = 0 if node.step() else idle + 1
    node.flush()


def _both(cfg, writes, capacity=1 << 20, act=_drain):
    """A JAX node and a port node fed the same ring samples; ``act`` runs
    each.  Returns (jax node, port node)."""
    nodes = []
    for native, mod, kw in ((jnative, jnode, {}),
                            (tnative, tnode, {"device": "cpu"})):
        ring = native.RxRing(capacity=capacity)
        node = mod.StreamingNode(ring, mod.NodeConfig(**cfg),
                                 tx_sink=mod.TxSink(), **kw)
        for x in writes:
            ring.write(x)
        act(node)
        ring.close()
        nodes.append(node)
    return nodes


def _assert_same(j, t, counts=COUNTS, payloads=True):
    for name in counts:
        assert getattr(t.stats, name) == getattr(j.stats, name), (
            name, j.report(), t.report())
    if payloads:
        assert t.rx_payloads == j.rx_payloads
        assert ([n for _, n in t.tx.fired] == [n for _, n in j.tx.fired])


# -- NodeConfig ---------------------------------------------------------------


def _config_cases():
    cases = []
    for psdu in (28, 256, 1500, 2500):
        for rate in (6, 24, 54):
            for ir in ("20m", "40m", "44m"):
                cases.append(dict(phy="a", max_psdu=psdu, min_rate_mbps=rate,
                                  input_rate=ir))
        for rate in (1, 2, 5.5, 11):
            for ir in ("11m", "40m", "44m"):
                cases.append(dict(phy="b", max_psdu=psdu, min_rate_mbps=rate,
                                  input_rate=ir))
        for mcs in (None, 0, 7, 8, 15):
            cases.append(dict(phy="n", max_psdu=psdu, mcs=mcs))
    cases += [dict(window=4096, overlap=1024, max_psdu=1600),
              dict(window=8192, max_psdu=1600, min_rate_mbps=6),
              dict(window=4096, batch=4, max_psdu=128, decode_slots=5),
              dict(batch=3, max_psdu=128, decode_slots=-1, rate_mbps=24),
              dict(phy="b", window=8192, batch=2, overlap=6144, max_psdu=72,
                   input_rate="11m"),
              dict(phy="n", window=4096, batch=2, overlap=2816, mcs=4)]
    return cases


def _make(mod, kw):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        cfg = mod.NodeConfig(**kw)
    return dataclasses.asdict(cfg), [str(w.message) for w in seen]


@pytest.mark.parametrize("kw", _config_cases())
def test_node_config_autosize_equals_jax(kw):
    got, got_warn = _make(tnode, kw)
    want, want_warn = _make(jnode, kw)
    assert got == want
    assert got_warn == want_warn


def test_node_config_span_warning_and_errors():
    _, warned = _make(tnode, dict(window=4096, overlap=1024, max_psdu=1600))
    assert warned and "frame span" in warned[0]
    for bad in (dict(wire="i12"), dict(phy="g"),
                dict(window=4096, overlap=4096)):
        with pytest.raises(ValueError):
            tnode.NodeConfig(**bad)


def test_frame_span_equals_jax():
    for phy, rates, irs in (("a", (6, 24, 54), ("20m", "40m", "44m")),
                            ("b", (1, 2, 5.5, 11), ("11m", "40m", "44m")),
                            ("n", (0, 7, 8, 15), ("20m", "44m"))):
        for rate in rates:
            for ir in irs:
                for n in (14, 148, 1500):
                    assert (tnode.frame_span_samples(phy, n, rate, ir)
                            == jnode.frame_span_samples(phy, n, rate, ir))


@pytest.mark.parametrize("phy", ["b", "n"])
def test_phy_b_and_n_raise_not_implemented(phy):
    """Both are ported.  phy "b" builds on one ring, and a phy "a" node
    reconfigures to it; phy "n" on one ring raises the JAX package's
    ValueError (it needs two rings, node.py:270 and :404)."""
    ring = tnative.RxRing(capacity=1 << 16)
    if phy == "b":
        node = tnode.StreamingNode(ring, tnode.NodeConfig(
            phy="b", input_rate="11m", max_psdu=72, batch=2), device="cpu")
        assert node.cfg.ack_rate == 2 and node._pos_scale() == 1.0
    else:
        with pytest.raises(ValueError, match="two RX rings"):
            tnode.StreamingNode(ring, tnode.NodeConfig(phy="n"),
                                device="cpu")
        with pytest.raises(ValueError):
            jnode.StreamingNode(ring, jnode.NodeConfig(phy="n"))
    node = tnode.StreamingNode(ring, tnode.NodeConfig(**BASE), device="cpu")
    if phy == "b":
        node.reconfigure(phy="b", rate_mbps=11)
        assert node._decode is node._prog_table[("b", 11, None)][0]
    else:
        with pytest.raises(ValueError, match="two RX rings"):
            node.reconfigure(phy=phy)
    with pytest.raises(ValueError):
        node.reconfigure(window=1234)
    with pytest.raises(ValueError, match="phy must be"):
        node.reconfigure(phy="g")
    ring.close()


def test_node_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ring = tnative.RxRing(capacity=1 << 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnode.StreamingNode(ring, tnode.NodeConfig(**BASE))
    ring.close()


# -- the same ring samples through both nodes ---------------------------------


def test_decode_and_ack_equal_jax(rng):
    j, t = _both(BASE, [_traffic(6, rng)])
    _assert_same(j, t)
    assert t.stats.frame_ok == t.stats.acks_tx == 6
    assert {s for s, _ in t.rx_payloads} == {PEER}
    assert t._agc_gain == pytest.approx(j._agc_gain, rel=1e-5)


def test_dedup_overlap_not_replays_equal_jax(rng):
    x = _traffic(1, rng)
    j, t = _both(BASE, [x, x])
    _assert_same(j, t)
    assert t.stats.frame_ok == 2


def test_idle_air_gated_equal_jax(rng):
    noise = (rng.normal(size=40000) + 1j * rng.normal(size=40000)
             ).astype(np.complex64) * 0.05
    j, t = _both(BASE, [noise])
    _assert_same(j, t)
    assert t.stats.frame_ok == t.stats.decoded_batches == 0
    assert t.stats.cs_timeout > 0 and t._agc_gain == 1.0


def test_other_destinations_equal_jax(rng):
    j, t = _both(BASE, [_traffic(3, rng, to=b"\x02OTHER")])
    _assert_same(j, t)
    assert t.stats.not_for_us == 3 and t.stats.acks_tx == 0


def test_backlog_watchdog_equal_jax(rng):
    noise = (rng.normal(size=200_000) + 1j * rng.normal(size=200_000)
             ).astype(np.complex64) * 0.03
    dropped = []
    j, t = _both(dict(BASE, backlog_hwm=32768), [noise],
                 act=lambda node: dropped.append(node.skip_backlog()))
    assert dropped[0] == dropped[1] > 0
    _assert_same(j, t)


def test_compaction_sparse_equal_jax(rng):
    cfg = dict(max_psdu=128, min_rate_mbps=12, addr=ADDR, batch=4,
               rate_mbps=None, decode_slots=8)
    j, t = _both(cfg, [_traffic(10, rng, rate=24, gap=4000)])
    _assert_same(j, t)
    assert t.stats.frame_ok == 10


def test_compaction_keeps_carrier_sense_equal_jax(rng):
    """Dense air past the decode_slots bucket: which candidates win the
    top-k may differ on near-equal detect metrics (torch.topk and
    lax.top_k), so the counts are compared, not the payloads."""
    cfg = dict(max_psdu=128, min_rate_mbps=12, addr=ADDR, batch=4,
               rate_mbps=None, decode_slots=2)
    x = _traffic(20, rng, rate=12, to=b"\x02OTHER", gap=200)
    j, t = _both(cfg, [x], capacity=1 << 21)
    _assert_same(j, t, counts=("windows", "cs_timeout", "decoded_batches",
                               "compaction_drop", "not_for_us"),
                 payloads=False)
    assert t.stats.compaction_drop > 0
    assert t._busy_until == j._busy_until


@pytest.mark.parametrize("scale", [1e-2, 3.0])
def test_agc_off_scale_equal_jax(rng, scale):
    x = (_traffic(8, rng) * scale).astype(np.complex64)
    j, t = _both(dict(BASE, max_psdu=256), [x], capacity=1 << 22)
    _assert_same(j, t)
    assert t.stats.frame_ok == 8
    assert t._agc_gain == pytest.approx(j._agc_gain, rel=1e-4)


def test_i8_wire_equal_jax(rng):
    x = (_traffic(8, rng) * 0.05).astype(np.complex64)
    j, t = _both(dict(BASE, wire="i8"), [x], capacity=1 << 22)
    _assert_same(j, t)
    assert t.stats.frame_ok >= 7 and t._agc_gain > 5.0


def test_44msps_input_equal_jax(rng):
    import jax.numpy as jnp

    from sora_tpu.phy import frontend as jfe

    x20 = _traffic(5, rng, gap=900)
    x44 = np.asarray(jfe.ofdm_upsample_44m(jnp.asarray(x20[None])))[0]
    x44 = (x44 + (rng.normal(size=len(x44)) + 1j * rng.normal(
        size=len(x44))) * 0.01).astype(np.complex64)
    cfg = dict(max_psdu=256, min_rate_mbps=12, addr=ADDR, batch=2,
               rate_mbps=None, input_rate="44m")
    j, t = _both(cfg, [x44], capacity=1 << 22)
    _assert_same(j, t)
    assert t.stats.frame_ok == t.stats.acks_tx == 5
    assert 1700 < t.tx.fired[0][1] < 2300       # ACKs at 44 Msps


def test_fixed_rate_reconfigure_equal_jax(rng):
    x1, x2 = _traffic(2, rng), _traffic(2, rng)

    def act(node):
        node.rings[0].write(x1)
        _drain(node)
        node.reconfigure(rate_mbps=12, detect_threshold=0.5)
        node.rings[0].write(x2)
        _drain(node)
        before = dict(node._prog_table)
        node.reconfigure(rate_mbps=None)
        assert dict(node._prog_table) == before

    j, t = _both(BASE, [], capacity=1 << 21, act=act)
    _assert_same(j, t)
    assert t.stats.frame_ok == 4


# -- 11b: 11 Msps chips on one ring (the scenarios of tests/test_node.py) ----

B_BASE = dict(phy="b", input_rate="11m", window=8192, batch=2, overlap=6144,
              max_psdu=72, min_rate_mbps=2, addr=ADDR, sample_rate_sps=11e6)


def _traffic_b(rng, rates=(2, 5.5, 11), to=ADDR, gap=2200, nbytes=40):
    """DSSS frames from the golden model, one per rate, plus noise (the
    traffic of tests/test_node.py:141)."""
    from sora_tpu.golden import dot11b_np as gb

    pieces, psdus = [], []
    for i, rate in enumerate(rates):
        hdr = MacHeader(addr1=to, addr2=PEER, addr3=to,
                        seq_ctrl=(i & 0xFFF) << 4)
        psdu = append_fcs(hdr.pack() + bytes(
            rng.integers(0, 256, nbytes, dtype=np.uint8)))
        psdus.append(psdu)
        pieces += [np.zeros(gap, np.complex64),
                   gb.modulate(psdu, rate).astype(np.complex64)]
    pieces.append(np.zeros(3 * gap, np.complex64))
    x = np.concatenate(pieces)
    x += (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x))
          ).astype(np.complex64) * 0.01
    return x, psdus


@pytest.mark.parametrize("rate", [None, 11])
def test_11b_decode_and_ack_equal_jax(rng, rate):
    """Mixed-rate DSSS traffic (2, 5.5, 11 Mbps) through the auto dispatch,
    or only its 11 Mbps frame through the fixed-rate program (the others
    fail their SIGNAL check); ACKs at 2 Mbps DSSS (tests/test_node.py:160)."""
    x, psdus = _traffic_b(rng)
    j, t = _both(dict(B_BASE, rate_mbps=rate), [x])
    _assert_same(j, t)
    want = 3 if rate is None else 1
    assert t.stats.frame_ok == t.stats.acks_tx == want
    assert {s for s, _ in t.rx_payloads} == {PEER}
    assert [p for _, p in t.rx_payloads] == [p[24:-4] for p in psdus][-want:]


def test_11b_ack_waveform_equals_golden_and_decodes():
    from sora_tpu.golden import dot11b_np as gb

    ring = tnative.RxRing(capacity=1 << 16)
    node = tnode.StreamingNode(ring, tnode.NodeConfig(**B_BASE), device="cpu")
    ack = build_ack_frame(PEER)
    wave = node.cache.get(ack, node.cfg.ack_rate)
    ring.close()
    want = gb.modulate(ack, 2).astype(np.complex64)
    assert wave.dtype == np.complex64 and wave.shape == want.shape
    assert np.abs(wave - want).max() < ACK_ATOL
    res = gb.demodulate(np.concatenate([np.zeros(64, np.complex64), wave,
                                        np.zeros(64, np.complex64)]))
    assert res.ok and res.rate_mbps == 2 and res.psdu == ack


def test_11b_cs_gates_idle_air_equal_jax(rng):
    noise = (rng.normal(size=60000) + 1j * rng.normal(size=60000)
             ).astype(np.complex64) * 0.05
    j, t = _both(B_BASE, [noise])
    _assert_same(j, t)
    assert t.stats.frame_ok == t.stats.decoded_batches == 0
    assert t.stats.cs_timeout > 0


@pytest.mark.parametrize("ir", ["44m", "40m"])
def test_11b_radio_rate_input_equal_jax(rng, ir):
    """44 and 40 Msps input: the chip front end runs ahead of the DSSS
    receiver, positions scale to input samples, and the ACKs go out pulse
    shaped at the input rate."""
    import jax.numpy as jnp

    from sora_tpu.phy import frontend as jfe

    x, _ = _traffic_b(rng, rates=(11, 2), gap=2000)
    y = jfe.pulse_shape_11b(jnp.asarray(x[None]))
    if ir == "40m":
        y = jfe.resample(y, 10, 11)
    y = np.asarray(y)[0]
    y = (y + (rng.normal(size=len(y)) + 1j * rng.normal(size=len(y)))
         * 0.005).astype(np.complex64)
    cfg = dict(B_BASE, input_rate=ir, window=32768, overlap=24576,
               sample_rate_sps=44e6 if ir == "44m" else 40e6)
    j, t = _both(cfg, [y], capacity=1 << 21)
    _assert_same(j, t)
    assert t.stats.frame_ok == t.stats.acks_tx == 2
    ack = build_ack_frame(PEER)
    tw, jw = t.cache.get(ack, 2), j.cache.get(ack, 2)
    assert tw.shape == jw.shape
    assert np.abs(tw - jw).max() < ACK_ATOL


# -- 11n: two rings (the scenarios of tests/test_node.py) ---------------------

N_BASE = dict(phy="n", window=4096, batch=2, overlap=2816, min_rate_mbps=9,
              max_psdu=256, addr=ADDR)


def _both_n(cfg, act):
    """A JAX node and a port node, each on its own pair of rings; ``act``
    (node, rings) writes the same samples into both and drains."""
    nodes = []
    for native, mod, kw in ((jnative, jnode, {}),
                            (tnative, tnode, {"device": "cpu"})):
        rings = [native.RxRing(capacity=1 << 20) for _ in range(2)]
        node = mod.StreamingNode(rings, mod.NodeConfig(**cfg),
                                 tx_sink=mod.TxSink(), **kw)
        act(node, rings)
        for r in rings:
            r.close()
        nodes.append(node)
    return nodes


def _write_n(rings, ys, rng, gap=900, tail=2700, noise=0.01):
    """Frames ys (each (2, n): both antennas) separated by gaps, plus
    noise, into the two rings."""
    for a, ring in enumerate(rings):
        pieces = []
        for y in ys:
            pieces += [np.zeros(gap, np.complex64), y[a].astype(np.complex64)]
        pieces.append(np.zeros(tail, np.complex64))
        x = np.concatenate(pieces)
        x += (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x))
              ).astype(np.complex64) * noise
        ring.write(x)


def _ht_psdus(rng, n, seq0=0, nbytes=70):
    return [append_fcs(MacHeader(addr1=ADDR, addr2=PEER, addr3=ADDR,
                                 seq_ctrl=(seq0 + i) << 4).pack()
                       + bytes(rng.integers(0, 256, nbytes, dtype=np.uint8)))
            for i in range(n)]


def _chan(rng, cols):
    while True:
        h = (rng.normal(size=(2, cols)) + 1j * rng.normal(size=(2, cols))
             ) / np.sqrt(2.0)
        if (abs(np.linalg.det(h)) > 0.3 if cols == 2
                else np.abs(h).min() > 0.25):
            return h


def test_11n_mimo_two_rings_equal_jax():
    """Mixed-MCS 2x2 frames on two rings (auto dispatch over both stream
    classes), legacy-OFDM ACKs (tests/test_node.py:225)."""
    from sora_tpu.golden import dot11n_np as gn

    rng = np.random.default_rng(31)
    psdus = _ht_psdus(rng, 3, nbytes=80)
    ys = [gn.modulate(p, m) for p, m in zip(psdus, (8, 11, 15))]
    j, t = _both_n(N_BASE, lambda node, rings: (
        _write_n(rings, ys, np.random.default_rng(32), gap=800,
                 noise=0.005), _drain(node)))
    _assert_same(j, t)
    assert t.stats.frame_ok == t.stats.acks_tx == 3
    assert [p for _, p in t.rx_payloads] == [p[24:-4] for p in psdus]


def test_11n_single_stream_mcs_equal_jax():
    """A fixed single-stream MCS: one TX chain through a random 2x1
    channel, MRC decode (tests/test_node.py:657)."""
    from sora_tpu.golden import dot11n_np as gn

    rng = np.random.default_rng(33)
    h = _chan(rng, 1)
    psdus = _ht_psdus(rng, 3)
    ys = [h @ gn.modulate(p, 4) for p in psdus]
    j, t = _both_n(dict(N_BASE, mcs=4), lambda node, rings: (
        _write_n(rings, ys, np.random.default_rng(34)), _drain(node)))
    _assert_same(j, t)
    assert t.stats.frame_ok == 3
    assert [p for _, p in t.rx_payloads] == [p[24:-4] for p in psdus]


def test_11n_auto_mixed_stream_classes_equal_jax():
    """One batch carrying a 2-stream (MCS 9) and a single-stream (MCS 3)
    frame: both auto programs run and the per-row winner is the one whose
    HT-SIG and FCS closed (tests/test_node.py:697)."""
    from sora_tpu.golden import dot11n_np as gn

    rng = np.random.default_rng(35)
    psdus = _ht_psdus(rng, 2)
    ys = [_chan(rng, 2) @ gn.modulate(psdus[0], 9),
          _chan(rng, 1) @ gn.modulate(psdus[1], 3)]
    j, t = _both_n(N_BASE, lambda node, rings: (
        _write_n(rings, ys, np.random.default_rng(36)), _drain(node)))
    _assert_same(j, t)
    assert t.stats.frame_ok == 2
    assert [p for _, p in t.rx_payloads] == [p[24:-4] for p in psdus]


def test_11n_reconfigure_across_stream_classes_equal_jax():
    """A live reconfigure from a 2-stream MCS to a single-stream MCS swaps
    in the single-stream program from the table (tests/test_node.py:744)."""
    from sora_tpu.golden import dot11n_np as gn

    rng = np.random.default_rng(37)
    H2, h1 = _chan(rng, 2), np.array([[0.9 + 0.2j], [0.4 - 0.7j]])
    first, second = _ht_psdus(rng, 2), _ht_psdus(rng, 2, seq0=4)

    def act(node, rings):
        w = np.random.default_rng(38)
        _write_n(rings, [H2 @ gn.modulate(p, 9) for p in first], w)
        _drain(node)
        assert node.stats.frame_ok == 2
        node.reconfigure(mcs=3)
        _write_n(rings, [h1 @ gn.modulate(p, 3) for p in second], w)
        _drain(node)
        before = dict(node._prog_table)
        node.reconfigure(mcs=9)
        assert dict(node._prog_table) == before

    j, t = _both_n(dict(N_BASE, mcs=9), act)
    _assert_same(j, t)
    assert t.stats.frame_ok == 4
    assert [p for _, p in t.rx_payloads] == [p[24:-4]
                                             for p in first + second]


def test_11n_carry_path_equals_native_feed():
    """The Python carry path (the flush's, or a ring without the windowed
    read) stacks the two antennas as the native read does."""
    from sora_tpu.golden import dot11n_np as gn

    rng = np.random.default_rng(39)
    psdus = _ht_psdus(rng, 3)
    ys = [_chan(rng, 2) @ gn.modulate(p, 12) for p in psdus]
    nodes = []
    for native_feed in (True, False):
        rings = [tnative.RxRing(capacity=1 << 20) for _ in range(2)]
        node = tnode.StreamingNode(rings, tnode.NodeConfig(**N_BASE),
                                   tx_sink=tnode.TxSink(), device="cpu")
        node._native_feed = native_feed
        _write_n(rings, ys, np.random.default_rng(40))
        _drain(node)
        for r in rings:
            r.close()
        nodes.append(node)
    assert nodes[0].stats.frame_ok == nodes[1].stats.frame_ok == 3
    assert nodes[0].rx_payloads == nodes[1].rx_payloads


# -- ACK waveforms ------------------------------------------------------------


@pytest.mark.parametrize("ir", ["20m", "40m"])
def test_ack_waveform_equals_golden_and_decodes(ir):
    ring = tnative.RxRing(capacity=1 << 16)
    node = tnode.StreamingNode(ring, tnode.NodeConfig(
        max_psdu=256, min_rate_mbps=24, batch=2, input_rate=ir),
        device="cpu")
    ack = build_ack_frame(PEER)
    wave = node.cache.get(ack, node.cfg.ack_rate)
    ring.close()
    assert wave.dtype == np.complex64
    if ir == "20m":
        want = golden.modulate(ack, 6).astype(np.complex64)
        assert wave.shape == want.shape
        assert np.abs(wave - want).max() < ACK_ATOL
        x = wave
    else:
        assert len(wave) == 2 * len(golden.modulate(ack, 6))
        x = wave[0::2]
    res = trx.demodulate(np.concatenate([np.zeros(50, np.complex64), x,
                                         np.zeros(50, np.complex64)]),
                         device="cpu")
    assert res.ok and res.psdu == ack and res.psdu[4:10] == PEER


# -- two nodes over cross-wired rings (port only) -----------------------------


def _two_nodes(ack_timeout_slots=250, **extra):
    rings = (tnative.RxRing(capacity=1 << 22),
             tnative.RxRing(capacity=1 << 22))
    mk = lambda addr, **kw: tnode.NodeConfig(
        window=4096, batch=2, overlap=2816, max_psdu=128, addr=addr,
        rate_mbps=None, data_rate=12, min_rate_mbps=12,
        ack_timeout_slots=ack_timeout_slots, **kw)
    a = tnode.StreamingNode(rings[0], mk(ADDR, **extra),
                            tx_sink=tnode.TxSink(rings[1]), device="cpu")
    b = tnode.StreamingNode(rings[1], mk(PEER),
                            tx_sink=tnode.TxSink(rings[0]), device="cpu")
    return rings, (a, b)


def _pump(rings, nodes, rng, chunks, done, chunk=4096):
    """Idle-air clock: write low noise into both rings, step both nodes."""
    for _ in range(chunks):
        for r in rings:
            r.write((rng.normal(size=chunk) + 1j * rng.normal(size=chunk)
                     ).astype(np.complex64) * 0.01)
        for node in nodes:
            node.step()
        if done():
            break
    for node in nodes:
        node.flush()


def test_two_nodes_exchange_data_and_acks(rng):
    rings, (a, b) = _two_nodes()
    payload = b"hello from A" * 4
    a.send(payload, PEER)
    _pump(rings, (a, b), rng, chunks=40, done=lambda: a.stats.tx_acked >= 1)
    assert a.stats.tx_data >= 1, a.report()
    assert b.stats.frame_ok >= 1, b.report()
    assert b.rx_payloads and b.rx_payloads[0] == (ADDR, payload)
    assert b.stats.acks_tx >= 1
    assert a.stats.tx_acked == 1, a.report()
    assert a.stats.tx_drops == 0
    for r in rings:
        r.close()


def test_two_nodes_auth_assoc_handshake(rng):
    rings, (ap, st) = _two_nodes(beacon_interval_s=1e9)
    st.start_join(ADDR)
    _pump(rings, (ap, st), rng, chunks=60,
          done=lambda: st.associated_bssid is not None)
    assert st.associated_bssid == ADDR, (ap.report(), st.report())
    assert ap.stations.get(PEER) == 1
    assert ap.stats.mgmt_rx >= 2 and st.stats.mgmt_rx >= 2
    for r in rings:
        r.close()
