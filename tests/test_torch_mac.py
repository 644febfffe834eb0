"""The port's soft MAC (sora_tpu_torch.mac.{fsm,mgmt,csma} and
runtime.air.VirtualAir, numpy copies) against the JAX package's.

Management frames build and parse to the same bytes; the SignalCache
evicts the same way; a CSMA/CA exchange over the virtual air with the
golden PHY runs slot for slot as the JAX package's (same stats, payloads
and air log — both are deterministic numpy); and the port's own PHY (its
TX and ``demodulate(device="cpu")``) carries the exchange too.
"""

import numpy as np
import pytest

from sora_tpu.golden import dot11a_np as golden
from sora_tpu.mac import csma as jcsma
from sora_tpu.mac import mgmt as jmgmt
from sora_tpu.runtime import air as jair
from sora_tpu_torch.mac import csma as tcsma
from sora_tpu_torch.mac import mgmt as tmgmt
from sora_tpu_torch.mac.fsm import Fsm
from sora_tpu_torch.phy.dot11a import rx as trx
from sora_tpu_torch.phy.dot11a import tx as ttx
from sora_tpu_torch.runtime import air as tair
from sora_tpu_torch.util.xfer import fetch

A1 = b"\x02\x00\x00\x00\x00\x01"
A2 = b"\x02\x00\x00\x00\x00\x02"


def _golden_phy():
    return (lambda psdu, rate: golden.modulate(psdu, rate).astype(
        np.complex64),
            lambda x: golden.demodulate(np.asarray(x, np.complex128)))


def _port_phy():
    import torch

    def modulate(psdu, rate):
        p = torch.from_numpy(np.frombuffer(psdu, np.uint8).copy()[None])
        return fetch(ttx.modulate(p, rate, len(psdu))[0])

    return modulate, lambda x: trx.demodulate(x, device="cpu")


def _exchange(csma, air_mod, phy, seed, script, slots):
    air = air_mod.VirtualAir(snr_db=30.0, seed=seed)
    mod, dem = phy
    a = csma.SoftMac(A1, air, mod, dem, rate=6, name="A")
    b = csma.SoftMac(A2, air, mod, dem, rate=6, name="B")
    script(a, b)
    csma.run_air(air, [a, b], slots)
    return air, a, b


def _bidirectional(a, b):
    for i in range(3):
        a.send(f"a->b {i}".encode(), A2)
        b.send(f"b->a {i}".encode(), A1)


def _beacon(a, b):
    a.send_beacon(tmgmt.Bss(ssid="over-air", bssid=A1))


@pytest.mark.parametrize("seed,script,slots", [
    (1, lambda a, b: a.send(b"hello from A", A2), 400),
    (2, _bidirectional, 4000),
    (7, lambda a, b: (a.send(b"from A", A2), b.send(b"from B", A1)), 8000),
    (6, _beacon, 600)])
def test_csma_over_virtual_air_equals_jax(seed, script, slots):
    runs = [_exchange(csma, air, _golden_phy(), seed, script, slots)
            for csma, air in ((jcsma, jair), (tcsma, tair))]
    (jair_, ja, jb), (tair_, ta, tb) = runs
    assert tair_.log == jair_.log
    for j, t in ((ja, ta), (jb, tb)):
        assert vars(t.stats) == vars(j.stats)
        assert t.rx_payloads == j.rx_payloads
        assert t.fsm.state == j.fsm.state
    assert tb.rx_payloads


def test_csma_with_the_port_phy():
    air, a, b = _exchange(tcsma, tair, _port_phy(), 1,
                          lambda a, b: a.send(b"hello from A", A2), 400)
    assert b.rx_payloads == [(A1, b"hello from A")]
    assert a.stats.rx_ack == 1 and a.stats.drops == 0
    assert b.stats.tx_ack == 1
    assert a.fsm.state == "idle" and not a._queue


def test_retransmission_and_drop():
    air = tair.VirtualAir(snr_db=30.0, seed=3)
    mod, dem = _golden_phy()
    a = tcsma.SoftMac(A1, air, mod, dem, rate=6)
    a.send(b"nobody home", A2)
    tcsma.run_air(air, [a], 20000)
    assert a.stats.drops == 1
    assert a.stats.retries == tcsma.RETRY_LIMIT + 1 == 8
    assert a.stats.tx_data == 8


def test_signal_cache_hits_and_evicts():
    mod, _ = _golden_phy()
    calls = []
    c = tcsma.SignalCache(lambda p, r: (calls.append(1), mod(p, r))[1],
                          capacity=2)
    w1 = c.get(b"frame-a" * 4, 6)
    w2 = c.get(b"frame-a" * 4, 6)
    assert np.array_equal(w1, w2) and len(calls) == 1
    assert c.hits == 1 and c.misses == 1
    c.get(b"frame-b" * 4, 6)
    c.get(b"frame-c" * 4, 6)             # evicts frame-a
    c.get(b"frame-a" * 4, 6)
    assert len(calls) == 4


def test_mgmt_frames_equal_jax():
    for mg in (tmgmt, jmgmt):
        assert mg.FC_ACK == 0x00D4 and mg.DEFAULT_RATES[-1] == 54
    bss_t = tmgmt.Bss(ssid="tpu-net", bssid=b"\x02BSSID")
    bss_j = jmgmt.Bss(ssid="tpu-net", bssid=b"\x02BSSID")
    pairs = [
        (tmgmt.build_beacon(bss_t, timestamp_us=12345, seq=7),
         jmgmt.build_beacon(bss_j, timestamp_us=12345, seq=7)),
        (tmgmt.build_auth(A1, bss_t.bssid, seq_num=1),
         jmgmt.build_auth(A1, bss_j.bssid, seq_num=1)),
        (tmgmt.build_assoc_req(A1, bss_t), jmgmt.build_assoc_req(A1, bss_j)),
        (tmgmt.build_assoc_resp(A1, bss_t, aid=5),
         jmgmt.build_assoc_resp(A1, bss_j, aid=5))]
    for got, want in pairs:
        assert got == want
        assert tmgmt.frame_type(got) == jmgmt.frame_type(want)
    beacon, auth, _, resp = (g for g, _ in pairs)
    got = tmgmt.parse_beacon(beacon)
    assert got.ssid == "tpu-net" and got.bssid == b"\x02BSSID"
    assert got.rates_mbps == tmgmt.DEFAULT_RATES
    assert tmgmt.parse_auth(auth) == jmgmt.parse_auth(auth) == (A1, 1, 0)
    assert tmgmt.parse_assoc_resp(resp) == (0, 5)
    assert tmgmt.parse_beacon(auth) is None
    assert [tmgmt.fc_name(f) for f in (0x0080, 0x00D4, 0x0008, 0x00B0)] == \
        [jmgmt.fc_name(f) for f in (0x0080, 0x00D4, 0x0008, 0x00B0)]


def test_fsm_basics():
    m = Fsm("idle")
    hits = []
    m.on("idle", "go", "run", action=lambda: hits.append(1))
    m.on("run", "stop", "idle")
    assert m.fire("go") == "run" and hits == [1]
    assert m.can("stop") and not m.can("go")
    with pytest.raises(ValueError):
        m.fire("go")
    assert m.trace[-1] == ("idle", "go", "run")
