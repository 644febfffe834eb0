"""The port's packet reflection (sora_tpu_torch.runtime.bridge, a copy of
the JAX package's, around the port's node) and its bridge app, on the CPU:
application bytes ride the software air between two cross-wired port
nodes, and ``apps.bridge --pair --sockets --selftest`` exits 0."""

import numpy as np
import pytest
import torch

from sora_tpu_torch.apps import bridge as app
from sora_tpu_torch.runtime.bridge import (ETH_HDR, PacketReflector,
                                           SocketBridge)
from sora_tpu_torch.runtime.native import RxRing
from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink

torch.set_num_threads(2)

ADDR_A = b"\x02BRDGA"
ADDR_B = b"\x02BRDGB"


def _pair_nodes():
    rings = (RxRing(capacity=1 << 22), RxRing(capacity=1 << 22))
    mk = lambda addr: NodeConfig(
        window=4096, batch=2, overlap=2816, max_psdu=128, addr=addr,
        rate_mbps=None, data_rate=12, min_rate_mbps=12,
        ack_timeout_slots=250, backlog_hwm=1 << 22)
    a = StreamingNode(rings[0], mk(ADDR_A), tx_sink=TxSink(rings[1]),
                      device="cpu")
    b = StreamingNode(rings[1], mk(ADDR_B), tx_sink=TxSink(rings[0]),
                      device="cpu")
    return rings, (a, b)


def _eth(dst, src, payload, ethertype=b"\x08\x00"):
    return dst + src + ethertype + payload


def _recv(sock):
    try:
        return sock.recv(2048)
    except BlockingIOError:
        return b""


def test_application_echo_over_the_air(rng):
    rings, (a, b) = _pair_nodes()
    br_a, app_a = SocketBridge.pair()
    br_b, app_b = SocketBridge.pair()
    refs = (PacketReflector(a, br_a), PacketReflector(b, br_b))
    app_a.setblocking(False)
    app_b.setblocking(False)
    req = _eth(ADDR_B, ADDR_A, b"echo request over the air")
    app_a.send(req)
    got_b = got_a = b""
    for _ in range(120):
        for r in rings:
            r.write((rng.normal(size=4096) + 1j * rng.normal(size=4096)
                     ).astype(np.complex64) * 0.01)
        for node, ref in zip((a, b), refs):
            node.step()
            ref.step()
        if not got_b:
            got_b = _recv(app_b)
            if got_b:
                app_b.send(_eth(got_b[6:12], got_b[:6], got_b[ETH_HDR:]))
        else:
            got_a = _recv(app_a)
            if got_a:
                break
    for node in (a, b):
        node.flush()
    got_a = got_a or _recv(app_a)
    assert got_b == req, (a.report(), b.report())
    assert got_a == _eth(ADDR_A, ADDR_B, req[ETH_HDR:]), (a.report(),
                                                          b.report())
    assert refs[0].pkts_out == 1 and refs[0].pkts_in >= 1
    assert refs[1].pkts_in >= 1 and refs[1].pkts_out == 1
    assert a.stats.tx_data >= 1 and b.stats.tx_data >= 1
    for s in (br_a, br_b, app_a, app_b):
        s.close()
    for r in rings:
        r.close()


def test_broadcast_ethernet_stays_broadcast(rng):
    rings, (a, b) = _pair_nodes()
    br_a, app_a = SocketBridge.pair()
    br_b, app_b = SocketBridge.pair()
    ref_a = PacketReflector(a, br_a)
    PacketReflector(b, br_b)
    app_b.setblocking(False)
    arp = _eth(b"\xff" * 6, ADDR_A, b"who-has 10.77.0.2",
               ethertype=b"\x08\x06")
    app_a.send(arp)
    got = b""
    for _ in range(80):
        for r in rings:
            r.write((rng.normal(size=4096) + 1j * rng.normal(size=4096)
                     ).astype(np.complex64) * 0.01)
        a.step()
        ref_a.step()
        b.step()
        got = _recv(app_b)
        if got:
            break
    for node in (a, b):
        node.flush()
    got = got or _recv(app_b)
    assert got == arp, (a.report(), b.report())
    assert b.stats.acks_tx == 0          # broadcast: no ACK
    for s in (br_a, br_b, app_a, app_b):
        s.close()
    for r in rings:
        r.close()


def test_bridge_selftest_app_on_cpu(capsys):
    rc = app.main(["--pair", "--sockets", "--selftest", "--device", "cpu",
                   "--mtu", "128", "--seconds", "120"])
    assert rc == 0, capsys.readouterr().err
    assert "selftest OK" in capsys.readouterr().err


def test_bridge_selftest_needs_pair_and_sockets():
    with pytest.raises(SystemExit):
        app.main(["--selftest", "--device", "cpu"])
