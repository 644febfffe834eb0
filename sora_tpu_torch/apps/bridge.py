"""Packet-reflection bridge CLI: attach node(s) to the OS network stack
(port of ``sora_tpu.apps.bridge``).

The Sora-as-a-NIC loop (SoraUEnableGetTxPacket,
kernel/bb/umxsdrbrick/dot11main.cpp:413; SoraUIndicateRxPacket,
kernel/bb/umxsdrbrick/mac.cpp:900) over TAP interfaces: ethernet frames
written to the interface go out over the (software) air, decoded frames
come back as received packets — unmodified applications run over the link.

Examples
--------
Two cross-wired nodes on two TAP interfaces (needs root)::

    python -m sora_tpu_torch.apps.bridge --pair --seconds 60 &
    ip addr add 10.77.0.1/24 dev sora0
    ip addr add 10.77.0.2/24 dev sora1 nodad
    # the kernel would short-circuit local<->local traffic, so ping from
    # separate netns or use the sockets mode below for a self-test
    ping -I sora0 10.77.0.2

Unprivileged self-test over AF_UNIX datagram bridges (application echo
through the software air, no root), on the card::

    python -m sora_tpu_torch.apps.bridge --pair --sockets --selftest

``--device cpu`` runs the nodes on the CPU (the default is cuda).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


ADDR_A = b"\x02SORA0"
ADDR_B = b"\x02SORA1"


def _mk_pair(window: int, batch: int, max_psdu: int, device):
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink

    ring_a = RxRing(capacity=1 << 22)
    ring_b = RxRing(capacity=1 << 22)
    # window=0 auto-sizes window/overlap from max_psdu at the air's
    # floor rate (24, data AND acks), so every config is coherent and
    # boundary-safe — no span warning at any --mtu
    mk = lambda addr: NodeConfig(
        window=window, batch=batch, overlap=0, max_psdu=max_psdu,
        addr=addr, rate_mbps=None, data_rate=24, ack_rate=24,
        min_rate_mbps=24)
    a = StreamingNode(ring_a, mk(ADDR_A), tx_sink=TxSink(ring_b),
                      device=device)
    b = StreamingNode(ring_b, mk(ADDR_B), tx_sink=TxSink(ring_a),
                      device=device)
    return (ring_a, ring_b), (a, b)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.bridge",
                                description=__doc__.split("\n")[0])
    p.add_argument("--pair", action="store_true",
                   help="two cross-wired nodes (software air) with a "
                        "bridge each; without it, one node + one bridge")
    p.add_argument("--sockets", action="store_true",
                   help="AF_UNIX datagram bridges instead of TAP "
                        "(unprivileged)")
    p.add_argument("--tap", default="sora",
                   help="TAP interface name prefix (default sora -> "
                        "sora0/sora1)")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--window", type=int, default=0,
                   help="0 = auto-size from --mtu at the air floor rate")
    p.add_argument("--mtu", type=int, default=1600,
                   help="max PSDU bytes carried over the air")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--selftest", action="store_true",
                   help="with --pair --sockets: push an echo through "
                        "A -> air -> B and back, then exit")
    p.add_argument("--device", default="cuda",
                   help="torch device of the nodes (default cuda)")
    args = p.parse_args(argv)
    if args.selftest and not (args.pair and args.sockets):
        p.error("--selftest needs --pair --sockets")

    from sora_tpu_torch.runtime.bridge import (PacketReflector,
                                               SocketBridge, TapBridge)

    rings, nodes = _mk_pair(args.window, args.batch, args.mtu, args.device)
    if not args.pair:
        nodes = nodes[:1]
    apps, refs = [], []
    try:
        for i, node in enumerate(nodes):
            if args.sockets:
                br, app = SocketBridge.pair()
                apps.append(app)
                _log(f"node {i}: socket bridge fd={app.fileno()}")
            else:
                br = TapBridge(f"{args.tap}{i}")
                _log(f"node {i}: tap {br.name} up "
                     f"(802.11 addr {node.cfg.addr.hex(':')})")
            refs.append(PacketReflector(node, br))
        t0 = time.perf_counter()
        for node in nodes:
            node.warm_up()
        _log(f"warm-up (kernel build, tables) in "
             f"{time.perf_counter() - t0:.1f}s on {nodes[0].device}")

        rng = np.random.default_rng(1)
        if args.selftest:
            apps[0].send(ADDR_B + ADDR_A + b"\x08\x00" + b"ping-over-the-air")
        t_end = time.perf_counter() + args.seconds
        echoed = False
        while time.perf_counter() < t_end:
            worked = False
            for ring in rings[: len(nodes)]:
                # idle-air clock so the CSMA FSM advances
                ring.write((rng.normal(size=2048) + 1j *
                            rng.normal(size=2048)
                            ).astype(np.complex64) * 0.01)
            for node, ref in zip(nodes, refs):
                worked |= bool(node.step())
                ref.step()
            if args.selftest and not echoed:
                apps[1].setblocking(False)
                try:
                    f = apps[1].recv(2048)
                except BlockingIOError:
                    f = b""
                if f:
                    _log(f"B received {len(f)}B ethernet frame; echoing")
                    apps[1].send(f[6:12] + f[:6] + f[12:])   # swap MACs
                    echoed = True
            if args.selftest and echoed:
                apps[0].setblocking(False)
                try:
                    f = apps[0].recv(2048)
                except BlockingIOError:
                    f = b""
                if f:
                    _log(f"A received echo ({len(f)}B) — selftest OK")
                    for node in nodes:
                        _log(node.report())
                    return 0
            if not worked:
                time.sleep(0.001)
    finally:
        for ref in refs:
            ref.bridge.close()
        for app in apps:
            app.close()
        for ring in rings:
            ring.close()
    for node in nodes:
        _log(node.report())
    if args.selftest:
        _log("selftest FAILED: echo did not complete")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
