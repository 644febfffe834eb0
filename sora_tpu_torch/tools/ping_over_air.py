"""Real ICMP over the software air: two kernel network namespaces ping
each other through the full PHY+MAC stack (port of the repository's
``tools/ping_over_air.py``).

The definitive Sora-as-a-NIC demonstration (SoraUGetTxPacket /
SoraUIndicateRxPacket): two live nodes are cross-wired (each TX feeds
the other's RX ring), each is bridged to a TAP interface, and the TAPs
are moved into separate network namespaces with addresses on one
subnet.  Traffic from one namespace then exercises the REAL kernel
stack end to end: ARP who-has broadcast -> modulate -> air -> decode ->
TAP -> kernel ARP reply -> air -> ... -> UDP echo + reply, all riding
802.11a frames through the CSMA/CA MAC.  The nodes run on ``--device``
(default cuda).

Needs root (TAP + netns); without it prints ``SKIP: needs root +
/dev/net/tun`` and exits 2, as the reference tool does.  It also needs
iproute2's ``ip`` command for the namespaces: without it, it prints
``SKIP: needs the ip command (iproute2)`` and exits 2.  Run::

    python3 -m sora_tpu_torch.tools.ping_over_air
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import numpy as np

NS_A, NS_B = "sora_ns_a", "sora_ns_b"
ADDR_A = b"\x02SORA0"
ADDR_B = b"\x02SORA1"


def _sh(*cmd, check=True):
    return subprocess.run(list(cmd), check=check, capture_output=True,
                          text=True)


def _mac(addr: bytes) -> str:
    return ":".join(f"{b:02x}" for b in addr)


def node_config(addr: bytes):
    """The NodeConfig of each node (the reference tool's).  Window and
    overlap auto-size from the REAL frame mix: MTU-sized frames at 24
    Mbps (span 11120 samples) -> overlap 11264, window 32768 —
    warning-free and boundary-safe; ACKs ride at 24 too so
    min_rate_mbps=24 is the true air floor."""
    from sora_tpu_torch.runtime.node import NodeConfig

    return NodeConfig(
        window=0, batch=2, overlap=0, max_psdu=1600, addr=addr,
        rate_mbps=None, data_rate=24, ack_rate=24, min_rate_mbps=24,
        ack_timeout_slots=250, backlog_hwm=1 << 22)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.tools.ping_over_air",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device of both nodes (default cuda)")
    args = p.parse_args(argv)
    if os.geteuid() != 0 or not os.path.exists("/dev/net/tun"):
        print("SKIP: needs root + /dev/net/tun")
        return 2
    if shutil.which("ip") is None:
        print("SKIP: needs the ip command (iproute2)")
        return 2

    from sora_tpu_torch.runtime.bridge import PacketReflector, TapBridge
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import StreamingNode, TxSink
    from sora_tpu_torch.util.xfer import resolve_device

    dev = resolve_device(args.device)
    ring_a = RxRing(capacity=1 << 22)
    ring_b = RxRing(capacity=1 << 22)
    node_a = StreamingNode(ring_a, node_config(ADDR_A),
                           tx_sink=TxSink(ring_b), device=dev)
    node_b = StreamingNode(ring_b, node_config(ADDR_B),
                           tx_sink=TxSink(ring_a), device=dev)
    br_a = TapBridge("sora0", up=False)
    br_b = TapBridge("sora1", up=False)
    ref_a = PacketReflector(node_a, br_a)
    ref_b = PacketReflector(node_b, br_b)
    print("building device programs ...", flush=True)
    node_a.warm_up()
    node_b.warm_up()

    for ns in (NS_A, NS_B):
        _sh("ip", "netns", "del", ns, check=False)
        _sh("ip", "netns", "add", ns)
    try:
        # the 802.11 address IS the interface MAC (identity EUI-48 map)
        for tap, addr, ns, ip in ((br_a.name, ADDR_A, NS_A, "10.77.0.1"),
                                  (br_b.name, ADDR_B, NS_B, "10.77.0.2")):
            _sh("ip", "link", "set", tap, "address", _mac(addr))
            _sh("ip", "link", "set", tap, "netns", ns)
            _sh("ip", "netns", "exec", ns, "ip", "addr", "add",
                f"{ip}/24", "dev", tap)
            _sh("ip", "netns", "exec", ns, "ip", "link", "set", tap, "up")
            _sh("ip", "netns", "exec", ns, "ip", "link", "set", "lo",
                "up")
            # cut kernel chatter (IPv6 ND/MLD) so the air carries only
            # the traffic under test
            _sh("ip", "netns", "exec", ns, "sysctl", "-qw",
                "net.ipv6.conf.all.disable_ipv6=1", check=False)

        # no ping binary in this image: kernel-UDP echo is the same
        # proof (ARP who-has -> air -> ARP reply -> air, then IP/UDP
        # both ways), driven by python processes inside each namespace.
        # The server echoes every datagram and the client sends again
        # every 2.5 s until a reply comes (150 s in all): a node that runs
        # slower than the air (a loaded CPU) can outlast the kernel's ARP
        # retries, which drop the datagram queued behind them.
        server = subprocess.Popen(
            ["ip", "netns", "exec", NS_B, sys.executable, "-c",
             "import socket\n"
             "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
             "s.bind(('10.77.0.2', 9999))\n"
             "while True:\n"
             "    d, a = s.recvfrom(2048)\n"
             "    s.sendto(b'echo:' + d, a)\n"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        time.sleep(0.5)
        client = subprocess.Popen(
            ["ip", "netns", "exec", NS_A, sys.executable, "-c",
             "import socket, time\n"
             "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
             "s.settimeout(2)\n"
             "s.bind(('10.77.0.1', 0))\n"
             "t_end = time.monotonic() + 150\n"
             "while True:\n"
             "    try:\n"
             "        s.sendto(b'ping-over-the-air', ('10.77.0.2', 9999))\n"
             "        d, a = s.recvfrom(2048)\n"
             "        break\n"
             "    except OSError:\n"
             "        if time.monotonic() > t_end:\n"
             "            raise\n"
             "        time.sleep(0.5)\n"
             "print('client got', d, 'from', a)\n"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        rng = np.random.default_rng(1)
        t_end = time.perf_counter() + 180.0
        while client.poll() is None and time.perf_counter() < t_end:
            for ring in (ring_a, ring_b):      # idle-air clock
                ring.write((rng.normal(size=2048)
                            + 1j * rng.normal(size=2048)
                            ).astype(np.complex64) * 0.01)
            for node, ref in ((node_a, ref_a), (node_b, ref_b)):
                node.step()
                ref.step()
        for proc in (client, server):
            if proc.poll() is None:
                proc.kill()
        out, _ = client.communicate()
        print(out)
        print(f"A: {node_a.stats.frame_ok} rx frames, "
              f"{node_a.stats.tx_data} tx; "
              f"B: {node_b.stats.frame_ok} rx, {node_b.stats.tx_data} tx;"
              f" reflected A->host {ref_a.pkts_in} host->A "
              f"{ref_a.pkts_out}, B->host {ref_b.pkts_in} host->B "
              f"{ref_b.pkts_out}")
        ok = (client.returncode == 0
              and "echo:ping-over-the-air" in out)
        print("udp-echo-over-air", "OK" if ok else "FAILED")
        return 0 if ok else 1
    finally:
        for ns in (NS_A, NS_B):
            _sh("ip", "netns", "del", ns, check=False)
        for ring in (ring_a, ring_b):
            ring.close()


if __name__ == "__main__":
    sys.exit(main())
