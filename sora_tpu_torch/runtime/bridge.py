"""OS packet reflection: bridge a StreamingNode to the host network stack.
(The port's own copy of ``sora_tpu.runtime.bridge``.)

This is what made Sora a real NIC: the reference pulls TX packets from the
OS via NDIS (`SoraUEnableGetTxPacket`,
kernel/bb/umxsdrbrick/dot11main.cpp:413) and indicates decoded RX frames
back into the network stack (`SoraUIndicateRxPacket`,
kernel/bb/umxsdrbrick/mac.cpp:900; command set
kernel/core/inc/_user_mode_ext.h:20-58).  The node lives in userspace,
so the equivalent attachment point is a **TAP device**: the kernel hands us
raw ethernet frames written to the interface, and frames we write appear
to the host as received packets — any application (ping, sockets, DHCP)
runs over the software air unmodified.

Two endpoints with one interface (``fileno/read_frames/write_frame``):

* :class:`TapBridge` — a real L2 kernel interface (needs CAP_NET_ADMIN /
  root and /dev/net/tun).
* :class:`SocketBridge` — an unprivileged AF_UNIX datagram pair carrying
  whole ethernet frames; the far socket plays the application.

:class:`PacketReflector` runs the GetTxPacket/IndicateRxPacket loop
against a node: outbound ethernet frames become ``node.send`` payloads
addressed by their ethernet destination MAC (ethernet MACs and 802.11
addresses share the EUI-48 space, so the mapping is the identity — the
same convention the reference's packet path uses), and decoded data
payloads write back out.
"""

from __future__ import annotations

import os
import select
import socket
import struct

ETH_BROADCAST = b"\xff" * 6
ETH_HDR = 14                      # dst(6) + src(6) + ethertype(2)
ETH_MTU = 1514                    # header + 1500 payload


class TapBridge:
    """A TAP (L2) kernel interface.  Frames the host routes to the
    interface arrive via :meth:`read_frames`; :meth:`write_frame`
    indicates a frame to the host as received."""

    _TUNSETIFF = 0x400454CA
    _IFF_TAP = 0x0002
    _IFF_NO_PI = 0x1000

    def __init__(self, name: str = "sora0", up: bool = True):
        import fcntl

        self.drops = 0            # frames dropped on a full device queue
        self.fd = os.open("/dev/net/tun", os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH22x", name.encode(),
                          self._IFF_TAP | self._IFF_NO_PI)
        got = fcntl.ioctl(self.fd, self._TUNSETIFF, ifr)
        self.name = struct.unpack("16sH22x", got)[0].rstrip(b"\0").decode()
        if up:
            import subprocess
            subprocess.run(["ip", "link", "set", self.name, "up"],
                           check=False, capture_output=True)

    def fileno(self) -> int:
        return self.fd

    def read_frames(self, max_frames: int = 64) -> list[bytes]:
        out = []
        for _ in range(max_frames):
            try:
                f = os.read(self.fd, ETH_MTU + 4)
            except BlockingIOError:
                break
            if f:
                out.append(f)
        return out

    def write_frame(self, frame: bytes) -> None:
        try:
            os.write(self.fd, frame)
        except BlockingIOError:
            # device queue full (O_NONBLOCK tap): drop, as a NIC
            # indicating into a saturated stack does — matching
            # SocketBridge semantics instead of killing the node's
            # poll loop (ADVICE r04)
            self.drops += 1
        except OSError as e:
            import errno
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK,
                           errno.ENOBUFS):
                self.drops += 1       # transient backpressure: drop
            else:
                raise                 # dead fd / bad frame: surface it

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class SocketBridge:
    """Unprivileged fallback: one end of an AF_UNIX SOCK_DGRAM pair, each
    datagram one whole ethernet frame.  :meth:`pair` returns (bridge,
    application socket) — the far socket stands in for the OS stack."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sock.setblocking(False)

    @classmethod
    def pair(cls) -> tuple["SocketBridge", socket.socket]:
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
        return cls(a), b

    def fileno(self) -> int:
        return self.sock.fileno()

    def read_frames(self, max_frames: int = 64) -> list[bytes]:
        out = []
        for _ in range(max_frames):
            try:
                f = self.sock.recv(ETH_MTU + 4)
            except BlockingIOError:
                break
            if f:
                out.append(f)
        return out

    def write_frame(self, frame: bytes) -> None:
        try:
            self.sock.send(frame)
        except (BlockingIOError, BrokenPipeError, ConnectionRefusedError):
            pass                   # application not draining: drop, as a
            #                        NIC indicating into a full stack does

    def close(self) -> None:
        self.sock.close()


class PacketReflector:
    """The GetTxPacket / IndicateRxPacket loop against one node.

    Outbound (host -> air): every ethernet frame read from the bridge is
    queued via ``node.send(frame, dst=eth_dst)`` — the whole ethernet
    frame is the 802.11 payload, the ethernet destination MAC is the
    802.11 receiver address (identity EUI-48 mapping), broadcast stays
    broadcast.  Inbound (air -> host): decoded data payloads addressed to
    this node are written back out as received ethernet frames.

    Call :meth:`step` in the node poll loop (after ``node.step()``).
    """

    def __init__(self, node, bridge, rate: float | None = None):
        self.node = node
        self.bridge = bridge
        self.rate = rate
        self.pkts_out = 0          # host -> air (GetTxPacket side)
        self.pkts_in = 0           # air -> host (IndicateRxPacket side)
        self.short_dropped = 0
        self._chain = node.on_payload
        node.on_payload = self._indicate

    def _indicate(self, src: bytes, payload: bytes) -> None:
        if len(payload) >= ETH_HDR:
            self.bridge.write_frame(payload)
            self.pkts_in += 1
        if self._chain is not None:
            self._chain(src, payload)

    def step(self, max_frames: int = 64) -> int:
        """Drain outbound frames from the bridge into the node's TX
        queue.  Returns the number of frames queued."""
        n = 0
        for frame in self.bridge.read_frames(max_frames):
            if len(frame) < ETH_HDR:
                self.short_dropped += 1
                continue
            dst = frame[:6]
            self.node.send(bytes(frame), dst, rate=self.rate)
            n += 1
        self.pkts_out += n
        return n

    def wait_readable(self, timeout: float = 0.0) -> bool:
        r, _, _ = select.select([self.bridge], [], [], timeout)
        return bool(r)

    def detach(self) -> None:
        self.node.on_payload = self._chain
