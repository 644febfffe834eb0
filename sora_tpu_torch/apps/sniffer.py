"""Promiscuous 802.11 sniffer — the umxsniffer analogue (port of
``sora_tpu.apps.sniffer``).

The reference's umxsniffer (kernel/bb/umxsniffer/) is the umxsdrbrick
node with the MAC's address filter dropped: every frame that decodes with
a good FCS is logged (mac.cpp:183,447 — ProcessDot11Frame on everything).
Here a phy "a" ``StreamingNode`` runs in ``promiscuous`` mode and taps
per-frame metadata (rate, SNR, CFO, stream position) through its
``on_frame`` hook — what the reference exposes through the demod context
facades (CF_11aRxVector).  It adds a per-frame table (time, type/subtype
name, addresses, seq, rate, SNR), a frame-type histogram with the
err_stat status page at exit, and pcap output (linktype 105 =
IEEE802_11).

Run::

    python -m sora_tpu_torch.apps.sniffer --synthetic 32 --mixed \\
        --pcap cap.pcap
    python -m sora_tpu_torch.apps.sniffer --dump tests/data/fsample54.dmp \\
        --seconds 3

``--device cpu`` runs the node on the CPU (the default is cuda).
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
from collections import Counter

import numpy as np

from sora_tpu_torch.mac import mgmt
from sora_tpu_torch.mac.frame import MacHeader

# -- pcap ---------------------------------------------------------------------

_PCAP_MAGIC = 0xA1B2C3D4
_LINKTYPE_IEEE802_11 = 105


class PcapWriter:
    """Minimal classic-pcap writer, linktype IEEE802_11 (frames are raw
    MPDUs incl. FCS, exactly what the RX chain hands the MAC)."""

    def __init__(self, path: str, snaplen: int = 4096):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<IHHiIII", _PCAP_MAGIC, 2, 4, 0, 0,
                                  snaplen, _LINKTYPE_IEEE802_11))
        self.n = 0

    def write(self, psdu: bytes, ts: float) -> None:
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        self._f.write(struct.pack("<IIII", sec, usec, len(psdu),
                                  len(psdu)))
        self._f.write(psdu)
        self.n += 1

    def close(self) -> None:
        self._f.close()


def read_pcap(path: str) -> list[tuple[float, bytes]]:
    """Parse a classic pcap back into [(timestamp, frame)]."""
    with open(path, "rb") as f:
        hdr = f.read(24)
        magic, _, _, _, _, _, link = struct.unpack("<IHHiIII", hdr)
        if magic != _PCAP_MAGIC or link != _LINKTYPE_IEEE802_11:
            raise ValueError("not an 802.11 classic pcap")
        out = []
        while True:
            rec = f.read(16)
            if len(rec) < 16:
                break
            sec, usec, caplen, _ = struct.unpack("<IIII", rec)
            out.append((sec + usec * 1e-6, f.read(caplen)))
        return out


# -- frame table --------------------------------------------------------------


def _mac_str(a: bytes) -> str:
    return ":".join(f"{b:02x}" for b in a)


def format_frame(meta: dict, sample_rate: float) -> str:
    """One table line per frame (the sniffer's console output)."""
    psdu = meta["psdu"]
    t_ms = meta["pos"] / sample_rate * 1e3
    fc = struct.unpack("<H", psdu[:2])[0] if len(psdu) >= 2 else 0
    name = mgmt.fc_name(fc)
    retry = "R" if fc & 0x0800 else " "
    if len(psdu) >= 24:
        hdr = MacHeader.unpack(psdu[:24])
        src, dst = _mac_str(hdr.addr2), _mac_str(hdr.addr1)
        seq = hdr.seq_ctrl >> 4
    elif len(psdu) >= 10:                      # ACK/CTS: RA only
        src, dst, seq = "-", _mac_str(psdu[4:10]), -1
    else:
        src, dst, seq = "-", "-", -1
    rate = meta.get("rate_mbps")
    snr = meta.get("snr_db")
    return (f"{t_ms:9.3f}ms {name:<11s}{retry} {src} > {dst} "
            f"seq={seq:4d} len={len(psdu):4d}"
            + (f" {rate:4.1f}M" if rate is not None else "")
            + (f" snr={snr:4.1f}dB" if snr is not None else ""))


class Sniffer:
    """Promiscuous capture session over one RX ring.

    Wraps a StreamingNode (promiscuous, no ACKs) on ``device`` (default
    cuda) and accumulates a frame-type histogram, console lines, and an
    optional pcap."""

    def __init__(self, ring, cfg=None, pcap_path: str | None = None,
                 out=None, device=None):
        from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode

        cfg = cfg or NodeConfig()
        cfg.promiscuous = True
        self.cfg = cfg
        self.hist: Counter = Counter()
        self.frames: list[dict] = []
        self.out = out
        self._t0 = time.time()
        self.node = StreamingNode(ring, cfg, on_frame=self._on_frame,
                                  device=device)
        self.pcap = PcapWriter(pcap_path) if pcap_path else None

    def _on_frame(self, meta: dict) -> None:
        psdu = meta["psdu"]
        fc = struct.unpack("<H", psdu[:2])[0] if len(psdu) >= 2 else 0
        self.hist[mgmt.fc_name(fc)] += 1
        self.frames.append(meta)
        if self.pcap is not None:
            ts = self._t0 + meta["pos"] / self.cfg.sample_rate_sps
            self.pcap.write(psdu, ts)
        if self.out is not None:
            print(format_frame(meta, self.cfg.sample_rate_sps),
                  file=self.out, flush=True)

    def summary(self) -> str:
        lines = ["-- sniffer frame types -----------------------"]
        for name, n in self.hist.most_common():
            lines.append(f" {name:<12s} {n:8d}")
        lines.append(self.node.stats.status_page())
        return "\n".join(lines)

    def close(self) -> None:
        if self.pcap is not None:
            self.pcap.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.sniffer",
                                description=__doc__.split("\n")[0])
    p.add_argument("--dump", help="replay a Sora dump file into the ring")
    p.add_argument("--synthetic", type=int, metavar="N", default=0,
                   help="generate N synthetic frames instead")
    p.add_argument("--mixed", action="store_true",
                   help="synthetic traffic cycles all 8 rates")
    p.add_argument("--rate", type=int, default=6)
    p.add_argument("--msps", type=int, default=40, choices=(20, 40))
    p.add_argument("--pace", type=float, default=0.0,
                   help="producer pacing in samples/s (0 = unpaced)")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--pcap", default=None, help="write frames to a pcap")
    p.add_argument("--device", default=None,
                   help="torch device of the node (default cuda)")
    args = p.parse_args(argv)

    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.runtime.native import RxRing, parse_dump
    from sora_tpu_torch.runtime.node import NodeConfig
    from sora_tpu_torch.util.xfer import I16_SCALE, resolve_device

    dev = resolve_device(args.device)
    if args.dump:
        # the dump holds ADC counts; the int16 wire carries counts at
        # I16_SCALE per unit, so the replay is in the wire's units (the
        # JAX app replays raw counts, which the AGC's 1/64 gain floor
        # cannot bring inside the wire: a 14-bit 54 Mbps capture clips)
        src = parse_dump(args.dump) / np.float32(I16_SCALE)
        input_rate = "40m" if args.msps == 40 else "20m"
        rate_sps = args.pace or float(args.msps) * 1e6
        # Clamp the window: a multi-second capture must stream through
        # overlapping windows (like apps/node.py), not become one
        # multi-megasample batch that exhausts device memory.  2^18
        # samples (6.5 ms @ 40 Msps) holds any <= 1600-byte frame even
        # at 6 Mbps, and the half-window overlap guarantees every frame
        # lands whole in some window.
        window = min(1 << int(np.ceil(np.log2(len(src) + 4096))), 1 << 18)
        overlap = (window // 2 if window == 1 << 18
                   else min(len(src) + 2048, window - window // 8))
        cfg = NodeConfig(window=window, overlap=overlap,
                         batch=4, input_rate=input_rate,
                         sample_rate_sps=rate_sps)
        loop = True
    else:
        if not args.synthetic:
            p.error("need --dump or --synthetic N")
        src = synthetic_traffic(args.synthetic, b"\x02SORA1", args.mixed,
                                args.rate, device=dev)
        rate_sps = args.pace
        cfg = NodeConfig(window=8192, batch=8, overlap=5120, max_psdu=256,
                         sample_rate_sps=rate_sps or 20e6)
        loop = False

    ring = RxRing(capacity=1 << 22)
    sniffer = Sniffer(ring, cfg, pcap_path=args.pcap, out=sys.stdout,
                      device=dev)
    print("warming up the device programs ...", file=sys.stderr, flush=True)
    sniffer.node.warm_up()
    ring.start_replay(src, rate_sps=rate_sps, loop=loop)
    t_end = time.perf_counter() + args.seconds
    try:
        while time.perf_counter() < t_end:
            if not sniffer.node.step():
                time.sleep(0.001)
    finally:
        ring.stop()
    sniffer.node.flush()
    print(sniffer.summary())
    if sniffer.pcap is not None:
        print(f"pcap: {sniffer.pcap.n} frames -> {args.pcap}")
    sniffer.close()
    ring.close()
    return 0 if sum(sniffer.hist.values()) > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
