"""802.11 management frames: beacon / auth / assoc build + parse.
(The port's own copy of ``sora_tpu.mac.mgmt``.)

Functional equivalent of the reference's management plane
(kernel/bb/umxsdrbrick/mgmt.cpp, mgmt.h:17-83): a minimal BSS — beacons
with SSID + supported-rates IEs, open-system authentication, association
request/response — enough for two sora_tpu nodes to form a link the way
umxsdrbrick nodes do.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from sora_tpu_torch.mac.frame import MacHeader, append_fcs

# frame_control values (type/subtype in bits 2-7, little-endian field)
FC_BEACON = 0x0080
FC_AUTH = 0x00B0
FC_ASSOC_REQ = 0x0000
FC_ASSOC_RESP = 0x0010
FC_DATA = 0x0008
FC_ACK = 0x00D4

_IE_SSID = 0
_IE_RATES = 1

DEFAULT_RATES = (6, 9, 12, 18, 24, 36, 48, 54)


def _ie(tag: int, body: bytes) -> bytes:
    return struct.pack("<BB", tag, len(body)) + body


def _rates_ie(rates_mbps) -> bytes:
    return _ie(_IE_RATES, bytes((int(r * 2) & 0x7F) for r in rates_mbps))


def _parse_ies(b: bytes) -> dict[int, bytes]:
    out, i = {}, 0
    while i + 2 <= len(b):
        tag, ln = b[i], b[i + 1]
        out[tag] = b[i + 2: i + 2 + ln]
        i += 2 + ln
    return out


@dataclass
class Bss:
    ssid: str = "sora-tpu"
    bssid: bytes = b"\x02SORA0"
    beacon_interval_tu: int = 100
    rates_mbps: tuple = DEFAULT_RATES
    capability: int = 0x0001          # ESS


def build_beacon(bss: Bss, timestamp_us: int = 0, seq: int = 0) -> bytes:
    hdr = MacHeader(frame_control=FC_BEACON, addr1=b"\xff" * 6,
                    addr2=bss.bssid, addr3=bss.bssid, seq_ctrl=seq << 4)
    body = struct.pack("<QHH", timestamp_us, bss.beacon_interval_tu,
                       bss.capability)
    body += _ie(_IE_SSID, bss.ssid.encode()) + _rates_ie(bss.rates_mbps)
    return append_fcs(hdr.pack() + body)


def parse_beacon(psdu: bytes) -> Bss | None:
    if len(psdu) < 24 + 12 + 4:
        return None
    hdr = MacHeader.unpack(psdu[:24])
    if hdr.frame_control & 0x00FC != FC_BEACON:
        return None
    ts, interval, cap = struct.unpack("<QHH", psdu[24:36])
    ies = _parse_ies(psdu[36:-4])
    rates = tuple((r & 0x7F) / 2 for r in ies.get(_IE_RATES, b""))
    return Bss(ssid=ies.get(_IE_SSID, b"").decode(errors="replace"),
               bssid=hdr.addr2, beacon_interval_tu=interval,
               rates_mbps=rates, capability=cap)


def build_auth(src: bytes, bssid: bytes, seq_num: int, status: int = 0,
               seq: int = 0) -> bytes:
    hdr = MacHeader(frame_control=FC_AUTH, addr1=bssid, addr2=src,
                    addr3=bssid, seq_ctrl=seq << 4)
    # open system (alg 0), transaction seq, status
    return append_fcs(hdr.pack() + struct.pack("<HHH", 0, seq_num, status))


def parse_auth(psdu: bytes):
    """-> (src, transaction_seq, status) or None."""
    if len(psdu) < 24 + 6 + 4:
        return None
    hdr = MacHeader.unpack(psdu[:24])
    if hdr.frame_control & 0x00FC != FC_AUTH:
        return None
    alg, seq_num, status = struct.unpack("<HHH", psdu[24:30])
    return hdr.addr2, seq_num, status


def build_assoc_req(src: bytes, bss: Bss, seq: int = 0) -> bytes:
    hdr = MacHeader(frame_control=FC_ASSOC_REQ, addr1=bss.bssid, addr2=src,
                    addr3=bss.bssid, seq_ctrl=seq << 4)
    body = struct.pack("<HH", bss.capability, 10)   # cap, listen interval
    body += _ie(_IE_SSID, bss.ssid.encode()) + _rates_ie(bss.rates_mbps)
    return append_fcs(hdr.pack() + body)


def build_assoc_resp(dst: bytes, bss: Bss, aid: int, status: int = 0,
                     seq: int = 0) -> bytes:
    hdr = MacHeader(frame_control=FC_ASSOC_RESP, addr1=dst, addr2=bss.bssid,
                    addr3=bss.bssid, seq_ctrl=seq << 4)
    body = struct.pack("<HHH", bss.capability, status, 0xC000 | aid)
    body += _rates_ie(bss.rates_mbps)
    return append_fcs(hdr.pack() + body)


def parse_assoc_resp(psdu: bytes):
    """-> (status, aid) or None."""
    if len(psdu) < 24 + 6 + 4:
        return None
    hdr = MacHeader.unpack(psdu[:24])
    if hdr.frame_control & 0x00FC != FC_ASSOC_RESP:
        return None
    cap, status, aid = struct.unpack("<HHH", psdu[24:30])
    return status, aid & 0x3FFF


def frame_type(psdu: bytes) -> int:
    """type/subtype bits of a PSDU's frame control (masking flags)."""
    if len(psdu) < 2:
        return -1
    return struct.unpack("<H", psdu[:2])[0] & 0x00FC


# type (bits 2-3) / subtype (bits 4-7) display names — the sniffer's frame
# table vocabulary (umxsniffer prints the same taxonomy)
_TYPE_NAMES = {0: "mgmt", 1: "ctrl", 2: "data", 3: "ext"}
_SUBTYPE_NAMES = {
    (0, 0): "assoc-req", (0, 1): "assoc-resp", (0, 4): "probe-req",
    (0, 5): "probe-resp", (0, 8): "beacon", (0, 10): "disassoc",
    (0, 11): "auth", (0, 12): "deauth",
    (1, 11): "rts", (1, 12): "cts", (1, 13): "ack",
    (2, 0): "data", (2, 4): "null",
}


def fc_name(frame_control: int) -> str:
    """Human-readable type/subtype of a frame_control value."""
    t = (frame_control >> 2) & 0x3
    st = (frame_control >> 4) & 0xF
    return _SUBTYPE_NAMES.get((t, st),
                              f"{_TYPE_NAMES.get(t, '?')}-st{st}")
