"""802.11 MAC frame helpers: FCS, header build/parse (numpy/struct/zlib;
the benchmark's frozen copy of ``sora_tpu_torch/mac/frame.py``).

Functional equivalent of the reference's frame handling in
``kernel/bb/umxsdrbrick/mac.cpp`` (CRC32 check in TBB11aFrameSink,
PHY_11a.hpp:607-702) and the CRC tables of ``kernel/core/inc/CRC32.h``.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np


def fcs32(data: bytes) -> int:
    """IEEE CRC-32 as used for the 802.11 FCS (appended little-endian)."""
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def crc32_table() -> np.ndarray:
    """Byte-wise CRC-32 table (reflected 0xEDB88320), for vectorized use."""
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if (c & 1) else 0)
        t[i] = c
    return t


_CRC32_TABLE = crc32_table()


def fcs32_np(data: np.ndarray) -> int:
    """Table-driven CRC-32 over a uint8 array (oracle for the device CRC)."""
    crc = np.uint32(0xFFFFFFFF)
    for b in np.asarray(data, dtype=np.uint8):
        crc = _CRC32_TABLE[(crc ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def append_fcs(mpdu: bytes) -> bytes:
    return mpdu + struct.pack("<I", fcs32(mpdu))


def check_fcs(psdu: bytes) -> bool:
    return len(psdu) >= 4 and fcs32(psdu[:-4]) == struct.unpack(
        "<I", psdu[-4:])[0]


@dataclass
class MacHeader:
    frame_control: int = 0x0008       # data frame
    duration: int = 0
    addr1: bytes = b"\xff" * 6
    addr2: bytes = b"\x02" + b"\x00" * 5
    addr3: bytes = b"\x02" + b"\x00" * 5
    seq_ctrl: int = 0

    def pack(self) -> bytes:
        return struct.pack("<HH", self.frame_control, self.duration) + \
            self.addr1 + self.addr2 + self.addr3 + \
            struct.pack("<H", self.seq_ctrl)

    @classmethod
    def unpack(cls, b: bytes) -> "MacHeader":
        fc, dur = struct.unpack("<HH", b[:4])
        return cls(fc, dur, b[4:10], b[10:16], b[16:22],
                   struct.unpack("<H", b[22:24])[0])


def build_data_frame(payload: bytes, seq: int = 0) -> bytes:
    """MAC header + payload + FCS -> PSDU ready for the modulator.  The
    header is a broadcast data frame (frame control 0x0008, addr1
    ff:ff:ff:ff:ff:ff, addr2 = addr3 = 02:00:00:00:00:00)."""
    hdr = MacHeader(seq_ctrl=seq << 4)
    return append_fcs(hdr.pack() + payload)


def build_ack_frame(addr1: bytes) -> bytes:
    """The ACK control frame the reference pre-modulates into its signal
    cache (kernel/core/src/_signal_cache.c; mac.cpp ACK path)."""
    body = struct.pack("<HH", 0x00D4, 0) + addr1
    return append_fcs(body)
