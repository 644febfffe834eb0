"""802.11 MAC frame helpers: FCS and data-frame build (numpy/zlib; the
port's own copy of the parts of ``sora_tpu.mac.frame`` the receiver and
its tests need).

Functional equivalent of the reference's frame handling in
``kernel/bb/umxsdrbrick/mac.cpp`` (CRC32 check in TBB11aFrameSink,
PHY_11a.hpp:607-702) and the CRC tables of ``kernel/core/inc/CRC32.h``.
"""

from __future__ import annotations

import struct
import zlib

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


def append_fcs(mpdu: bytes) -> bytes:
    return mpdu + struct.pack("<I", fcs32(mpdu))


def check_fcs(psdu: bytes) -> bool:
    return len(psdu) >= 4 and fcs32(psdu[:-4]) == struct.unpack(
        "<I", psdu[-4:])[0]


def build_data_frame(payload: bytes, seq: int = 0) -> bytes:
    """MAC header + payload + FCS -> PSDU ready for the modulator.  The
    header is a broadcast data frame (frame control 0x0008, addr1
    ff:ff:ff:ff:ff:ff, addr2 = addr3 = 02:00:00:00:00:00)."""
    hdr = struct.pack("<HH", 0x0008, 0) + b"\xff" * 6 + \
        (b"\x02" + b"\x00" * 5) * 2 + struct.pack("<H", seq << 4)
    return append_fcs(hdr + payload)
