"""Tracing / plotting channels — the DbgPlot analogue.
(The port's own copy of ``sora_tpu.util.trace``: the file format is
the same byte for byte, so a trace written by either package reads
back in the other.)

The reference streams named channels over shared memory to an external
viewer GUI (DebugTool/source/DebugPlotU/DebugPlotU.h:19-72: PlotLine /
PlotDots (constellation) / PlotSpectrum / PlotText / Log, lock-free
writers).  Here each trace session is one mmap-backed file of fixed-size
ring buffers: writers are in-process and allocation-free after setup; any
other process can attach a TraceReader to the same path and poll — the
same producer/viewer decoupling, file-backed instead of Windows shm.

Record kinds:
  line      float32[width]    PlotLine   (scalar series, one row per call)
  spectrum  float32[width]    PlotSpectrum (dB bins)
  dots      complex64[width]  PlotDots   (constellation points)
  text      bytes[120]        PlotText / Log
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass

import numpy as np

_MAGIC = 0x5042_4744                      # 'DGBP'
_NAME_LEN = 32
_KINDS = {"line": 0, "spectrum": 1, "dots": 2, "text": 3}
_KIND_NAMES = {v: k for k, v in _KINDS.items()}
_HDR = struct.Struct("<II")               # magic, nchannels
_CHDR = struct.Struct("<32sIIIQQ")        # name, kind, width, capacity,
#                                           write_count, data_offset
_TEXT_W = 120


def _itemsize(kind: int, width: int) -> int:
    if kind == _KINDS["dots"]:
        return 8 * width
    if kind == _KINDS["text"]:
        return _TEXT_W
    return 4 * width


@dataclass
class _Chan:
    name: str
    kind: int
    width: int
    capacity: int
    hdr_off: int
    data_off: int
    count: int = 0


class TraceWriter:
    """Single-writer trace session.

    channels: {name: (kind, width, capacity)}; e.g.
    {"rx_constellation": ("dots", 48, 256), "mac": ("text", 0, 64)}.
    """

    def __init__(self, path: str, channels: dict):
        self.path = path
        self._chans: dict[str, _Chan] = {}
        off = _HDR.size + len(channels) * _CHDR.size
        metas = []
        for name, (kind, width, cap) in channels.items():
            k = _KINDS[kind]
            w = width if k != _KINDS["text"] else _TEXT_W
            c = _Chan(name, k, w, cap, 0, off)
            off += _itemsize(k, w) * cap
            metas.append(c)
            self._chans[name] = c
        with open(path, "wb") as f:
            f.truncate(off)
        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), off)
        self._mm[:_HDR.size] = _HDR.pack(_MAGIC, len(metas))
        pos = _HDR.size
        for c in metas:
            c.hdr_off = pos
            self._flush_chdr(c)
            pos += _CHDR.size

    def _flush_chdr(self, c: _Chan) -> None:
        self._mm[c.hdr_off: c.hdr_off + _CHDR.size] = _CHDR.pack(
            c.name.encode()[:_NAME_LEN], c.kind, c.width, c.capacity,
            c.count, c.data_off)

    def _append(self, name: str, payload: bytes) -> None:
        c = self._chans[name]
        slot = c.count % c.capacity
        item = _itemsize(c.kind, c.width)
        start = c.data_off + slot * item
        self._mm[start: start + len(payload)] = payload
        c.count += 1
        self._flush_chdr(c)

    # -- the DebugPlotU-compatible API -----------------------------------------

    def plot_line(self, name: str, values) -> None:
        v = np.asarray(values, dtype=np.float32).reshape(-1)
        c = self._chans[name]
        v = np.pad(v[: c.width], (0, max(0, c.width - len(v))))
        self._append(name, v.tobytes())

    plot_spectrum = plot_line

    def plot_dots(self, name: str, points) -> None:
        v = np.asarray(points, dtype=np.complex64).reshape(-1)
        c = self._chans[name]
        v = np.pad(v[: c.width], (0, max(0, c.width - len(v))))
        self._append(name, v.tobytes())

    def plot_text(self, name: str, msg: str) -> None:
        b = msg.encode(errors="replace")[:_TEXT_W]
        self._append(name, b + b"\x00" * (_TEXT_W - len(b)))

    log = plot_text

    def close(self) -> None:
        self._mm.flush()
        self._mm.close()
        self._f.close()


class TraceReader:
    """Attach to a trace file (possibly while it is being written) and
    snapshot channel contents — the DebugPlotViewer data path."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, n = _HDR.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a sora_tpu trace file")
        self.channels: dict[str, _Chan] = {}
        for i in range(n):
            raw = _CHDR.unpack_from(self._mm, _HDR.size + i * _CHDR.size)
            name = raw[0].split(b"\x00")[0].decode()
            self.channels[name] = _Chan(name, raw[1], raw[2], raw[3],
                                        _HDR.size + i * _CHDR.size, raw[5],
                                        raw[4])

    def _refresh(self, c: _Chan) -> None:
        raw = _CHDR.unpack_from(self._mm, c.hdr_off)
        c.count = raw[4]

    def read(self, name: str):
        """All retained records of a channel, oldest first.  Numeric kinds
        return an (n, width) array; text returns a list of strings."""
        c = self.channels[name]
        self._refresh(c)
        n = min(c.count, c.capacity)
        first = c.count - n
        item = _itemsize(c.kind, c.width)
        rows = []
        for i in range(first, c.count):
            slot = i % c.capacity
            start = c.data_off + slot * item
            rows.append(self._mm[start: start + item])
        if c.kind == _KINDS["text"]:
            return [r.split(b"\x00")[0].decode(errors="replace")
                    for r in rows]
        dt = np.complex64 if c.kind == _KINDS["dots"] else np.float32
        if not rows:
            return np.zeros((0, c.width), dt)
        return np.frombuffer(b"".join(rows), dt).reshape(n, c.width)

    def kind(self, name: str) -> str:
        return _KIND_NAMES[self.channels[name].kind]

    def close(self) -> None:
        self._mm.close()
        self._f.close()
