"""ctypes bindings for the native host runtime, ``csrc/sora_host.cpp``
(port of ``sora_tpu.runtime.native``; the C++ file is the port's own copy).

The C++ library implements the reference's user-mode runtime analogues:
dump parsing (brickutil.h), the RX sample ring with scan-pointer reads and
VStream multi-reader semantics (_rx_stream.h / _rx_manager.h), a paced
replay producer thread, and monotonic timing (soratime.h).

:func:`load` compiles the library with g++ at first use into
``_build/libsora_host_torch.so`` (rebuilt when the source is newer) and
memoizes the handle; importing this module builds nothing, and a missing
compiler raises.  The library has a file name of its own, so a process
can load it beside the JAX package's ring library.  The ring has no
Python fallback: it exists to take the feed path out of Python.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from sora_tpu_torch.util.xfer import I16_SCALE

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sora_host.cpp"
LIBRARY = _PKG / "_build" / "libsora_host_torch.so"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra", "-shared")
_lib = None


def build(force: bool = False) -> str:
    """Compile csrc/sora_host.cpp into _build/libsora_host_torch.so when
    the library is missing or older than the source (or ``force``).
    Returns the compiler's output ("" when the library was current).
    Raises when g++ is missing or fails."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return ""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("sora_tpu_torch: g++ not found; the native ring "
                           f"({SOURCE}) cannot be built")
    LIBRARY.parent.mkdir(exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)          # atomic: concurrent builds stay safe
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.sora_parse_dump.restype = ctypes.c_long
    lib.sora_parse_dump.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.sora_ring_create.restype = ctypes.c_void_p
    lib.sora_ring_create.argtypes = [ctypes.c_long]
    lib.sora_ring_alloc_vstream.restype = ctypes.c_int
    lib.sora_ring_alloc_vstream.argtypes = [ctypes.c_void_p]
    lib.sora_ring_write.restype = None
    lib.sora_ring_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.sora_ring_read.restype = ctypes.c_long
    lib.sora_ring_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long]
    lib.sora_ring_available.restype = ctypes.c_long
    lib.sora_ring_available.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sora_ring_read_windows_i16.restype = ctypes.c_long
    lib.sora_ring_read_windows_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_float, ctypes.POINTER(ctypes.c_int16)]
    lib.sora_ring_read_windows_i8.restype = ctypes.c_long
    lib.sora_ring_read_windows_i8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_float, ctypes.POINTER(ctypes.c_int8)]
    lib.sora_ring_drops.restype = ctypes.c_long
    lib.sora_ring_drops.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sora_ring_start_replay.restype = None
    lib.sora_ring_start_replay.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_double, ctypes.c_int]
    lib.sora_ring_stop.restype = None
    lib.sora_ring_stop.argtypes = [ctypes.c_void_p]
    lib.sora_ring_destroy.restype = None
    lib.sora_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.sora_monotonic_ns.restype = ctypes.c_double
    lib.sora_monotonic_ns.argtypes = []
    _lib = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def parse_dump(path: str, sign_extend_14bit: bool = True) -> np.ndarray:
    """Native dump loader; returns complex64 samples (same semantics as
    ``io.dumpfile.load_dump``)."""
    lib = load()
    raw = np.fromfile(path, dtype=np.uint8)
    nblocks = len(raw) // 128
    out = np.empty(nblocks * 28 * 2, dtype=np.float32)
    n = lib.sora_parse_dump(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw),
        1 if sign_extend_14bit else 0, _fptr(out))
    return out[: 2 * n].view(np.complex64)


def replay_samples(path: str, sign_extend_14bit: bool = True) -> np.ndarray:
    """A dump's samples in the sample wire's units, for replay into a ring.

    A dump holds ADC counts; the node's int16 wire carries ``I16_SCALE``
    counts per unit, so a ring fed raw counts clips at the wire even at
    the AGC's 1/64 gain floor (a 14-bit 54 Mbps capture then fails the
    CRC).  The JAX package replays raw counts; the node app, the sniffer
    and ``sdl.Radio.replay`` replay through this function instead."""
    return parse_dump(path, sign_extend_14bit) / np.float32(I16_SCALE)


class RxRing:
    """Sample ring fed by a native producer thread.

    The host-side analogue of SORA_RADIO_RX_STREAM: `read` polls the scan
    pointer and returns a batch of new samples; multiple vstream readers
    consume the same ring independently (SoraAllocateVStream,
    _rx_manager.h:185-188)."""

    def __init__(self, capacity: int = 1 << 20):
        self._lib = load()
        self._h = ctypes.c_void_p(self._lib.sora_ring_create(capacity))

    def alloc_vstream(self) -> int:
        vs = self._lib.sora_ring_alloc_vstream(self._h)
        if vs < 0:
            raise RuntimeError("no free vstream slots")
        return vs

    def write(self, samples: np.ndarray) -> None:
        iq = np.ascontiguousarray(
            samples.astype(np.complex64)).view(np.float32)
        self._lib.sora_ring_write(self._h, _fptr(iq), len(samples))

    def read(self, vs: int, max_samples: int) -> np.ndarray:
        out = np.empty(2 * max_samples, dtype=np.float32)
        n = self._lib.sora_ring_read(self._h, vs, _fptr(out), max_samples)
        return out[: 2 * n].view(np.complex64)

    def available(self, vs: int) -> int:
        return self._lib.sora_ring_available(self._h, vs)

    def read_windows(self, vs: int, window: int, hop: int, batch: int,
                     scale: float = 1.0, dtype=np.int16):
        """Assemble ``batch`` overlapping windows straight from the ring
        into quantized interleaved I/Q (the node's feed path — slicing +
        gain + ADC saturation — as ONE native pass; the overlap stays in
        the ring, so no carry buffer).  Returns (arr (batch, window, 2),
        start_position) or None if not enough samples; raises if the
        span exceeds the ring capacity (caller should fall back)."""
        if dtype == np.int16:
            out = np.empty((batch, window, 2), np.int16)
            start = self._lib.sora_ring_read_windows_i16(
                self._h, vs, window, hop, batch, scale,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        else:
            out = np.empty((batch, window, 2), np.int8)
            start = self._lib.sora_ring_read_windows_i8(
                self._h, vs, window, hop, batch, scale,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if start == -2:
            raise ValueError("window span exceeds ring capacity")
        if start < 0:
            return None
        return out, int(start)

    def drops(self, vs: int) -> int:
        return self._lib.sora_ring_drops(self._h, vs)

    def start_replay(self, samples: np.ndarray, rate_sps: float = 0.0,
                     loop: bool = False) -> None:
        iq = np.ascontiguousarray(
            samples.astype(np.complex64)).view(np.float32)
        self._lib.sora_ring_start_replay(self._h, _fptr(iq), len(samples),
                                         rate_sps, 1 if loop else 0)

    def stop(self) -> None:
        self._lib.sora_ring_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.sora_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def monotonic_ns() -> float:
    return load().sora_monotonic_ns()
