"""SDL — the Sora Development Library convenience layer (port of
``sora_tpu.sdl``).

The reference SDL (kernel/sdl/inc/sdl.hpp, sora_radio.h:273-571) wraps
the raw runtime in RAII classes so sample apps stay a page long:
``CSoraSignal`` manages sample buffers with file I/O, ``CSoraRadio`` /
``CSoraMIMORadio`` bundle radio bring-up + RX stream + TX staging, and
helpers cover FIR taps, measurements and plots.  This module is the same
idea over the port's runtime: a ``Signal`` value type over numpy samples
with dump-file I/O, resampling and measurements, and a ``Radio`` that
bundles RxRing(s) + StreamingNode + TxSink behind open/rx/tx/close.

The device work (``Signal.resample``, ``Signal.spectrum`` and the node
behind ``Radio``) runs on ``device``: cuda unless the caller names
another, raising without CUDA (``util.xfer.resolve_device``).

Example (the reference's OFDM-rx sample, SDL-ified)::

    with Radio(phy="a") as r:
        r.inject(wave)               # or r.replay(dump_path)
        for src, payload in r.rx(seconds=1.0):
            print(src.hex(), len(payload))
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from sora_tpu_torch.apps.speanalyzer import welch_spectrum
from sora_tpu_torch.io.dumpfile import load_dump, save_dump
from sora_tpu_torch.phy import frontend as fe
from sora_tpu_torch.runtime.native import RxRing, replay_samples
from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink
from sora_tpu_torch.util.hwveri import snr_test
from sora_tpu_torch.util.xfer import resolve_device


# =============================================================================
# Signal — CSoraSignal / CSoraSignalBuf analogue
# =============================================================================


@dataclass
class Signal:
    """Samples + their rate, with the dump format and basic DSP attached."""

    samples: np.ndarray
    sample_rate: float = 20e6

    def __len__(self) -> int:
        return len(self.samples)

    @classmethod
    def from_dump(cls, path: str, sample_rate: float = 40e6) -> "Signal":
        return cls(load_dump(path).astype(np.complex64), sample_rate)

    def to_dump(self, path: str, bits: int = 16,
                scale: float | None = None) -> int:
        """Write the dump file.  The format stores integer I/Q (the RCB
        ADC convention), so float signals are auto-scaled to ~1/4 full
        scale unless ``scale`` is given."""
        if scale is None:
            peak = float(np.max(np.abs(self.samples))) or 1.0
            full = (1 << (bits - 1)) - 1
            scale = 1.0 if peak > 16 else full / (4.0 * peak)
        return save_dump(path, self.samples * scale, bits=bits)

    def resample(self, target_rate: float, device=None) -> "Signal":
        """Rate change through the port's front end on ``device``: the
        halfband stages for 2x up and down, the polyphase resampler
        otherwise."""
        fr = Fraction(int(target_rate), int(self.sample_rate))
        up, down = fr.numerator, fr.denominator
        dev = resolve_device(device)
        if (up, down) == (1, 1):
            return Signal(self.samples.copy(), self.sample_rate)
        x = torch.as_tensor(np.asarray(self.samples, np.complex64)[None],
                            device=dev)
        if (up, down) == (2, 1):
            y = fe.upsample2(x)
        elif (up, down) == (1, 2):
            y = fe.downsample2(x)
        else:
            y = fe.resample(x, up, down)
        return Signal(y[0].cpu().numpy().astype(np.complex64), target_rate)

    def power_dbfs(self) -> float:
        p = float(np.mean(np.abs(self.samples) ** 2))
        return 10.0 * np.log10(p + 1e-30)

    def spectrum(self, nfft: int = 1024, device=None):
        """(freqs_hz, power_db) Welch spectrum — the speanalyzer core."""
        return welch_spectrum(self.samples, nfft, self.sample_rate,
                              device=device)

    def snr_db(self) -> float:
        """Sine-fit SNR of a tone signal (HwVeri SNRTest analogue)."""
        return snr_test(self.samples, self.sample_rate)


# =============================================================================
# Radio — CSoraRadio / CSoraMIMORadio analogue
# =============================================================================


@dataclass
class RadioConfig:
    """The radio bring-up registers of ConfigureRadio
    (dot11main.cpp:121-146), kept as data: this framework's hardware
    boundary is the sample ring (SURVEY §2.6 — no RCB exists here)."""
    freq_mhz: float = 2422.0
    tx_gain: float = 0x1500 / 0x2000
    rx_gain: float = 0x2000 / 0x2000
    sample_rate: float = 20e6


class Radio:
    """RAII bundle: RxRing(s) + StreamingNode + TxSink.

    ``phy`` "a"/"b"/"n" picks the chain (11n opens two antenna rings —
    the CSoraMIMORadio case).  ``inject``/``replay`` feed the air;
    ``send`` queues CSMA/CA data TX; ``rx`` iterates received payloads.
    The node runs on ``device`` (default cuda).
    """

    def __init__(self, phy: str = "a", cfg=None, radio: RadioConfig | None
                 = None, device=None, **node_kw):
        self.radio = radio or RadioConfig()
        self.cfg = cfg or NodeConfig(
            phy=phy, max_psdu=node_kw.pop("max_psdu", 256),
            sample_rate_sps=self.radio.sample_rate, **node_kw)
        dev = resolve_device(device)       # before any ring is allocated
        n_rings = 2 if phy == "n" else 1
        self.rings = [RxRing(capacity=1 << 22) for _ in range(n_rings)]
        self.tx_sink = TxSink(self.rings)      # loopback software air
        self.node = StreamingNode(
            self.rings if phy == "n" else self.rings[0],
            self.cfg, tx_sink=self.tx_sink, device=dev)
        self._consumed = 0

    # -- context management (the RAII part) -----------------------------------

    def __enter__(self) -> "Radio":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for r in self.rings:
            r.stop()
            r.close()

    # -- air sources ----------------------------------------------------------

    def inject(self, wave, antenna: int | None = None) -> None:
        """Write a waveform into the RX ring(s) — test/loopback air."""
        w = np.asarray(wave, np.complex64)
        if w.ndim == 2:                       # (n_antenna, N)
            for a, row in enumerate(w):
                self.rings[a].write(np.ascontiguousarray(row))
            return
        rings = self.rings if antenna is None else [self.rings[antenna]]
        for r in rings:
            r.write(w)

    def replay(self, path: str, rate_sps: float | None = None,
               loop: bool = False) -> None:
        """Paced dump replay into the ring (the offline test harness
        source, demod11/brickutil.h:20-58), in the sample wire's units
        (``runtime.native.replay_samples``; the JAX package replays raw
        ADC counts, which clip at the wire)."""
        src = replay_samples(path)
        for r in self.rings:
            r.start_replay(src, rate_sps=rate_sps or
                           self.radio.sample_rate, loop=loop)

    # -- MAC-level I/O --------------------------------------------------------

    def send(self, payload: bytes, dst: bytes,
             rate: float | None = None) -> None:
        self.node.send(payload, dst, rate=rate)

    def rx(self, seconds: float = 1.0, idle_stop: int = 50):
        """Drive the node loop, yielding (src_addr, payload) pairs."""
        t_end = time.perf_counter() + seconds
        idle = 0
        while time.perf_counter() < t_end and idle < idle_stop:
            if not self.node.step():
                idle += 1
                time.sleep(0.001)
            else:
                idle = 0
            while self._consumed < len(self.node.rx_payloads):
                yield self.node.rx_payloads[self._consumed]
                self._consumed += 1
        self.node.flush()
        while self._consumed < len(self.node.rx_payloads):
            yield self.node.rx_payloads[self._consumed]
            self._consumed += 1

    @property
    def stats(self):
        return self.node.stats
