"""Radio manager: the SoraURadio* command surface over a software front
end (port of ``sora_tpu.runtime.radio``: ChannelModel, REF_TAPS,
RadioState, SoftRadio, save_state, load_state).

The reference's radio manager programs a real RCB/RF board —
`SoraURadioStart / SetRxPA / SetRxGain / SetTxGain / SetCentralFreq /
SetFreqOffset / SetSampleRate / Write|ReadRadioRegister`
(kernel/core/inc/_user_mode_ext.h:100-140, state in _radio_manager.h:
``__uRxGain``/``__uTxGain``).  Without RF hardware the same command set
drives a **software front end**: the radio models what the analog chain
does to whatever is "on the air" — gain scales the capture, a
central-frequency mismatch appears as the corresponding carrier offset
at complex baseband, a sample-rate setting resamples the capture to the
configured ADC rate — and the result streams into the node's RX ring
exactly as a hardware capture would.  Settings apply LIVE: a running
paced replay picks them up on its next chunk.

The channel model and the tuning rotation are numpy, as in the JAX
package (the same seed gives the same noise, bit for bit); the rate
change runs through ``phy.frontend.resample`` on the radio's ``device``
(default cuda; raises without CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np

from sora_tpu_torch.phy import frontend as fe
from sora_tpu_torch.util.xfer import fetch, resolve_device, upload


@dataclass
class ChannelModel:
    """Propagation between the air record and this radio's antenna(s).

    The reference's air is real RF — dispersive, Doppler-shifted, on a
    mismatched receive clock; its per-subcarrier equalization and pilot
    tracking exist to survive it (channel_11a.hpp:534-613,
    pilot.hpp:142-236).  This model puts the same impairments on the
    software air so node-level and soak runs are driven under them, not
    just chain-level tests (tests/test_channel.py's models, folded into
    the radio path — VERDICT r04 item 6).

    taps: [(delay_samples, coeff)] — coeff a complex scalar (SISO) or an
    (A_rx, A_tx) mixing matrix (per-path spatial coupling, MIMO).
    doppler_hz: carrier Doppler, indistinguishable from extra tuning
    offset at baseband (adds to the central-freq mismatch rotation).
    sfo_ppm: receive sampling-clock error, applied by windowed-sinc
    resampling (linear interpolation would bury the effect under -20 dB
    images at the edge subcarriers).
    noise_rms: AWGN at the antenna (per real/imag component std
    = noise_rms / sqrt(2))."""

    taps: list = field(default_factory=lambda: [(0, 1.0)])
    doppler_hz: float = 0.0
    sfo_ppm: float = 0.0
    noise_rms: float = 0.0
    seed: int = 0
    _rng: object = field(default=None, repr=False, compare=False)

    def apply(self, x: np.ndarray, rate_sps: float) -> np.ndarray:
        """x: (n,) or (A_tx, n) air -> (n',) or (A_rx, n') at the
        antenna (before the radio's own gain/tuning/ADC stages)."""
        x = np.asarray(x, np.complex64)
        siso = x.ndim == 1
        xt = x[None] if siso else x                       # (A_tx, n)
        max_d = max(d for d, _ in self.taps)
        first = np.asarray(self.taps[0][1])
        a_rx = 1 if (siso and first.ndim == 0) else \
            (first.shape[0] if first.ndim == 2 else xt.shape[0])
        y = np.zeros((a_rx, xt.shape[1] + max_d), np.complex128)
        for d, c in self.taps:
            c = np.asarray(c)
            if c.ndim == 2:                               # (A_rx, A_tx)
                y[:, d: d + xt.shape[1]] += c @ xt
            else:
                y[:, d: d + xt.shape[1]] += c * xt
        if self.doppler_hz:
            n = np.arange(y.shape[1], dtype=np.float64)
            y = y * np.exp(2j * np.pi * self.doppler_hz / rate_sps * n)
        if self.sfo_ppm:
            y = np.stack([_sfo_resample(r, self.sfo_ppm) for r in y])
        if self.noise_rms:
            # ONE rng per model, advanced per call: repeated captures
            # see independent noise, runs stay seed-reproducible
            if self._rng is None:
                object.__setattr__(self, "_rng",
                                   np.random.default_rng(self.seed))
            rng = self._rng
            y = y + (rng.normal(size=y.shape)
                     + 1j * rng.normal(size=y.shape)) * (
                         self.noise_rms / np.sqrt(2.0))
        y = y.astype(np.complex64)
        return y[0] if (siso and y.shape[0] == 1) else y


# The canonical 4-tap in-CP reference channel used by the soaks, the
# sensitivity sweep, and the impairment tests — ONE definition so
# tuning it cannot desynchronize the measurements.
REF_TAPS = [(0, 1.0), (3, 0.45 * np.exp(0.9j)),
            (7, 0.2 * np.exp(-2.1j)), (11, 0.08 * np.exp(0.3j))]


def _sfo_resample(w: np.ndarray, ppm: float, taps: int = 64) -> np.ndarray:
    """Windowed-sinc resample of a waveform as received by a clock off
    by ``ppm`` parts per million (the test_sfo model)."""
    ratio = 1.0 + ppm * 1e-6
    m = int(len(w) * ratio)
    t = np.arange(m) / ratio
    i0 = np.floor(t).astype(np.int64)
    frac = (t - i0)[:, None]
    k = np.arange(-taps // 2 + 1, taps // 2 + 1)[None, :]
    d = k - frac
    h = np.sinc(d) * np.cos(np.pi * d / taps) ** 2
    h /= h.sum(axis=1, keepdims=True)
    wp = np.pad(w, (taps, taps))
    return (wp[i0[:, None] + k + taps] * h).sum(axis=1).astype(
        np.complex64)


@dataclass
class RadioState:
    """The RADIO_CONTEXT register image (_radio_manager.h:109-111)."""
    central_freq_hz: float = 2.422e9      # SetCentralFreq (kHz in ref)
    freq_offset_hz: float = 0.0           # SetFreqOffset
    rx_gain_db: float = 0.0               # SetRxGain (ladder in ref)
    rx_pa_db: float = 0.0                 # SetRxPA
    tx_gain_db: float = 0.0               # SetTxGain
    sample_rate_sps: float = 20e6         # SetSampleRate (MHz in ref)
    running: bool = False                 # SoraURadioStart
    registers: dict = field(default_factory=dict)


class SoftRadio:
    """One radio front end bound to an RX ring.

    The "air" is a complex baseband record (array) carried at
    ``air_freq_hz`` / ``air_rate_sps``; ``start_rx`` streams the capture
    this radio would take of it — gain-scaled, frequency-shifted by the
    tuning mismatch, resampled to the configured ADC rate — into the
    ring (paced or bulk).  ``tx`` applies the TX gain and hands the
    waveform to a sink (e.g. a peer radio's air) — the
    SoraURadioTransfer + SoraURadioTx pair.
    """

    def __init__(self, ring=None, name: str = "radio0", device=None):
        self.name = name
        self.device = resolve_device(device)
        self.ring = ring
        self.state = RadioState()
        self._air: np.ndarray | None = None
        self._air_freq = 2.422e9
        self._air_rate = 20e6
        self._tx_sink = None
        self.channel: ChannelModel | None = None
        self._lock = threading.Lock()

    # -- command surface (_user_mode_ext.h:70-140) ---------------------------

    def start(self) -> None:                     # SoraURadioStart
        self.state.running = True

    def stop(self) -> None:
        self.state.running = False
        if self.ring is not None:
            self.ring.stop()

    def set_rx_gain(self, db: float) -> None:    # SoraURadioSetRxGain
        with self._lock:
            self.state.rx_gain_db = float(db)

    def set_rx_pa(self, db: float) -> None:      # SoraURadioSetRxPA
        with self._lock:
            self.state.rx_pa_db = float(db)

    def set_tx_gain(self, db: float) -> None:    # SoraURadioSetTxGain
        with self._lock:
            self.state.tx_gain_db = float(db)

    def set_central_freq(self, hz: float) -> None:
        with self._lock:                         # SoraURadioSetCentralFreq
            self.state.central_freq_hz = float(hz)

    def set_freq_offset(self, hz: float) -> None:
        with self._lock:                         # SoraURadioSetFreqOffset
            self.state.freq_offset_hz = float(hz)

    def set_sample_rate(self, sps: float) -> None:
        with self._lock:                         # SoraURadioSetSampleRate
            self.state.sample_rate_sps = float(sps)

    def write_register(self, addr: int, value: int) -> None:
        self.state.registers[int(addr)] = int(value)

    def read_register(self, addr: int) -> int:
        return self.state.registers.get(int(addr), 0)

    # -- the software front end ----------------------------------------------

    def attach_air(self, samples: np.ndarray, freq_hz: float = 2.422e9,
                   rate_sps: float = 20e6) -> None:
        """Install what is on the air: a complex baseband record centred
        at ``freq_hz``, sampled at ``rate_sps``."""
        self._air = np.asarray(samples, np.complex64)
        self._air_freq = float(freq_hz)
        self._air_rate = float(rate_sps)

    def attach_tx_sink(self, sink) -> None:
        """Where transmissions go: any callable(wave) — typically the
        peer radio's ring/air (the software ether)."""
        self._tx_sink = sink

    def set_channel(self, model: "ChannelModel | None") -> None:
        """Install the propagation model between the air record and this
        radio's antenna(s); None = ideal (flat, no Doppler, clean
        clock).  Applies live, like every other knob."""
        with self._lock:
            self.channel = model

    def capture(self, samples: np.ndarray | None = None) -> np.ndarray:
        """The capture this radio takes of the air under its current
        settings: analog gain (RxPA + RxGain), tuning-mismatch carrier
        rotation, ADC-rate resampling."""
        with self._lock:
            st = RadioState(**{k: v for k, v in vars(self.state).items()})
            ch = self.channel
        x = np.asarray(self._air if samples is None else samples,
                       np.complex64)
        if ch is not None:            # propagation: multipath/mixing,
            x = ch.apply(x, self._air_rate)   # Doppler, SFO, noise
        gain = 10.0 ** ((st.rx_gain_db + st.rx_pa_db) / 20.0)
        # tuning mismatch: an air carrier at f_air seen by a radio tuned
        # to f_c (+ fine offset) lands at baseband offset f_air - f_c
        df = self._air_freq - (st.central_freq_hz + st.freq_offset_hz)
        if df != 0.0:
            n = np.arange(x.shape[-1], dtype=np.float64)
            x = x * np.exp(2j * np.pi * df / self._air_rate * n)
        if st.sample_rate_sps != self._air_rate:
            fr = Fraction(int(round(st.sample_rate_sps)),
                          int(round(self._air_rate))).limit_denominator(64)
            flat = np.ascontiguousarray(x.reshape(-1, x.shape[-1]),
                                        np.complex64)
            x = fetch(fe.resample(upload(flat, self.device), fr.numerator,
                                  fr.denominator)
                      ).reshape(x.shape[:-1] + (-1,))
        return (gain * x).astype(np.complex64)

    def start_rx(self, paced: bool = False, loop: bool = False) -> None:
        """Stream the capture into the RX ring — the RX DMA.  Paced mode
        replays at the configured ADC rate on the ring's native producer
        thread; bulk mode writes it all at once (offline decode)."""
        if self.ring is None:
            raise RuntimeError("no RX ring attached")
        if not self.state.running:
            self.start()
        cap = self.capture()
        if paced:
            self.ring.start_replay(cap,
                                   rate_sps=self.state.sample_rate_sps,
                                   loop=loop)
        else:
            self.ring.write(cap)

    def tx(self, wave: np.ndarray) -> np.ndarray:
        """SoraURadioTransfer + SoraURadioTx: apply TX gain, hand the
        waveform to the sink (if any), return what went to air."""
        g = 10.0 ** (self.state.tx_gain_db / 20.0)
        out = (g * np.asarray(wave, np.complex64)).astype(np.complex64)
        if self._tx_sink is not None:
            self._tx_sink(out)
        return out



# -- persisted register image (the usereg CLI's handle on a radio) ----------


def save_state(state: RadioState, path: str) -> None:
    """Serialize the RADIO_CONTEXT register image to a JSON file — the
    cross-process handle apps/usereg.py operates on (the reference's
    usereg.cpp talks to the driver's radio context via DeviceIoControl;
    here the context is a file the owning process reloads).  The file is
    the JAX package's byte for byte, so either package reads the other's."""
    d = dict(vars(state))
    d["registers"] = {str(k): v for k, v in state.registers.items()}
    with open(path, "w") as f:
        json.dump(d, f, indent=1, sort_keys=True)


def load_state(path: str) -> RadioState:
    with open(path) as f:
        d = json.load(f)
    d["registers"] = {int(k): int(v)
                      for k, v in d.get("registers", {}).items()}
    return RadioState(**d)
