"""Front-end verification algorithms — the HwVeri analogue.
(The port's own copy of ``sora_tpu.util.hwveri``.)

The reference ships a GUI hardware-verification suite run against the
live RCB (usr/HwVeri/HwVeriAlgorithm/{SNRTest,SineWaveTest,AGC,
FreqOffset}.cpp, with a generated 32K float FFT).  These are the same
measurements as plain functions over captured sample buffers, so they run
against any front end: a file, the virtual air, or real hardware feed.
numpy only — they are host-side qualification tools, not the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _tone_bin(x: np.ndarray) -> tuple[int, np.ndarray]:
    X = np.fft.fft(x * np.hanning(len(x)))
    mag = np.abs(X)
    k = int(np.argmax(mag))
    return k, X


@dataclass
class SineReport:
    freq_hz: float
    amplitude: float
    dc: complex
    spur_db: float            # strongest non-harmonic spur vs carrier
    thd_db: float             # total harmonic distortion vs carrier
    ok: bool = False


def sine_wave_test(x: np.ndarray, fs: float, min_spur_db: float = 30.0
                   ) -> SineReport:
    """Single-tone integrity check (SineWaveTest.cpp): dominant-tone
    frequency/amplitude, DC content, spur and harmonic levels."""
    x = np.asarray(x, dtype=np.complex128)
    dc = complex(x.mean())
    xa = x - dc
    n = len(xa)
    k, X = _tone_bin(xa)
    mag = np.abs(X)
    # parabolic interpolation around the peak for sub-bin frequency
    km, kp = (k - 1) % n, (k + 1) % n
    a, b, c = mag[km], mag[k], mag[kp]
    delta = 0.5 * (a - c) / (a - 2 * b + c + 1e-18)
    kf = (k + delta)
    freq = (kf if kf < n / 2 else kf - n) * fs / n
    carrier_p = float(mag[k] ** 2 + mag[km] ** 2 + mag[kp] ** 2)
    guard = np.zeros(n, bool)
    harm_p = 0.0
    for h in range(1, 6):
        hk = int(round(h * kf)) % n
        lo = np.arange(hk - 2, hk + 3) % n
        guard[lo] = True
        if h > 1:
            harm_p += float(np.sum(mag[lo] ** 2))
    spur_p = float(np.max(mag[~guard] ** 2)) if (~guard).any() else 0.0
    spur_db = 10 * np.log10(carrier_p / (spur_p + 1e-18))
    thd_db = 10 * np.log10(carrier_p / (harm_p + 1e-18))
    # complex baseband: |amp * e^{jwt}| is constant, so amplitude == RMS
    amp = float(np.sqrt(np.mean(np.abs(xa) ** 2)))
    return SineReport(freq_hz=float(freq), amplitude=amp, dc=dc,
                      spur_db=float(spur_db), thd_db=float(thd_db),
                      ok=bool(spur_db > min_spur_db))


def snr_test(x: np.ndarray, fs: float) -> float:
    """Tone SNR in dB (SNRTest.cpp): carrier power vs everything else
    after DC removal, windowed periodogram."""
    x = np.asarray(x, dtype=np.complex128)
    x = x - x.mean()
    n = len(x)
    k, X = _tone_bin(x)
    p = np.abs(X) ** 2
    sig = np.zeros(n, bool)
    sig[np.arange(k - 2, k + 3) % n] = True
    s = float(p[sig].sum())
    nz = float(p[~sig].sum()) + 1e-18
    # scale the noise estimate from the (1 - 5/n) analysed fraction
    return float(10 * np.log10(s / nz))


def measure_freq_offset(x: np.ndarray, fs: float, f_expected: float
                        ) -> float:
    """CFO of a known-frequency test tone in Hz (FreqOffset.cpp):
    phase-slope estimator — robust to +-fs/2, sub-Hz resolution with
    enough samples."""
    x = np.asarray(x, dtype=np.complex128)
    x = x - x.mean()
    n = len(x)
    # coarse from the periodogram, fine from the mean lag-1 phase of the
    # de-rotated tone
    rep = sine_wave_test(x, fs)
    coarse = rep.freq_hz
    y = x * np.exp(-2j * np.pi * coarse * np.arange(n) / fs)
    fine = float(np.angle(np.vdot(y[:-1], y[1:]))) * fs / (2 * np.pi)
    return coarse + fine - f_expected


@dataclass
class AgcResult:
    gain: float
    rms_in: float
    rms_out: float
    clipped: bool


def agc_select_gain(x: np.ndarray, target_rms: float = 0.25,
                    full_scale: float = 1.0,
                    gains: tuple = (1, 2, 4, 8, 16, 32, 64)) -> AgcResult:
    """Pick the largest discrete gain whose peak stays inside full scale
    and whose RMS does not overshoot the target (AGC.cpp: the RX
    LNA/RXVGA ladder walk, quantized gains)."""
    x = np.asarray(x, dtype=np.complex128)
    rms = float(np.sqrt(np.mean(np.abs(x) ** 2))) + 1e-18
    peak = float(np.max(np.abs(x))) + 1e-18
    best = gains[0]
    for g in sorted(gains):
        if g * peak <= full_scale and g * rms <= target_rms * 1.25:
            best = g
    return AgcResult(gain=float(best), rms_in=rms, rms_out=best * rms,
                     clipped=bool(best * peak > full_scale))
