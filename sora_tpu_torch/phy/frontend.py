"""Sample-rate front end: DC removal, decimation, resampling, pulse
shaping — torch, batched (port of ``sora_tpu.phy.frontend``).

The reference RX graphs start at the radio rate — 40 Msps (Sora<->Sora) or
44 Msps (11b interop with commercial NICs) — and run an in-graph front end
before any demodulation:

* ``TDCRemoveEx<4>`` / ``TDCEstimator`` — DC offset removal
  (kernel/brick/inc/dc.hpp:48-166),
* ``TDownSample2`` — 40 -> 20 Msps for OFDM
  (kernel/bb/Brick11/src/samples.hpp:11-47),
* ``TDownSample44_40`` / ``TUpsample40MTo44M`` — 44 <-> 40 rational
  resampling (sampling.hpp:10-66, 44MTo40M.hpp),
* ``TMatchFilter`` / ``TPulseShaper`` — RRC matched filtering for DSSS
  (pulse.hpp:44-260),
* ``TSymTiming`` — decimation-phase selection by correlation peak
  tracking (symtiming.hpp:177).

Every stage is a batched tensor op over the last axis on the input's
device: DC removal a mean-subtract, FIRs shifted-add accumulations
(``dsp.filters.fir_centered``), decimation a strided slice, and phase
selection a fold-energy argmax over all phases at once.  The filter
prototypes are the JAX package's numpy designs, copied.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.dsp import filters as df

fir_centered = df.fir_centered


# =============================================================================
# Filter prototypes (numpy, recomputed at first use)
# =============================================================================


@lru_cache(maxsize=None)
def halfband_taps(ntaps: int = 23) -> np.ndarray:
    """Odd-length halfband low-pass (cutoff = fs/4): every other tap is
    exactly zero, so the polyphase decimator costs ~ntaps/2 MACs/sample."""
    assert ntaps % 2 == 1
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(n / 2.0) * np.hamming(ntaps)      # sinc zeroes the even taps
    return (h / h.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def rrc_taps(beta: float = 0.5, sps: int = 4, span: int = 8) -> np.ndarray:
    """Root-raised-cosine prototype, unit energy (TPulseShaper /
    TMatchFilter coefficient tables, pulse.hpp:44-260 — recomputed)."""
    n = np.arange(-span * sps, span * sps + 1, dtype=np.float64)
    t = n / sps
    h = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4 * beta / np.pi
        elif abs(abs(4 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            h[i] = (np.sin(np.pi * ti * (1 - beta))
                    + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta))) / (
                np.pi * ti * (1 - (4 * beta * ti) ** 2))
    return (h / np.sqrt(np.sum(h ** 2))).astype(np.float32)


@lru_cache(maxsize=None)
def _resample_taps(up: int, down: int, taps_per_phase: int = 10
                   ) -> np.ndarray:
    """Windowed-sinc prototype for a rational up/down resampler, designed
    at the zero-stuffed rate with cutoff min(1/up, 1/down) * Nyquist."""
    m = max(up, down)
    ntaps = taps_per_phase * m + 1
    n = np.arange(ntaps) - (ntaps - 1) / 2
    cutoff = 1.0 / m                               # fraction of Nyquist
    h = np.sinc(n * cutoff) * np.hamming(ntaps) * cutoff
    return (h / np.abs(np.fft.fft(h, 4096)).max()).astype(np.float32)


# =============================================================================
# Stages (batched over leading axes)
# =============================================================================


def dc_remove(x: torch.Tensor) -> torch.Tensor:
    """Per-stream DC removal over the processing window — the block analogue
    of TDCRemoveEx/TDCEstimator's IIR tracker (dc.hpp:48-166)."""
    return x - torch.mean(x, dim=-1, keepdim=True)


def downsample2(x: torch.Tensor, phase: int = 0,
                filtered: bool = True) -> torch.Tensor:
    """40 -> 20 Msps (TDownSample2, samples.hpp:11-47) with an optional
    halfband anti-alias filter."""
    if filtered:
        x = fir_centered(x, halfband_taps())
    return x[..., phase::2]


def resample(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Rational-rate resample via the polyphase prototype (TUpsample40MTo44M
    / TDownSample44_40, sampling.hpp:10-66)."""
    return df.resample_poly(x, up, down, _resample_taps(up, down))


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """20 -> 40 Msps halfband interpolation — the TX staging rate of the
    reference (its mod graphs emit 40 Msps waveforms for the RCB)."""
    n = x.shape[-1]
    y = x.new_zeros(x.shape[:-1] + (2 * n,))
    y[..., ::2] = x
    return fir_centered(y, 2.0 * halfband_taps())


# ------------------------------- OFDM (11a/n) -------------------------------


def ofdm_frontend_40m(x40: torch.Tensor, phase: int = 0) -> torch.Tensor:
    """Raw 40 Msps RX samples -> DC-free 20 Msps stream for the 11a/11n
    chains: TDownSample2 -> TDCRemoveEx before TCCA11a
    (fb11ademod_config.hpp:148-218)."""
    return downsample2(dc_remove(x40), phase=phase)


def ofdm_frontend_44m(x44: torch.Tensor) -> torch.Tensor:
    """Raw 44 Msps RX samples -> 20 Msps stream: the 11a/11n
    commercial-NIC interop mode (CreateDemodGraph11a_44M,
    kernel/bb/umxsdrbrick/fb11ademod_config.hpp:221).  10/11 polyphase
    resample to 40 Msps, then the usual halfband decimation."""
    return downsample2(resample(dc_remove(x44), 10, 11))


def ofdm_frontend(x: torch.Tensor, input_rate: str) -> torch.Tensor:
    """Dispatch the OFDM front end by input rate string ("20m" = already
    at chain rate, "40m" = Sora<->Sora radio rate, "44m" = NIC interop)."""
    if input_rate == "20m":
        return x
    if input_rate == "40m":
        return ofdm_frontend_40m(x)
    if input_rate == "44m":
        return ofdm_frontend_44m(x)
    raise ValueError(f"unknown OFDM input_rate {input_rate!r}")


def ofdm_upsample_44m(x20: torch.Tensor) -> torch.Tensor:
    """20 Msps OFDM waveform -> 44 Msps TX staging: the TX half of the
    interop mode (CreateModGraph11a_44M + TUpsample40MTo44M,
    kernel/bb/umxsdrbrick/fb11amod_config.hpp:114-118)."""
    return resample(upsample2(x20), 11, 10)


# ------------------------------- DSSS (11b) ---------------------------------

_SPS44 = 4                 # 44 Msps / 11 MHz chips


def chip_frontend_44m(x44: torch.Tensor) -> torch.Tensor:
    """44 Msps RX samples -> 11 Msps chips: DC removal, RRC matched filter,
    fold-energy decimation-phase selection (the vectorized TSymTiming,
    symtiming.hpp:177: per-phase mean power peaks at the chip centers).

    Returns (B, N//4) complex64 chips."""
    y = fir_centered(dc_remove(x44), rrc_taps(sps=_SPS44))
    n4 = (y.shape[-1] // _SPS44) * _SPS44
    ph = y[..., :n4].reshape(*y.shape[:-1], n4 // _SPS44, _SPS44)
    score = torch.sum(torch.abs(ph) ** 2, dim=-2)       # (..., 4)
    best = torch.argmax(score, dim=-1)                  # (...,)
    idx = best[..., None, None].expand(*ph.shape[:-1], 1)
    return torch.gather(ph, -1, idx)[..., 0]


def chip_frontend_40m(x40: torch.Tensor) -> torch.Tensor:
    """40 Msps RX samples -> 11 Msps chips via 11/10 resample to 44 Msps
    then the 44 Msps chip front end (the 11b Sora<->Sora sampling mode,
    umxsdrbrick/main.cpp:19 + sampling.hpp:10-36)."""
    return chip_frontend_44m(resample(x40, 11, 10))


def pulse_shape_11b(chips: torch.Tensor, sps: int = _SPS44) -> torch.Tensor:
    """11 Msps chips -> 44 Msps RRC pulse-shaped waveform (TPulseShaper,
    pulse.hpp:44-146) — the TX-side counterpart of chip_frontend_44m."""
    n = chips.shape[-1]
    y = torch.zeros(chips.shape[:-1] + (sps * n,), dtype=torch.complex64,
                    device=chips.device)
    y[..., ::sps] = chips.to(torch.complex64)
    return fir_centered(y, rrc_taps(sps=sps))


# --------------------------- TV whitespace (tvws) ---------------------------


def channelize(x: torch.Tensor, f_norm: float, decim: int = 2
               ) -> torch.Tensor:
    """Extract one channel from a wideband stream: complex mix to
    baseband, anti-alias lowpass, decimate — the umxistanbul channelized
    front end (tvws11a.hpp: a frequency shift + channel filter ahead of
    the standard 11a graph).

    x: (..., N) wideband complex stream; ``f_norm`` = channel center
    frequency / input sample rate; ``decim`` input samples per output
    sample (2 for a 40 Msps capture of 20 Msps channels).
    """
    if decim < 1 or decim & (decim - 1):
        raise ValueError("channelize decimates by halfband stages: decim "
                         f"must be 2^k, got {decim}")
    n = x.shape[-1]
    osc = torch.exp(-2j * math.pi * f_norm
                    * torch.arange(n, dtype=torch.float32, device=x.device))
    y = dc_remove(x) * osc
    for _ in range(max(0, decim.bit_length() - 1)):
        y = downsample2(y)
    return y
