"""Plain reference of the OFDM receivers' estimates: detection, timing,
coarse CFO and the legacy-LTS SNR, batched over streams in plain PyTorch.

It computes what the port's receivers document for their outputs
(``lts1``, ``cfo``, ``det``, ``snr_db``) from the definitions, with its
own tables from the frozen copy in ``benchmark.golden.common``, and
imports nothing of the program:

* the STS metric: lag-16 autocorrelation ``w`` and energy ``en``, both
  64-sample moving sums (summed over the antennas), gated at 5% of the
  stream's peak energy, ``m = |w| / (en + 1e-9)``;
* onset: 11a takes the first sample of the metric at or over 90% of its
  peak within ``[0, N - 480)``; 11n the first sample over 90% within
  ``[0, N - 900)``, plus 16; the multi-frame detector every rising edge
  over an absolute threshold with no hit in the 240 samples before;
* ``det`` is the metric at the onset, ``cfo`` the angle of ``w`` there
  over 16;
* ``lts1`` is the first maximum of ``|c[n]| + |c[n + 64]|``, ``c`` the
  cross-correlation with the LTS after removing the coarse CFO, over a
  window after the onset;
* ``snr_db`` is the LTS-repeat estimate: the fine CFO from the two
  repeats, the mean ``|H|^2`` over 64 bins times 64/52 over half the
  mean squared repeat difference.

Float64 by default; :class:`Precision` names the controls' arithmetic.

An onset is a threshold crossing, and float rounding can move a crossing
by one sample where the metric sits on the threshold.  :func:`onsets`
therefore returns every sample that the rule picks under thresholds
perturbed by a relative ``delta``: the judge accepts the program's
estimate at whichever of these it matches best.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.golden import common as C

GATE = 0.05          # energy gate, a share of the stream's peak energy
PLATEAU = 0.9        # onset at this share of the metric's peak
SUPPRESS = 240       # multi-frame: no hit this many samples before an edge


@dataclass(frozen=True)
class Precision:
    """The reference's arithmetic: ``float64``; ``tf32``, float32 with TF32
    matrix products (the control of a check that states float32 products
    with TF32 off); ``bf16``, every value rounded to bfloat16 after each
    operation and the products in bfloat16 (the control of the float32
    arithmetic outside the products)."""

    name: str = "float64"

    @property
    def real(self):
        return torch.float64 if self.name == "float64" else torch.float32

    @property
    def cplx(self):
        return (torch.complex128 if self.name == "float64"
                else torch.complex64)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to this precision's storage (bf16 only)."""
        if self.name != "bf16":
            return t
        r = lambda v: v.to(torch.bfloat16).to(torch.float32)
        if t.is_complex():
            return torch.complex(r(t.real), r(t.imag))
        return r(t) if t.is_floating_point() else t


FLOAT64 = Precision("float64")
TF32 = Precision("tf32")
BF16 = Precision("bf16")


class _tf32_matmul:
    """Turn TF32 matmuls on (or off) for the block, restoring the setting."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def moving_sum(v: torch.Tensor, width: int, prec: Precision = FLOAT64):
    """Sums of ``width`` (a power of two) consecutive values along the
    last axis, as a doubling tree of shifted adds."""
    span = 1
    while span < width:
        v = prec.q(v[..., : v.shape[-1] - span] + v[..., span:])
        span *= 2
    return v


def dft64(y: torch.Tensor, prec: Precision) -> torch.Tensor:
    """64-point DFT over the last axis as the matrix product of its
    definition, in real arithmetic of ``prec``."""
    k = np.arange(64)
    ang = -2.0 * np.pi * np.outer(k, k) / 64.0
    mt = torch.bfloat16 if prec.name == "bf16" else prec.real
    c = torch.as_tensor(np.cos(ang), dtype=mt, device=y.device)
    s = torch.as_tensor(np.sin(ang), dtype=mt, device=y.device)
    yr, yi = y.real.to(mt), y.imag.to(mt)
    with _tf32_matmul(prec.name == "tf32"):
        out = torch.complex((yr @ c - yi @ s).to(prec.real),
                            (yr @ s + yi @ c).to(prec.real))
    return prec.q(out)


def sts_metric(x: torch.Tensor, prec: Precision = FLOAT64):
    """(w, en, m_raw) of (B, A, N) streams: w complex (B, N - 79), en real,
    m_raw = |w| / (en + 1e-9) without the energy gate."""
    q = prec.q
    x = q(x)
    ac = q(x[..., 16:] * torch.conj(x[..., :-16]))
    w = q(moving_sum(ac, 64, prec).sum(dim=1))
    en = q(moving_sum(q(x[..., :-16].abs() ** 2), 64, prec).sum(dim=1))
    return w, en, q(q(w.abs()) / q(en + 1e-9))


def _first(mask: torch.Tensor) -> torch.Tensor:
    """First True along the last axis (0 where there is none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def onsets(en, m_raw, limit: int, delta: float):
    """The single-frame onset rule under thresholds scaled by 1 -+ delta:
    (lo, hi), the first and the last sample it can pick, (B,) int64."""
    valid_en = en[:, :limit]
    valid_m = m_raw[:, :limit]
    enmax = en.max(dim=-1, keepdim=True).values
    gated = torch.where(valid_en > GATE * enmax, valid_m, 0.0)
    peak = gated.max(dim=-1, keepdim=True).values
    lo = _first((valid_en > GATE * enmax * (1 - delta))
                & (valid_m >= PLATEAU * peak * (1 - delta)))
    hi = _first((valid_en > GATE * enmax * (1 + delta))
                & (valid_m > PLATEAU * peak * (1 + delta)))
    return lo, torch.maximum(lo, hi)


def _edges(en, m_raw, limit: int, thr: float, scale: float, K: int):
    """The first K rising edges of each stream (B, K) and their count."""
    enmax = en.max(dim=-1, keepdim=True).values
    gated = torch.where(en[:, :limit] > GATE * enmax * scale,
                        m_raw[:, :limit], 0.0)
    hit = (gated >= thr * scale).to(torch.int32)
    cs = torch.cumsum(hit, dim=-1)
    n = cs.shape[-1]
    pad = lambda k: torch.cat([cs.new_zeros(cs.shape[0], k), cs],
                              dim=-1)[:, :n]
    edge = (hit > 0) & ((pad(1) - pad(SUPPRESS + 1)) == 0)
    eidx = torch.cumsum(edge.to(torch.int32), dim=-1)
    ks = torch.arange(1, K + 1, device=en.device, dtype=torch.int32)
    return _first(eidx[:, None, :] == ks[None, :, None]), eidx[:, -1]


def multi_onsets(en, m_raw, limit: int, thr: float, K: int, delta: float):
    """The multi-frame detector under thresholds scaled by 1 -+ delta:
    (lo, hi, count, ambiguous) with lo/hi (B, K) and count, ambiguous
    (B,): a stream is ambiguous where the perturbed rules find different
    numbers of edges, or the same edge more than 64 samples apart."""
    a, na = _edges(en, m_raw, limit, thr, 1 - delta, K)
    b, nb = _edges(en, m_raw, limit, thr, 1 + delta, K)
    count = torch.minimum(na, nb).clamp(max=K)
    have = torch.arange(K, device=en.device)[None, :] < count[:, None]
    far = ((a - b).abs() > 64) & have
    return (torch.minimum(a, b), torch.maximum(a, b), count,
            (na != nb) | far.any(dim=-1))


def pick(lo, hi, m_raw, det=None, span: int = 8):
    """The onset to use within [lo, hi]: the one whose metric is nearest
    ``det`` (the judged estimate), or ``lo`` without one.  lo/hi any shape
    of leading indices into the rows of m_raw (flattened to (R,))."""
    if det is None:
        return lo
    d = torch.arange(span, device=lo.device)
    t = lo[:, None] + d[None, :]
    ok = t <= hi[:, None]
    t = torch.where(ok, t, lo[:, None])
    gap = (m_raw.gather(1, t) - det[:, None].to(m_raw.dtype)).abs()
    gap = torch.where(ok, gap, torch.inf)
    return t.gather(1, gap.argmin(dim=1, keepdim=True))[:, 0]


def lts_lock(x, t0, cfo, width: int, mask_tail: bool,
             prec: Precision = FLOAT64):
    """First maximum of the LTS metric over positions [t0, t0 + width) of
    (R, A, N) streams after removing ``cfo``.  With ``mask_tail``
    positions past N - 128 do not count (the metric's own length); else
    the stream reads as zeros past its end."""
    R, A, N = x.shape
    seg = width + 127
    xp = torch.cat([x, x.new_zeros(R, A, seg)], dim=-1)
    idx = (t0[:, None] + torch.arange(seg, device=x.device)[None, :])
    y = xp.gather(2, idx[:, None, :].expand(R, A, seg))
    n = torch.arange(seg, device=x.device, dtype=cfo.dtype)
    q = prec.q
    y = q(q(y) * q(torch.exp(-1j * q(cfo[:, None, None] * n))))
    lts = q(torch.as_tensor(np.conj(C.LTS_TIME_SYM), dtype=x.dtype,
                            device=x.device))
    nwin = seg - 63
    c = torch.zeros(R, A, nwin, dtype=x.dtype, device=x.device)
    for k in range(64):
        c = q(c + q(y[..., k: k + nwin] * lts[k]))
    c = q(q(c.abs()).sum(dim=1))
    c2 = q(c[:, :-64] + c[:, 64:])
    if mask_tail:
        pos = t0[:, None] + torch.arange(width, device=x.device)[None, :]
        c2 = torch.where(pos <= N - 128, c2, 0.0)
    return t0 + torch.argmax(c2, dim=-1)


def lts_snr(x, lts1, cfo, prec: Precision):
    """The LTS-repeat SNR estimate (dB) of (R, A, N) streams at lts1."""
    R, A, N = x.shape
    xp = torch.cat([x, x.new_zeros(R, A, 128)], dim=-1)
    idx = lts1.clamp(0, N)[:, None] + torch.arange(128, device=x.device)
    y = xp.gather(2, idx[:, None, :].expand(R, A, 128))
    q = prec.q
    n = torch.arange(128, device=x.device, dtype=prec.real)
    rot = lambda a: q(torch.exp(-1j * q(a[:, None, None] * n)))
    y = q(q(y.to(prec.cplx)) * rot(cfo.to(prec.real)))
    fine = q(torch.angle(q(torch.sum(q(torch.conj(y[..., :64])
                                         * y[..., 64:]),
                                       dim=(-2, -1)))) / 64.0)
    y = q(y * rot(fine))
    L = q(0.5 * (dft64(y[..., :64], prec) + dft64(y[..., 64:], prec)))
    sign = np.zeros(64)
    sign[C.OCC_BINS] = C.LTS_FREQ
    H = L * torch.as_tensor(sign, dtype=prec.real, device=x.device)
    nvar = q(torch.mean(q(q(y[..., :64] - y[..., 64:]).abs() ** 2),
                        dim=(-2, -1)) / 2)
    sig_p = q(torch.mean(q(H.abs() ** 2), dim=(-2, -1)) * (64.0 / 52.0))
    return q(10.0 * torch.log10(q(sig_p / (nvar + 1e-12)) + 1e-12))

