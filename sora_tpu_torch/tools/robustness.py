"""The robustness batches: the inputs of the JAX package's channel, SFO
and fuzz suites (``tests/test_channel.py``, ``tests/test_sfo.py``,
``tests/test_fuzz_loopback.py``), built on the host and run through the
port's receivers.

Each builder draws from a numpy generator exactly as its suite draws
from the ``rng`` fixture (``tests/conftest.py``: a fresh
``default_rng(0x50BA)`` per test), modulates with the port's golden
models (the 11n SFO batch with the port's HT TX on the CPU) and returns
a :class:`Batch`: complex64 host samples, the receiver entry point that
the suite calls with its arguments, and the true frames.

- channel: 11a multipath (4 in-CP taps, 80 kHz CFO) at 6/12/24/54 Mbps,
  the same taps plus a +20 ppm sample clock on a 1228-byte frame, 2x2
  per-tap mixing at MCS 9 and 13, and 11b two-ray at 2 Mbps;
- SFO: +-20 ppm (with its carrier offset) on MTU frames (2500-byte
  PSDU) at all 8 rates and at MCS 8-15, and the 6 Mbps MTU frame that
  fails without pilot-slope tracking;
- fuzz: 24 11a frames of 5-600 bytes over all rates, 21 11b
  rate/preamble/length combinations, 12 + 12 11n frames over both stream
  classes, and four garbage inputs for every ``demodulate``.

``tests/test_torch_{channel,sfo,fuzz_loopback}.py`` hold the port to
the JAX receivers on these inputs on the CPU; chip_smoke.py phase 31 runs
them on the card against the CPU with :func:`run`, :func:`exact_errors`
and :func:`truth_errors`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from sora_tpu_torch.runtime.radio import _sfo_resample as sfo_resample

SEED = 0x50BA             # the suites' rng fixture
MTU_PAYLOAD = 2472        # 24 hdr + payload + 4 FCS = 2500 = MAX_PSDU
TAPS = [(0, 1.0), (3, 0.45 * np.exp(0.9j)), (7, 0.2 * np.exp(-2.1j)),
        (11, 0.08 * np.exp(0.3j))]
CHANNEL_RATES = (6, 12, 24, 54)
CHANNEL_MCS = (9, 13)
SFO_PPM = (20.0, -20.0)
# Viterbi launches of one receiver call: 11a data; 11n HT-SIG and data;
# 11b none
LAUNCHES_PER_CALL = {"a": 1, "n": 2, "b": 0}
# the exact fields held equal between two runs of one batch (those the
# receiver returns), and the bytes of each ok row up to its length
EXACT_KEYS = ("ok", "fcs_ok", "sig_ok", "cs_ok", "plcp_ok", "rate_mbps",
              "mcs", "length", "lts1", "truncated", "signal", "preamble")


@dataclass
class Batch:
    """One receiver call of a suite: ``rx(x, *args, **kwargs)`` of
    ``phy/dot11{phy}/rx.py`` on the host samples ``x``, with each row's
    true PSDU and, where the suite checks it, its rate or MCS."""
    name: str
    phy: str
    fn: str
    x: np.ndarray
    psdus: list
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    rates: list | None = None      # rate_mbps (11a, 11b) or mcs (11n)


def _rng(rng):
    return np.random.default_rng(SEED) if rng is None else rng


def multipath(w: np.ndarray, taps) -> np.ndarray:
    """An explicit complex FIR channel [(delay, coeff), ...]."""
    n = len(w) + max(d for d, _ in taps)
    y = np.zeros(n, np.complex128)
    for d, c in taps:
        y[d: d + len(w)] += c * w
    return y.astype(np.complex64)


def noisy(x: np.ndarray, snr_db: float, rng) -> np.ndarray:
    """x plus complex AWGN at ``snr_db`` below its nonzero samples' power."""
    sig_p = float(np.mean(np.abs(x[np.abs(x) > 0]) ** 2))
    sigma = np.sqrt(sig_p / (2.0 * 10 ** (snr_db / 10.0)))
    return (x + sigma * (rng.normal(size=x.shape)
                         + 1j * rng.normal(size=x.shape))).astype(
        np.complex64)


def _awgn(rng, shape, sigma):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64) * sigma


def _frame(rng, size: int, seq: int) -> bytes:
    from sora_tpu_torch.mac.frame import build_data_frame

    return build_data_frame(bytes(rng.integers(0, 256, size,
                                               dtype=np.uint8)), seq=seq)


def _psdu(rng, n: int) -> bytes:
    """Arbitrary MAC-ish bytes with a valid FCS; n = PSDU length >= 5."""
    from sora_tpu_torch.mac.frame import append_fcs

    return append_fcs(bytes(rng.integers(0, 256, n - 4, dtype=np.uint8)))


def _cfo_ppm(ppm: float) -> float:
    """The carrier offset that comes with a ``ppm`` clock at 5.24 GHz, in
    rad/sample at 20 Msps."""
    return 2 * np.pi * (5.24e9 * ppm * 1e-6) / 20e6


# ---- tests/test_channel.py --------------------------------------------------


def channel_11a(rate: int, rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11a_np as g

    rng = _rng(rng)
    psdu = _frame(rng, 200, 1)
    w = multipath(g.modulate(psdu, rate), TAPS)
    x = np.zeros((1, len(w) + 300), np.complex64)
    x[0, 50: 50 + len(w)] = w
    x = x * np.exp(1j * 2 * np.pi * 80e3 / 20e6 * np.arange(x.shape[1]))
    x += _awgn(rng, x.shape, 0.01)
    return Batch(f"11a multipath {rate} Mbps", "a", "rx_pipeline",
                 x.astype(np.complex64), [psdu], (rate,),
                 {"max_psdu": 256})


def channel_11a_sfo(rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11a_np as g

    rng = _rng(rng)
    psdu = _frame(rng, 1200, 2)
    w = sfo_resample(multipath(g.modulate(psdu, 12), TAPS), 20.0)
    x = np.zeros((1, len(w) + 300), np.complex64)
    x[0, 60: 60 + len(w)] = w
    x += _awgn(rng, x.shape, 0.01)
    return Batch("11a multipath + 20 ppm SFO 12 Mbps", "a", "rx_pipeline",
                 x, [psdu], (12,), {"max_psdu": 1280})


def channel_11n(mcs: int, rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11n_np as gn

    rng = _rng(rng)
    psdu = _frame(rng, 140, 3)
    w = np.asarray(gn.modulate(psdu, mcs))           # (2, n)
    delays = [0, 4, 9]
    n = w.shape[1] + max(delays)
    y = np.zeros((2, n), np.complex128)
    for d in delays:
        while True:
            H = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                 ) / (2.0 if d else np.sqrt(2.0))
            if d or abs(np.linalg.det(H)) > 0.3:
                break
        y[:, d: d + w.shape[1]] += H @ w
    x = np.zeros((1, 2, n + 300), np.complex64)
    x[0, :, 40: 40 + n] = y
    x += _awgn(rng, x.shape, 0.01)
    return Batch(f"11n 2x2 multipath MCS {mcs}", "n", "rx_pipeline", x,
                 [psdu], (mcs,), {"max_psdu": 256})


def channel_11b(rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11b_np as gb

    rng = _rng(rng)
    psdu = _frame(rng, 60, 4)
    w = multipath(gb.modulate(psdu, 2), [(0, 1.0),
                                         (2, 0.25 * np.exp(1.1j))])
    x = np.zeros((1, len(w) + 400), np.complex64)
    x[0, 60: 60 + len(w)] = w
    x += _awgn(rng, x.shape, 0.01)
    return Batch("11b two-ray 2 Mbps", "b", "rx_pipeline_auto", x, [psdu],
                 kwargs={"max_psdu": len(psdu)})


# ---- tests/test_sfo.py ------------------------------------------------------


def sfo_11a(ppm: float, rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11a_np as g
    from sora_tpu_torch.phy import common as C

    rng = _rng(rng)
    rates = sorted(C.RATES)
    psdu = _frame(rng, MTU_PAYLOAD, 1)
    waves = [sfo_resample(g.modulate(psdu, r).astype(np.complex64), ppm)
             for r in rates]
    N = max(len(w) for w in waves) + 400
    x = np.zeros((len(rates), N), np.complex64)
    for i, w in enumerate(waves):
        x[i, 60: 60 + len(w)] = w
    x = x * np.exp(1j * _cfo_ppm(ppm) * np.arange(N))
    x = noisy(x, 30.0, rng)
    return Batch(f"11a {ppm:+g} ppm MTU, 8 rates", "a", "rx_pipeline_auto",
                 x, [psdu] * len(rates), rates=rates)


def sfo_11n(ppm: float, rng=None) -> Batch:
    import torch

    from sora_tpu_torch.phy import dot11n_common as NC
    from sora_tpu_torch.phy.dot11n import tx as ntx

    rng = _rng(rng)
    mcs_list = sorted(NC.MCS)
    psdu = _frame(rng, MTU_PAYLOAD, 2)
    arr = torch.from_numpy(np.frombuffer(psdu, np.uint8)[None, :].copy())
    waves = [ntx.modulate(arr, m, len(psdu))[0].numpy() for m in mcs_list]
    N = max(w.shape[-1] for w in waves) + 400
    x = np.zeros((len(mcs_list), 2, N), np.complex64)
    for i, w in enumerate(waves):
        for a in range(2):
            r = sfo_resample(w[a].astype(np.complex64), ppm)
            x[i, a, 60: 60 + len(r)] = r
    x = x * np.exp(1j * _cfo_ppm(ppm) * np.arange(N))
    x = noisy(x, 33.0, rng)
    return Batch(f"11n {ppm:+g} ppm MTU, MCS 8-15", "n", "rx_pipeline_auto",
                 x, [psdu] * len(mcs_list), rates=mcs_list)


def sfo_11a_slope(rng=None) -> Batch:
    """The +20 ppm 6 Mbps MTU frame that decodes only with pilot-slope
    tracking."""
    from sora_tpu_torch.golden import dot11a_np as g

    rng = _rng(rng)
    psdu = _frame(rng, MTU_PAYLOAD, 3)
    w = sfo_resample(g.modulate(psdu, 6).astype(np.complex64), 20.0)
    x = np.zeros((1, len(w) + 200), np.complex64)
    x[0, 60: 60 + len(w)] = w
    x = noisy(x, 30.0, rng)
    return Batch("11a +20 ppm MTU 6 Mbps", "a", "rx_pipeline", x, [psdu],
                 (6,))


# ---- tests/test_fuzz_loopback.py --------------------------------------------


def fuzz_11a(rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11a_np as g
    from sora_tpu_torch.phy import common as C

    rng = _rng(rng)
    rates = sorted(C.RATES)
    n = 24
    lens = [5, 6, 7, 14, 29, 63, 64, 65, 127, 255, 256, 400] + \
        list(rng.integers(5, 600, n - 12))
    psdus, waves, used = [], [], []
    for i in range(n):
        r = rates[int(rng.integers(0, 8))]
        p = _psdu(rng, int(lens[i]))
        psdus.append(p)
        used.append(r)
        waves.append(g.modulate(p, r).astype(np.complex64))
    N = max(len(w) for w in waves) + 300
    x = np.zeros((n, N), np.complex64)
    for i, w in enumerate(waves):
        x[i, 40 + int(rng.integers(0, 90)):][: len(w)] = w
    x += _awgn(rng, x.shape, 0.01)
    return Batch("11a fuzz, 24 lengths x rates", "a", "rx_pipeline_auto",
                 x, psdus, kwargs={"max_psdu": 600}, rates=used)


def fuzz_11b(rng=None) -> Batch:
    from sora_tpu_torch.golden import dot11b_np as gb

    rng = _rng(rng)
    combos = []
    for _ in range(16):
        rate = [1, 2, 5.5, 11][int(rng.integers(0, 4))]
        pre = "short" if (rate != 1 and rng.integers(0, 2)) else "long"
        # odd AND even lengths; 11 Mbps exercises the length-extension bit
        ln = int(rng.integers(5, 220))
        combos.append((rate, pre, ln))
    combos += [(11, "long", 5), (11, "short", 137), (5.5, "long", 6),
               (2, "short", 7), (1, "long", 5)]
    psdus, waves = [], []
    for rate, pre, ln in combos:
        p = _psdu(rng, ln)
        psdus.append(p)
        waves.append(gb.modulate(p, rate, preamble=pre).astype(
            np.complex64))
    n = len(combos)
    N = max(len(w) for w in waves) + 400
    x = np.zeros((n, N), np.complex64)
    for i, w in enumerate(waves):
        x[i, 50 + int(rng.integers(0, 60)):][: len(w)] = w
    x += _awgn(rng, x.shape, 0.01)
    return Batch("11b fuzz, 21 rates x preambles x lengths", "b",
                 "rx_pipeline_auto", x, psdus, kwargs={"max_psdu": 256},
                 rates=[c[0] for c in combos])


def fuzz_11n(rng=None) -> list:
    """Two batches from one generator: 12 frames of MCS 8-15 through
    ``rx_pipeline_auto``, then 12 of MCS 0-7 through
    ``rx_pipeline_auto_1ss``."""
    from sora_tpu_torch.golden import dot11n_np as gn

    rng = _rng(rng)

    def chan(nss):
        while True:
            h = (rng.normal(size=(2, nss)) + 1j * rng.normal(size=(2, nss))
                 ) / np.sqrt(2.0)
            if nss == 1 and np.abs(h).min() > 0.25:
                return h
            if nss == 2 and abs(np.linalg.det(h)) > 0.3:
                return h

    out = []
    for mcs_pool, fn in ((list(range(8, 16)), "rx_pipeline_auto"),
                         (list(range(8)), "rx_pipeline_auto_1ss")):
        combos = [(mcs_pool[int(rng.integers(0, 8))],
                   int(rng.integers(5, 320))) for _ in range(10)]
        combos += [(mcs_pool[0], 5), (mcs_pool[-1], 319)]
        psdus, ys = [], []
        for mcs, ln in combos:
            p = _psdu(rng, ln)
            psdus.append(p)
            w = np.asarray(gn.modulate(p, mcs))
            ys.append(chan(w.shape[0]) @ w)
        n = len(combos)
        N = max(y.shape[1] for y in ys) + 300
        x = np.zeros((n, 2, N), np.complex64)
        for i, y in enumerate(ys):
            off = 40 + int(rng.integers(0, 60))
            x[i, :, off: off + y.shape[1]] = y
        x += _awgn(rng, x.shape, 0.008)
        out.append(Batch(f"11n fuzz, 12 lengths x MCS {mcs_pool[0]}-"
                         f"{mcs_pool[-1]}", "n", fn, x, psdus,
                         kwargs={"max_psdu": 384},
                         rates=[c[0] for c in combos]))
    return out


def garbage(rng=None) -> list:
    """Loud noise, zeros, a constant and a pure tone, 5000 samples each."""
    rng = _rng(rng)
    return [
        (rng.normal(size=5000) + 1j * rng.normal(size=5000)).astype(
            np.complex64) * 3.0,
        np.zeros(5000, np.complex64),
        np.ones(5000, np.complex64) * (1 + 1j),
        np.exp(2j * np.pi * 0.1 * np.arange(5000)).astype(np.complex64),
    ]


GARBAGE_NAMES = ("noise", "zeros", "constant", "tone")


def batches() -> list:
    """Every batch of the three suites, in their order."""
    return ([channel_11a(r) for r in CHANNEL_RATES] + [channel_11a_sfo()]
            + [channel_11n(m) for m in CHANNEL_MCS] + [channel_11b()]
            + [sfo_11a(p) for p in SFO_PPM] + [sfo_11n(p) for p in SFO_PPM]
            + [sfo_11a_slope(), fuzz_11a(), fuzz_11b()] + fuzz_11n())


# ---- running and checking ---------------------------------------------------


def receiver(phy: str):
    """The port's receiver module of a phy."""
    import importlib

    return importlib.import_module(f"sora_tpu_torch.phy.dot11{phy}.rx")


def run(batch: Batch, device=None) -> dict:
    """The batch through the port's receiver on ``device`` (default cuda):
    its outputs as host arrays."""
    from sora_tpu_torch.util.xfer import device_complex, fetch

    fn = getattr(receiver(batch.phy), batch.fn)
    return fetch(fn(device_complex(batch.x, device), *batch.args,
                    **batch.kwargs))


def demodulate_garbage(x: np.ndarray, device=None) -> dict:
    """One garbage input through every ``demodulate`` (11n on two equal
    antennas): {phy: RxResult}."""
    return {"a": receiver("a").demodulate(x, device=device),
            "b": receiver("b").demodulate(x, device=device),
            "n": receiver("n").demodulate(np.stack([x, x]), device=device)}


def truth_errors(batch: Batch, out: dict) -> list:
    """Where the outputs break the suite's truth: every row ok, with its
    true rate or MCS, length and bytes."""
    key = "mcs" if batch.phy == "n" else "rate_mbps"
    bad = []
    for i, p in enumerate(batch.psdus):
        n = int(out["length"][i])
        if not out["ok"][i]:
            bad.append(f"row {i}: not ok")
        elif n != len(p) or bytes(out["psdu"][i][:n]) != p:
            bad.append(f"row {i}: length {n} of {len(p)} or bytes differ")
        elif batch.rates is not None and out[key][i] != batch.rates[i]:
            bad.append(f"row {i}: {key} {out[key][i]} not "
                       f"{batch.rates[i]}")
    return bad


def exact_errors(got: dict, want: dict) -> list:
    """The exact fields (and the bytes of each ok row up to its length)
    where two runs of one batch differ."""
    bad = [k for k in EXACT_KEYS if k in want
           and not np.array_equal(got[k], want[k])]
    ok = np.asarray(want["ok"]).astype(bool)
    for i in np.flatnonzero(ok):
        n = int(want["length"][i])
        if not np.array_equal(got["psdu"][i][:n], want["psdu"][i][:n]):
            bad.append(f"psdu row {i}")
    return bad
