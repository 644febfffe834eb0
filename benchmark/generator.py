"""The benchmark's one traffic generator: it reads a mix file from
``benchmark/traffic/`` and builds the pool of input batches from the seed.

Two layouts, chosen by the file's ``layout``:

* ``"streams"``: B streams, each holding one frame of the pool at offset
  ``base + (step * i) % mod`` (bench.py's saturated batches), followed by
  ``tail`` samples; the stream length is the longest frame plus the
  largest offset's room, so every stream of a batch has the same length;
* ``"air"``: one air stream of frames separated by ``gap`` idle samples,
  starting at a seeded phase, cut into B windows of ``window`` samples
  every ``hop`` samples (the node's windows).

Frames come from a pool of ``frames`` distinct PSDUs (24-byte MAC header,
seeded random payload, FCS), modulated by the configuration's frozen
golden transmitter; frame pool entry i uses ``formats[i % len(formats)]``
so every seed sends the same set of rates and lengths.  With ``mixing``
``"unitary"`` each stream passes through its own seeded random unitary
(flat) channel from the TX chains to the RX antennas.  Complex Gaussian
noise of ``noise`` per part is drawn on the device from a seeded
``torch.Generator``.  The same seed gives the same batches on one device.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.golden import frame as gframe


@dataclass
class Batch:
    """One input batch and what was sent in it."""

    x: torch.Tensor            # (B, A, N) complex64 on the device
    truth: dict                # layout-specific, numpy
    samples: int               # B * N: samples per antenna
    row_steps: np.ndarray      # (B,) trellis steps each row's frames need

    @property
    def steps(self) -> int:
        return int(self.row_steps.sum())


@dataclass
class Traffic:
    batches: list
    psdus: list                # the frame pool's PSDUs (np.uint8 arrays)
    formats: list              # (rate or MCS, bytes) of each pool frame


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number (negative or above 64 bits too) as a seed."""
    return np.random.SeedSequence(int(seed) % (1 << 64))


def _torch_seed(ss: np.random.SeedSequence) -> int:
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def phy_module(config: dict):
    """The configuration's PHY adapter, ``benchmark.phy.<phy>``."""
    return importlib.import_module(f"benchmark.phy.{config['phy']}")


def frame_pool(mix: dict, phy, ss: np.random.SeedSequence):
    """(psdus, formats, waves): the pool's PSDUs, their (rate, bytes) and
    their waveforms (chains, L) complex128 from the frozen transmitter."""
    rng = np.random.default_rng(ss)
    fmts = [tuple(f) for f in mix["formats"]]
    psdus, formats, waves = [], [], []
    for i in range(mix["frames"]):
        rate, nbytes = fmts[i % len(fmts)]
        payload = rng.integers(0, 256, nbytes - 28, dtype=np.uint8)
        psdu = np.frombuffer(gframe.build_data_frame(payload.tobytes(),
                                                     seq=i & 0xFFF),
                             np.uint8)
        psdus.append(psdu)
        formats.append((rate, nbytes))
        waves.append(np.atleast_2d(phy.modulate(psdu.tobytes(), rate)))
    return psdus, formats, waves


def _noise(shape, sigma: float, ss, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(_torch_seed(ss))
    n = torch.randn(shape + (2,), generator=g, device=device)
    return torch.view_as_complex(n) * sigma


def _unitary(rng, B: int, n: int) -> np.ndarray:
    """B Haar-random n x n unitaries (QR of complex Gaussians, phases
    fixed by R's diagonal)."""
    z = (rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))) \
        / np.sqrt(2.0)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    return q * (d / np.abs(d))[:, None, :]


def _place(table: torch.Tensor, fidx, starts, N: int) -> torch.Tensor:
    """(R, chains, N) rows holding frame table[fidx[r]] at starts[r]
    (zeros elsewhere).  table: (P, chains, L + 1) with a zero last
    column."""
    dev = table.device
    L = table.shape[-1] - 1
    pos = torch.arange(N, device=dev)[None, :] - torch.as_tensor(
        starts, device=dev)[:, None]
    pos = torch.where((pos >= 0) & (pos < L), pos, L)
    src = table[torch.as_tensor(fidx, device=dev)]
    return src.gather(2, pos[:, None, :].expand(-1, src.shape[1], -1))


def _streams(mix, phy, waves, formats, ss_batch, device) -> Batch:
    B = mix["streams"]
    base, step, mod = (mix["offset"][k] for k in ("base", "step", "mod"))
    L = max(w.shape[-1] for w in waves)
    N = L + mix["tail"]
    if base + mod - 1 + L > N:
        raise ValueError(f"offsets up to {base + mod - 1} do not fit a "
                         f"{L}-sample frame in {N} samples")
    rng = np.random.default_rng(ss_batch.spawn(1)[0])
    fidx = rng.integers(0, len(waves), B)
    starts = base + (step * np.arange(B)) % mod
    chains = waves[0].shape[0]
    table = np.zeros((len(waves), chains, L + 1), np.complex64)
    for i, w in enumerate(waves):
        table[i, :, : w.shape[-1]] = w
    x = _place(torch.as_tensor(table, device=device), fidx, starts, N)
    if mix.get("mixing") == "unitary":
        U = _unitary(rng, B, phy.ANTENNAS)
        x = torch.einsum("bij,bjn->bin",
                         torch.as_tensor(U.astype(np.complex64),
                                         device=device), x)
    x = x + _noise(tuple(x.shape), mix["noise"], ss_batch, device)
    steps = np.array([phy.steps(*formats[f]) for f in fidx], np.int64)
    return Batch(x.contiguous(), {"fidx": fidx, "starts": starts},
                 B * N, steps)


def _air(mix, phy, waves, formats, ss_batch, device) -> Batch:
    B, win, hop, gap = (mix[k] for k in ("streams", "window", "hop", "gap"))
    n_air = win + hop * (B - 1)
    rng = np.random.default_rng(ss_batch.spawn(1)[0])
    L = max(w.shape[-1] for w in waves)
    period = L + gap
    phase = int(rng.integers(0, period))
    starts = np.arange(phase, n_air - L + 1, period)
    fidx = rng.integers(0, len(waves), len(starts))
    chains = waves[0].shape[0]
    table = np.zeros((len(waves), chains, L + 1), np.complex64)
    for i, w in enumerate(waves):
        table[i, :, : w.shape[-1]] = w
    tab = torch.as_tensor(table, device=device)
    air = torch.zeros(chains, n_air, dtype=torch.complex64, device=device)
    span = torch.arange(L, device=device)
    for f in range(len(waves)):         # one scatter per pool frame
        sel = np.flatnonzero(fidx == f)
        if sel.size:
            at = (torch.as_tensor(starts[sel], device=device)[:, None]
                  + span[None, :]).reshape(-1)
            air[:, at] = tab[f, :, :L].repeat(1, sel.size)
    air = air + _noise((chains, n_air), mix["noise"], ss_batch, device)
    x = air.unfold(-1, win, hop).permute(1, 0, 2).contiguous()   # (B, A, win)
    wstart = np.arange(B) * hop
    steps = np.zeros(B, np.int64)
    for s, f in zip(starts, fidx):      # frames wholly inside a window
        rel = s - wstart
        inside = (rel >= 0) & (rel + waves[f].shape[-1] <= win)
        steps += inside * phy.steps(*formats[f])
    truth = {"fidx": fidx, "starts": starts, "wstart": wstart,
             "lengths": np.array([waves[f].shape[-1] for f in fidx])}
    return Batch(x, truth, B * win, steps)


LAYOUTS = {"streams": _streams, "air": _air}


def build(mix: dict, config: dict, seed: int, device) -> Traffic:
    """The pool of ``mix["pool"]`` input batches for ``seed``."""
    phy = phy_module(config)
    ss = seed_sequence(seed)
    ss_frames, *ss_batches = ss.spawn(1 + mix["pool"])
    psdus, formats, waves = frame_pool(mix, phy, ss_frames)
    make = LAYOUTS[mix["layout"]]
    batches = [make(mix, phy, waves, formats, s, device) for s in ss_batches]
    return Traffic(batches, psdus, formats)
