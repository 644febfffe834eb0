"""Virtual air: a slotted half-duplex radio channel for MAC testing.
(The port's own copy of ``sora_tpu.runtime.air``.)

The reference tests its MAC against real RF (umxsdrbrick node ↔ node,
SURVEY.md §4.6); we add what it lacks — a deterministic software channel.
Nodes attach, schedule waveforms, and sense the medium; overlapping
transmissions sum (collisions corrupt both, and the PHY's FCS check
rejects them naturally).  Time advances in 802.11 slots.

This plays the role of the RCB + RF path in the reference stack
(kernel/core/src/_tx_manager2.c fire -> air -> RX DMA ring): the MAC and
PHY code above it is identical for synthetic and real front ends.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SAMPLE_RATE = 20e6
SLOT_US = 9.0
SLOT_SAMPLES = int(SLOT_US * SAMPLE_RATE / 1e6)       # 180


@dataclass
class _Tx:
    src: int
    start_slot: int
    wave: np.ndarray            # complex64, 1-D (SISO air)

    @property
    def end_slot(self) -> int:
        return self.start_slot + (-(-len(self.wave) // SLOT_SAMPLES))


class VirtualAir:
    """Slot-stepped shared medium.

    Nodes register a receive callback ``on_rx(samples: np.ndarray)`` that
    fires when a transmission (or collision group) completes; carrier
    sense is energy from any other node's in-flight transmission.
    """

    def __init__(self, snr_db: float = 30.0, seed: int = 0):
        self.slot = 0
        self.snr_db = snr_db
        self.rng = np.random.default_rng(seed)
        self._nodes: list = []
        self._inflight: list[_Tx] = []
        self.log: list[tuple] = []

    def attach(self, node) -> int:
        self._nodes.append(node)
        return len(self._nodes) - 1

    def transmit(self, src: int, wave: np.ndarray) -> None:
        w = np.asarray(wave, dtype=np.complex64).reshape(-1)
        self._inflight.append(_Tx(src, self.slot, w))
        self.log.append(("tx", self.slot, src, len(w)))

    def busy(self, exclude: int | None = None) -> bool:
        return any(t.src != exclude for t in self._inflight)

    def transmitting(self, src: int) -> bool:
        return any(t.src == src for t in self._inflight)

    def step(self) -> None:
        """Advance one slot; deliver any transmissions that completed."""
        self.slot += 1
        done = [t for t in self._inflight if t.end_slot <= self.slot]
        if not done:
            return
        # a completing transmission is delivered together with everything
        # that overlapped it (collision = superposition)
        group = list(done)
        for t in self._inflight:
            if t not in group and any(
                    t.start_slot < d.end_slot and d.start_slot < t.end_slot
                    for d in done):
                group.append(t)
        self._inflight = [t for t in self._inflight if t not in group]
        s0 = min(t.start_slot for t in group)
        s1 = max(t.end_slot for t in group)
        n = (s1 - s0 + 2) * SLOT_SAMPLES
        buf = np.zeros(n, dtype=np.complex64)
        for t in group:
            off = (t.start_slot - s0) * SLOT_SAMPLES
            buf[off: off + len(t.wave)] += t.wave
        p = float(np.mean(np.abs(buf) ** 2)) + 1e-12
        sigma = np.sqrt(p / (10 ** (self.snr_db / 10)) / 2)
        buf = buf + sigma * (
            self.rng.normal(size=n) + 1j * self.rng.normal(size=n)
        ).astype(np.complex64)
        collision = len(group) > 1
        self.log.append(("deliver", self.slot,
                         sorted(t.src for t in group), collision))
        srcs = {t.src for t in group}
        for i, node in enumerate(self._nodes):
            if i not in srcs:          # half duplex: a sender hears nothing
                node.on_rx(buf)
