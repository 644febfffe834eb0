"""Soft MAC: CSMA/CA with ACK, retransmission, BEB, and a signal cache.
(The port's own copy of ``sora_tpu.mac.csma``.)

Functional equivalent of the reference's umxsdrbrick MAC
(kernel/bb/umxsdrbrick/mac.cpp): `MAC11a_Receive` poll loop with
DIFS + binary-exponential backoff and ACK timeout (mac.cpp:190-280),
`MAC11_Send` pre-modulated fire (mac.cpp:293-345), and the precomputed-ACK
signal cache (kernel/core/src/_signal_cache.h:1-60 — waveforms keyed by
frame bytes so the SIFS deadline is met without re-modulating).

The MAC is PHY-agnostic: it takes ``modulate(psdu, rate) -> waveform`` and
``demodulate(samples) -> RxResult`` callables, so the golden numpy chain,
the torch chains, or a batched device pipeline all slot in unchanged.  Time is
driven by a VirtualAir (or any object with the same slot protocol).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from sora_tpu_torch.mac import mgmt
from sora_tpu_torch.mac.frame import MacHeader, build_ack_frame
from sora_tpu_torch.mac.fsm import Fsm

# 802.11a OFDM timing, expressed in 9 us slots (SIFS=16us~2, DIFS=34us~4)
SIFS_SLOTS = 2
DIFS_SLOTS = 4
ACK_TIMEOUT_SLOTS = 40
CW_MIN, CW_MAX = 15, 1023
RETRY_LIMIT = 7


class SignalCache:
    """Waveform cache keyed by (frame bytes, rate) — the _signal_cache.h
    analogue.  Bounded; LRU eviction."""

    def __init__(self, modulate: Callable, capacity: int = 64):
        self._mod = modulate
        self._cap = capacity
        self._store: dict[tuple[bytes, int], np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def get(self, psdu: bytes, rate: int) -> np.ndarray:
        key = (bytes(psdu), rate)
        w = self._store.pop(key, None)
        if w is None:
            self.misses += 1
            w = np.asarray(self._mod(psdu, rate))
        else:
            self.hits += 1
        self._store[key] = w                   # reinsert = most recent
        while len(self._store) > self._cap:
            self._store.pop(next(iter(self._store)))
        return w


@dataclass
class MacStats:
    tx_data: int = 0
    tx_ack: int = 0
    rx_data: int = 0
    rx_ack: int = 0
    rx_dup: int = 0
    rx_fcs_fail: int = 0
    retries: int = 0
    drops: int = 0
    beacons: int = 0


@dataclass
class _Pending:
    psdu: bytes
    dst: bytes
    retries: int = 0


class SoftMac:
    """One CSMA/CA station bound to a VirtualAir."""

    def __init__(self, addr: bytes, air, modulate: Callable,
                 demodulate: Callable, rate: int = 6,
                 ack_rate: int | None = None, name: str = ""):
        self.addr = bytes(addr)
        self.air = air
        self.rate = rate
        self.ack_rate = ack_rate if ack_rate is not None else rate
        self.cache = SignalCache(modulate)
        self.demod = demodulate
        self.stats = MacStats()
        self.rx_payloads: list[tuple[bytes, bytes]] = []   # (src, payload)
        self.node_id = air.attach(self)
        self.name = name or f"sta{self.node_id}"
        self._queue: list[_Pending] = []
        self._seq = 0
        self._cw = CW_MIN
        self._backoff = 0
        self._difs_left = 0
        self._timer = 0
        self._seen: set[tuple[bytes, int]] = set()
        self._pend_tx: list[tuple[int, np.ndarray]] = []   # (fire_slot, wave)
        self.fsm = Fsm("idle", name=self.name)
        for src, ev, dst in [
                ("idle", "queue", "difs"), ("difs", "busy", "difs"),
                ("difs", "idle_slot", "difs"), ("difs", "difs_done",
                                                "backoff"),
                ("backoff", "busy", "difs"), ("backoff", "idle_slot",
                                              "backoff"),
                ("backoff", "fire", "wait_ack"),
                ("wait_ack", "ack", "idle"), ("wait_ack", "timeout",
                                              "retry"),
                ("retry", "requeue", "difs"), ("retry", "drop", "idle"),
                ("idle", "tick", "idle"), ("wait_ack", "tick", "wait_ack")]:
            self.fsm.on(src, ev, dst)

    # -- upper interface ------------------------------------------------------

    def send(self, payload: bytes, dst: bytes) -> None:
        hdr = MacHeader(addr1=bytes(dst), addr2=self.addr, addr3=self.addr,
                        seq_ctrl=self._seq << 4)
        from sora_tpu_torch.mac.frame import append_fcs
        self._seq = (self._seq + 1) & 0xFFF
        self._queue.append(_Pending(append_fcs(hdr.pack() + payload),
                                    bytes(dst)))

    def send_beacon(self, bss: mgmt.Bss) -> None:
        psdu = mgmt.build_beacon(bss, timestamp_us=self.air.slot * 9,
                                 seq=self._seq)
        self._seq = (self._seq + 1) & 0xFFF
        # beacons are broadcast: fired after DIFS, no ACK expected
        self._queue.append(_Pending(psdu, b"\xff" * 6))
        self.stats.beacons += 1

    # -- slot clock (called once per air slot) --------------------------------

    def on_slot(self) -> None:
        # pre-staged transmissions whose fire time arrived (SIFS ACKs)
        still = []
        for fire_slot, wave in self._pend_tx:
            if self.air.slot >= fire_slot:
                self.air.transmit(self.node_id, wave)
                self.stats.tx_ack += 1
            else:
                still.append((fire_slot, wave))
        self._pend_tx = still

        st = self.fsm.state
        if st == "idle":
            if self._queue:
                self._difs_left = DIFS_SLOTS
                self.fsm.fire("queue")
            return
        if st == "difs":
            if self.air.busy(exclude=self.node_id) or \
                    self.air.transmitting(self.node_id):
                self._difs_left = DIFS_SLOTS
                self.fsm.fire("busy")
                return
            self._difs_left -= 1
            if self._difs_left > 0:
                self.fsm.fire("idle_slot")
                return
            self._backoff = int(
                np.random.default_rng(
                    (self.node_id + 1) * 7919 + self.air.slot).integers(
                        0, self._cw + 1))
            self.fsm.fire("difs_done")
            return
        if st == "backoff":
            if self.air.busy(exclude=self.node_id):
                self._difs_left = DIFS_SLOTS
                self.fsm.fire("busy")
                return
            if self._backoff > 0:
                self._backoff -= 1
                self.fsm.fire("idle_slot")
                return
            pend = self._queue[0]
            wave = self.cache.get(pend.psdu, self.rate)
            self.air.transmit(self.node_id, wave)
            self.stats.tx_data += 1
            if pend.dst == b"\xff" * 6:        # broadcast: no ACK
                self._queue.pop(0)
                self.fsm.fire("fire")
                self.fsm.fire("ack")
                self._cw = CW_MIN
                return
            self._timer = ACK_TIMEOUT_SLOTS + \
                -(-len(wave) // 180)
            self.fsm.fire("fire")
            return
        if st == "wait_ack":
            self._timer -= 1
            if self._timer <= 0:
                self.fsm.fire("timeout")
                pend = self._queue[0]
                pend.retries += 1
                self.stats.retries += 1
                if pend.retries > RETRY_LIMIT:
                    self._queue.pop(0)
                    self.stats.drops += 1
                    self._cw = CW_MIN
                    self.fsm.fire("drop")
                else:
                    self._cw = min(2 * self._cw + 1, CW_MAX)
                    self._difs_left = DIFS_SLOTS
                    self.fsm.fire("requeue")
            return

    # -- receive path (called by the air on delivery) --------------------------

    def on_rx(self, samples: np.ndarray) -> None:
        res = self.demod(samples)
        if not getattr(res, "fcs_ok", False):
            self.stats.rx_fcs_fail += 1
            return
        psdu = res.psdu
        ftype = mgmt.frame_type(psdu)
        if ftype == mgmt.FC_ACK:
            if psdu[4:10] == self.addr and self.fsm.state == "wait_ack":
                self.stats.rx_ack += 1
                self._queue.pop(0)
                self._cw = CW_MIN
                self.fsm.fire("ack")
            return
        hdr = MacHeader.unpack(psdu[:24])
        if hdr.addr1 not in (self.addr, b"\xff" * 6):
            return
        if hdr.addr1 == self.addr:
            # schedule the cached ACK one SIFS after the medium freed
            ack = build_ack_frame(hdr.addr2)
            wave = self.cache.get(ack, self.ack_rate)
            self._pend_tx.append((self.air.slot + SIFS_SLOTS, wave))
        key = (hdr.addr2, hdr.seq_ctrl)
        if key in self._seen:
            self.stats.rx_dup += 1
            return
        self._seen.add(key)
        if ftype == mgmt.FC_DATA:
            self.stats.rx_data += 1
            self.rx_payloads.append((hdr.addr2, psdu[24:-4]))
        else:
            self.stats.rx_data += 1
            self.rx_payloads.append((hdr.addr2, psdu))


def run_air(air, macs, n_slots: int) -> None:
    """Drive the air + stations for n_slots (the Dot11_main loop analogue,
    dot11main.cpp:365-457, with virtual time instead of threads)."""
    for _ in range(n_slots):
        for m in macs:
            m.on_slot()
        air.step()
