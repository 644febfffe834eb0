"""Device-resident software air: the real-time path of the live node
(port of ``sora_tpu.runtime.device_air``, phy "a", "b" and "n").

The reference's defining claim is sustained real-time 802.11 processing
(processing cost / signal duration < 1.0, kernel/bb/demod11/
MACStopwatch.h:37-60).  Here the air lives in device memory, as the
reference's RCB DMA ring keeps samples off the PCIe bus:

* a **waveform cache** (pre-modulated PSDUs, the reference's signal cache
  _signal_cache.c) sits on the card;
* each **round** advances the air by ``hop * batch`` samples: the round's
  transmissions (entry, offset, amplitude descriptors — a few KB up)
  are scattered into the air buffer, fresh receiver noise is added, the
  air is cut into overlapping windows and every receiver runs
  ``rx_pipeline_auto`` on them.  Only decoded headers and per-candidate
  metadata come back;
* an **air carry** (window overlap + one cache entry's length) threads
  rounds on the card, so the air is a gapless sample stream: frames
  straddling a round boundary decode in the next round's first window;
* with ``n_receivers=2`` the same air is decoded through two independent
  receiver noise draws (two nodes sharing a channel);
* phy "b" is an 11 Msps chip stream: each window runs the mixed-rate
  DSSS receiver, which locks on the window's first energy burst;
* phy "n" carries two antennas: the cache holds (2, L) per-chain pairs,
  the carry is (2, carry_len) and each window runs the 2x2 mixed-MCS
  receiver.

A round makes no host sync: the descriptors go up from pinned memory
without blocking and :meth:`DeviceAir.step` returns device tensors, so
the host can keep several rounds in flight.  The per-round noise comes
from a ``torch.Generator`` on the air's device seeded with ``seed`` (the
same seed gives the same rounds; the JAX package's ``jax.random`` draws
cannot be reproduced), while the initial carry is drawn with numpy
exactly as the JAX package draws it.

``BatchMac`` (host logic, copied) is the two-node conversation's MAC.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sora_tpu_torch.mac import frame as fr
from sora_tpu_torch.phy.dot11a import rx as arx
from sora_tpu_torch.phy.dot11a import tx as atx
from sora_tpu_torch.phy.dot11b import rx as brx
from sora_tpu_torch.phy.dot11n import rx as nrx
from sora_tpu_torch.util.xfer import device_complex, resolve_device, upload


class DeviceAir:
    """Continuous device-resident air + one air -> RX pass per round.

    waves: list of host complex waveforms (the TX cache; entry i is
    referenced by descriptors) — 1-D for phy "a" and "b", (2, n)
    per-chain pairs for phy "n" (the air carries an antenna axis).  All
    waves are zero-padded to a common length L (a multiple of 256) on the
    device; complex amplitude scaling happens per transmission descriptor
    (a multipath tap is just an extra delayed descriptor).

    phy selects the per-window decoder: "a" = the 11a ``rx_pipeline_auto``
    with multi-onset candidates and the ``min_rate_mbps`` cap; "b" = the
    11 Msps DSSS ``rx_pipeline_auto`` (first-burst lock); "n" = the 2x2
    HT ``rx_pipeline_auto`` (first-plateau lock, with the ``min_mcs``
    cap).  "b" and "n" lock one onset per window, so ``n_frames`` is 1,
    and these single-candidate chains carry a geometry contract: the
    scheduler keeps hop <= inter-frame gap (every frame has a window
    starting in its preceding gap) and overlap >= frame span
    (containment).  Runs on ``device`` (default cuda; raises without CUDA
    unless ``device="cpu"``).
    """

    def __init__(self, waves, *, window: int = 32768, batch: int = 64,
                 overlap: int = 6144, n_frames: int = 8,
                 n_decode: int = 0, slots: int = 384,
                 noise_rms: float = 0.02, max_psdu: int = 1504,
                 hdr_bytes: int = 64, n_receivers: int = 1,
                 min_rate_mbps: int = 6, min_mcs: int = 8,
                 pad_len: int = 0, n_entries: int = 0, phy: str = "a",
                 seed: int = 0, device=None):
        if phy not in ("a", "b", "n"):
            raise ValueError(f"unknown phy {phy!r}")
        if not 0 <= overlap < window:
            raise ValueError(f"overlap {overlap} must be in [0, {window})")
        self.device = dev = resolve_device(device)
        self.phy = phy
        self.n_ant = A = 2 if phy == "n" else 1
        if phy in ("b", "n"):
            n_frames = 1      # these chains lock one onset per window;
            #                   the overlap covers the rest
        self.window, self.batch, self.overlap = window, batch, overlap
        self.hop = window - overlap
        self.nsamp = window + self.hop * (batch - 1)
        self.advance = self.hop * batch           # air samples per round
        self.slots = slots
        self.noise_rms = float(noise_rms)
        self.max_psdu = max_psdu
        self.hdr_bytes = hdr_bytes
        self.n_frames = n_frames
        self.n_decode = n_decode
        self.n_receivers = n_receivers
        self.min_rate_mbps = min_rate_mbps    # 11a air floor (Mbps)
        self.min_mcs = min_mcs                # HT air floor (MCS index)
        waves = [np.atleast_2d(np.asarray(w, np.complex64)) for w in waves]
        L = max([w.shape[1] for w in waves] + [pad_len])
        self.L = L = -(-L // 256) * 256
        n_entries = max(n_entries, len(waves))
        cache = np.zeros((n_entries, A, L), np.complex64)
        for i, w in enumerate(waves):
            if w.shape[0] != A:
                raise ValueError(f"wave {i} has {w.shape[0]} chains; phy "
                                 f"{phy!r} carries {A}")
            cache[i, :, : w.shape[1]] = w
        self._cache = device_complex(cache, dev)
        self.carry_len = self.nsamp - self.advance + L    # overlap + L
        rng = np.random.default_rng(seed)
        carry0 = (rng.normal(size=(A, self.carry_len))
                  + 1j * rng.normal(size=(A, self.carry_len))) * (
                      self.noise_rms / np.sqrt(2.0))
        self._carry = device_complex(carry0.astype(np.complex64), dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self._lane = torch.arange(L, device=dev)
        self.base = 0                 # global sample index of air[0]
        self.round_idx = 0

    def set_entries(self, idxs, waves) -> None:
        """Re-stage waveform cache entries on the card from host waves."""
        if not len(idxs):
            return
        w = np.zeros((len(idxs), self.n_ant, self.L), np.complex64)
        for k, wv in enumerate(waves):
            wv = np.atleast_2d(np.asarray(wv, np.complex64))
            if wv.shape[1] > self.L:
                raise ValueError(f"wave of {wv.shape[1]} samples exceeds "
                                 f"the cache length {self.L}")
            w[k, :, : wv.shape[1]] = wv
        ix = upload(np.asarray(idxs, np.int64), self.device)
        self._cache.index_copy_(0, ix, upload(w, self.device))

    def stage_tx(self, idxs, psdus, rate: int) -> None:
        """Modulate PSDUs on the card (``phy.dot11a.tx.modulate``) straight
        into the waveform cache — what a live node's TX path does; only
        the PSDU bytes go up.  All PSDUs in a call share one length."""
        if not len(idxs):
            return
        if self.phy != "a":
            raise ValueError("on-card TX staging is the OFDM (phy 'a') path")
        psdus = np.asarray(psdus, np.uint8)
        plen = int(psdus.shape[1])
        if atx.waveform_len(rate, plen) > self.L:
            raise ValueError(f"a {plen}-byte frame at {rate} Mbps exceeds "
                             f"the cache length {self.L}")
        w = atx.modulate(upload(psdus, self.device), rate, plen)
        wp = torch.zeros(len(idxs), self.n_ant, self.L, dtype=w.dtype,
                         device=self.device)
        wp[:, 0, : w.shape[1]] = w
        ix = upload(np.asarray(idxs, np.int64), self.device)
        self._cache.index_copy_(0, ix, wp)

    # ---- the round ----------------------------------------------------------

    def _air(self, descs: torch.Tensor) -> torch.Tensor:
        """The round's air (A, nsamp + L): the carry, every descriptor's
        scaled cache entry added at its offset, and fresh noise past the
        carry.  Sets the next round's carry."""
        A, L = self.n_ant, self.L
        n_air = self.nsamp + L
        air = torch.zeros(A, n_air, dtype=torch.complex64, device=self.device)
        air[:, : self.carry_len] = self._carry
        e = descs[:, 0].to(torch.int64)
        off = descs[:, 1].to(torch.int64).clamp(0, self.nsamp)
        # complex amplitude in milli-units; empty slots (entry < 0) add 0
        amp = torch.where(
            e >= 0, torch.complex(descs[:, 2].float(), descs[:, 3].float())
            * 1e-3, 0.0)
        w = self._cache[e.clamp(min=0)] * amp[:, None, None]   # (S, A, L)
        # the JAX package adds the slots one after another; one scatter-add
        # of all (slot, sample) pairs is the same sum, taken in another
        # order where descriptors overlap
        idx = (off[:, None] + self._lane[None, :]).reshape(-1)
        src = torch.view_as_real(w.transpose(0, 1).reshape(A, -1))
        torch.view_as_real(air).index_add_(1, idx, src)
        sigma = self.noise_rms / np.sqrt(2.0)
        fresh = self.carry_len
        nz = torch.randn(2, A, n_air - fresh, generator=self._gen,
                         device=self.device) * sigma
        air[:, fresh:] += torch.complex(nz[0], nz[1])
        self._carry = air[:, self.advance:].clone()
        return air

    def _receive(self, air: torch.Tensor) -> dict:
        """One receiver's decode of the round: its own front-end noise on
        top of the shared air, then the phy's ``rx_pipeline_auto`` on the
        windows (B, A, window)."""
        sigma = self.noise_rms / np.sqrt(2.0)
        wins = air.unfold(-1, self.window, self.hop)[:, : self.batch]
        wn = torch.randn(2, self.batch, self.n_ant, self.window,
                         generator=self._gen, device=self.device)
        xw = wins.transpose(0, 1) + torch.complex(wn[0], wn[1]) * (
            0.5 * sigma)
        if self.phy == "b":
            out = brx.rx_pipeline_auto(xw[:, 0], max_psdu=self.max_psdu)
            out["lts1"] = out["t0"]           # the window-relative anchor
        elif self.phy == "n":
            out = nrx.rx_pipeline_auto(xw, max_psdu=self.max_psdu,
                                       min_mcs=self.min_mcs)
        else:
            out = arx.rx_pipeline_auto(
                xw[:, 0], max_psdu=self.max_psdu, n_frames=self.n_frames,
                n_decode=self.n_decode, min_rate_mbps=self.min_rate_mbps)
        keep = {k: out[k] for k in ("ok", "det", "length", "rate_mbps",
                                    "snr_db", "lts1", "truncated", "src")
                if k in out}
        keep["hdr"] = out["psdu"][:, : self.hdr_bytes]
        return keep

    def step(self, tx: list[tuple[int, int, complex]]):
        """Advance one round.  tx: (entry, local offset, amplitude)
        transmissions whose starts lie in [0, nsamp); returns the list of
        per-receiver output dicts of device tensors (not waited for) plus
        this round's global base sample index."""
        if len(tx) > self.slots:
            raise ValueError(f"{len(tx)} transmissions exceed the "
                             f"{self.slots} descriptor slots")
        descs = np.full((self.slots, 4), -1, np.int32)
        for i, (e, off, amp) in enumerate(tx):
            if not 0 <= off < self.nsamp:
                raise ValueError(f"offset {off} outside [0, {self.nsamp})")
            if e >= self._cache.shape[0]:
                raise ValueError(f"entry {e} outside the "
                                 f"{self._cache.shape[0]}-entry cache")
            amp = complex(amp)
            descs[i] = (e, off, int(round(amp.real * 1000.0)),
                        int(round(amp.imag * 1000.0)))
        air = self._air(upload(descs, self.device))
        outs = [self._receive(air) for _ in range(self.n_receivers)]
        base = self.base
        self.base += self.advance
        self.round_idx += 1
        return outs, base

    def cand_pos(self, out: dict, base: int) -> np.ndarray:
        """Global air position of every candidate row (host arrays or
        tensors in ``out``)."""
        lts1 = np.asarray(_host(out["lts1"]))
        if "src" in out:
            w = np.asarray(_host(out["src"])) // self.n_frames
        else:
            w = np.arange(lts1.shape[0]) // self.n_frames
        return base + w * self.hop + lts1


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


# =============================================================================
# Batch-granularity MAC (the two-node conversation of the demo)
# =============================================================================


@dataclass
class BatchMacStats:
    sent: int = 0
    retransmits: int = 0
    delivered: int = 0         # receiver-side unique data frames
    acked: int = 0             # sender-side seqs confirmed
    rounds: int = 0


class BatchMac:
    """Stop-and-wait-window MAC at air-batch granularity.

    The sender streams sequenced data frames; the receiver returns ONE
    block-ack frame per round listing every sequence number it decoded
    (the batched analogue of 802.11 ACKs — at a ~86 ms batch RTT a
    per-frame SIFS ACK is meaningless, so this plays the role of
    802.11e BlockAck).  Unacked seqs retransmit after `timeout_rounds`.
    Frame loss (collisions, noise) is tolerated in both directions.
    """

    BA_MAGIC = b"BA"

    def __init__(self, addr: bytes, peer: bytes, *, n_seq: int,
                 payload: int = 1464, rate: int = 54,
                 timeout_rounds: int = 2, window_frames: int = 64,
                 ba_bits: int = 256):
        # bitmap span past the cumulative ack point: must cover the
        # in-flight window (>= window_frames) or a single loss freezes
        # the ack point and delivered-but-unackable frames retransmit
        self.BA_BITS = int(ba_bits)
        self.addr, self.peer = addr, peer
        self.n_seq = n_seq
        self.payload = payload
        self.rate = rate
        self.timeout = timeout_rounds
        self.window_frames = window_frames
        self.next_seq = 0
        self.outstanding: dict[int, int] = {}   # seq -> round sent
        self.acked: set[int] = set()
        self.rx_seqs: set[int] = set()
        self._ack_floor = 0        # cumulative ack point (amortized)
        self.new_rx: list[int] = []
        self.stats = BatchMacStats()

    # -- frame builders (host; modulated into the cache by the tool)
    DT_MAGIC = b"DT"

    def data_psdu(self, seq: int) -> bytes:
        hdr = fr.MacHeader(addr1=self.peer, addr2=self.addr,
                           seq_ctrl=(seq & 0xFFF) << 4)
        body = self.DT_MAGIC + seq.to_bytes(4, "little")
        body += bytes((self.payload - len(body)) * [seq & 0xFF])
        return fr.append_fcs(hdr.pack() + body)

    def block_ack_psdu(self) -> bytes:
        """Cumulative ack point + bitmap (TCP-SACK-style BlockAck):
        every seq below `start` is acked, plus bitmap bit k for
        start+k.  Fits inside the hdr peek the air returns."""
        start = self._ack_floor
        while start in self.rx_seqs:
            start += 1
        self._ack_floor = start
        bitmap = bytearray(self.BA_BITS // 8)
        for k in range(self.BA_BITS):
            if start + k in self.rx_seqs:
                bitmap[k // 8] |= 1 << (k % 8)
        hdr = fr.MacHeader(addr1=self.peer, addr2=self.addr)
        body = self.BA_MAGIC + start.to_bytes(4, "little") + bytes(bitmap)
        return fr.append_fcs(hdr.pack() + body)

    # -- per-round logic
    def want_tx_seqs(self, round_idx: int, budget: int,
                     span_limit: int | None = None) -> list[int]:
        """Sequence numbers to transmit this round (retries first).

        ``span_limit`` bounds next_seq - oldest_outstanding: with seq ->
        cache-entry mapping seq % span_limit, this guarantees no two
        in-flight seqs share an entry (the tool's staging discipline)."""
        out = []
        for s, r0 in sorted(self.outstanding.items()):
            if round_idx - r0 >= self.timeout and len(out) < budget:
                out.append(s)
                self.outstanding[s] = round_idx
                self.stats.retransmits += 1
        oldest = min(self.outstanding) if self.outstanding else None
        while (len(out) < budget and self.next_seq < self.n_seq
               and len(self.outstanding) < self.window_frames
               and (span_limit is None or oldest is None
                    or self.next_seq - oldest < span_limit)):
            out.append(self.next_seq)
            self.outstanding[self.next_seq] = round_idx
            if oldest is None:
                oldest = self.next_seq
            self.next_seq += 1
        self.stats.sent += len(out)
        return out

    def consume(self, headers: np.ndarray, ok: np.ndarray) -> None:
        """Feed decoded candidate rows (hdr byte peeks + ok flags)."""
        self.new_rx = []
        for i in range(len(ok)):
            if not ok[i]:
                continue
            h = bytes(headers[i])
            if len(h) < 30:
                continue
            mh = fr.MacHeader.unpack(h[:24])
            if mh.addr1 != self.addr or mh.addr2 != self.peer:
                continue
            body = h[24:]
            if body[:2] == self.BA_MAGIC:        # block-ack for us
                start = int.from_bytes(body[2:6], "little")
                bitmap = body[6: 6 + self.BA_BITS // 8]

                def _ack(s):
                    self.outstanding.pop(s, None)
                    if s not in self.acked:
                        self.acked.add(s)
                        self.stats.acked += 1

                for s in [q for q in self.outstanding if q < start]:
                    _ack(s)
                for k in range(8 * len(bitmap)):
                    if bitmap[k // 8] & (1 << (k % 8)):
                        _ack(start + k)
            elif body[:2] == self.DT_MAGIC:       # data frame
                seq = int.from_bytes(body[2:6], "little")
                if seq not in self.rx_seqs:
                    self.rx_seqs.add(seq)
                    self.stats.delivered += 1
                    self.new_rx.append(seq)
        self.stats.rounds += 1

    @property
    def done(self) -> bool:
        return len(self.acked) >= self.n_seq
