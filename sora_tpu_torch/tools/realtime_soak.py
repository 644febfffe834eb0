"""Sustained real-time demonstration on the device-resident air (port of
``tools/realtime_soak.py``, phy "a", "b" and "n").

The air lives in device memory (``runtime/device_air.py``): only TX
descriptors go up and decoded headers come down, so the live loop runs
at the card's speed and the wall-clock over air-time ratio is measured
end to end (the reference's MACStopwatch bar, MACStopwatch.h:37-60: real
time means a ratio below 1.0).

Modes:
  rx     (default) saturated RX soak, every scheduled frame decoded and
         position-matched.  --phy a: back-to-back 1492-byte 54 Mbps OFDM
         frames at 20 Msps.  --phy b: 278-byte 11 Mbps CCK frames at
         11 Msps chips, with gaps of 3100 chips (the first-burst DSSS lock
         needs hop <= gap).  --phy n: 1492-byte MCS 15 2x2 HT frames on a
         two-antenna air, with gaps of 8600 samples (the single-onset HT
         lock needs hop <= gap).  --channel (phy a) adds 4-tap in-CP
         multipath synthesized on the card (one descriptor per tap).
  convo  two-node conversation: A streams sequenced data frames to B, B
         block-acks every round, retries close the loop; both nodes'
         receivers run per round (independent noise).  The data frames
         are modulated on the card every round.

Usage (on a machine with a CUDA card):
    python3 -m sora_tpu_torch.tools.realtime_soak [--mode rx|convo]
        [--phy a|b|n] [--channel] [--seconds 62] [--depth 6]
        [--json out.json]

Prints progress every 5 s to stderr and a one-line JSON summary to
stdout.  The waveform cache comes from the port's own modulator.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from sora_tpu_torch.mac import frame as fr
from sora_tpu_torch.phy.dot11a import tx as atx
from sora_tpu_torch.phy.dot11b import tx as btx
from sora_tpu_torch.phy.dot11n import tx as ntx
from sora_tpu_torch.runtime.device_air import BatchMac, DeviceAir
from sora_tpu_torch.util.xfer import Pending, fetch, resolve_device, upload

SPS = 20e6
# the air's sample rate per phy: 11 Msps DSSS chips for phy "b"
PHY_SPS = {"a": SPS, "b": 11e6, "n": SPS}
# PSDU bytes of the rx soak's frames (the goodput figure)
SOAK_PSDU = {"a": 1492, "b": 278, "n": 1492}

# in-CP multipath taps for --channel mode: each transmission becomes one
# descriptor per tap (delayed offset, complex gain); the JAX package's
# runtime.radio.REF_TAPS
CH_TAPS = [(0, 1.0), (3, 0.45 * np.exp(0.9j)),
           (7, 0.2 * np.exp(-2.1j)), (11, 0.08 * np.exp(0.3j))]


# inter-frame gap and position-match tolerance of the rx soak, per phy
SOAK_GAP = {"a": 640, "b": 3100, "n": 8600}
SOAK_MATCH_TOL = {"a": 600, "b": 2500, "n": 2500}


def make_rx_soak_air(seed: int = 7, channel: bool = False, device=None,
                     phy: str = "a"):
    """The canonical saturated-soak air: 64 cached frames (modulated on
    ``device`` by the port's TX).  phy "a": 1492-byte 54 Mbps OFDM frames,
    64 windows of 32768 samples, overlap 6144, 7 candidates per window;
    ``channel`` widens the descriptor budget for tap-expanded TX.  phy
    "b": 278-byte 11 Mbps CCK frames (250-byte payloads) at 11 Msps chips,
    512 windows of 8192 chips, overlap 5120 (hop 3072 <= the soak's
    3100-chip gap; overlap >= the 4336-chip frame span), max_psdu 512.
    phy "n": 1492-byte MCS 15 2x2 HT on a two-antenna air, 512 windows
    of 11264, overlap 3072 (hop 8192 <= the soak's 8600-sample gap, so
    every frame has a window starting in its preceding gap; overlap >= the
    frame span), min_mcs 15, noise 0.01.  Returns (air, psdus, span)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    psdus = [fr.build_data_frame(
        bytes(rng.integers(0, 256, SOAK_PSDU[phy] - 28, dtype=np.uint8)),
        seq=i) for i in range(64)]
    arr = np.stack([np.frombuffer(p, np.uint8) for p in psdus])
    if phy == "b":
        waves = fetch(btx.modulate(upload(arr, dev), 11, arr.shape[1]))
        span = waves.shape[1]
        air = DeviceAir(list(waves), window=8192, batch=512, overlap=5120,
                        slots=384, noise_rms=0.02, max_psdu=512,
                        hdr_bytes=64, phy="b", seed=seed, device=dev)
        assert span <= air.overlap, (span, air.overlap)
        return air, psdus, span
    if phy == "n":
        waves = fetch(ntx.modulate(upload(arr, dev), 15, arr.shape[1]))
        span = waves.shape[-1]
        air = DeviceAir(list(waves), window=11264, batch=512, overlap=3072,
                        slots=512, noise_rms=0.01, max_psdu=1504,
                        hdr_bytes=64, phy="n", min_mcs=15, seed=seed,
                        device=dev)
        assert span <= air.overlap, (span, air.overlap)
        return air, psdus, span
    waves = fetch(atx.modulate(upload(arr, dev), 54, arr.shape[1]))
    span = waves.shape[1]
    air = DeviceAir(list(waves), window=32768, batch=64, overlap=6144,
                    n_frames=7, n_decode=0,
                    slots=1408 if channel else 384, noise_rms=0.02,
                    max_psdu=1504, hdr_bytes=64, min_rate_mbps=54,
                    seed=seed, device=dev)
    assert span + CH_TAPS[-1][0] <= air.overlap, (span, air.overlap)
    return air, psdus, span


def run_rx_soak(seconds: float, depth: int, log, channel: bool = False,
                device=None, phy: str = "a", strict: bool = True) -> dict:
    """Raises AssertionError unless every scheduled frame is
    position-matched (with ``strict``; else it logs the shortfall)."""
    if channel and phy != "a":
        raise ValueError("--channel is the 11a soak")
    air, psdus, span = make_rx_soak_air(channel=channel, device=device,
                                        phy=phy)
    taps = CH_TAPS if channel else [(0, 1.0)]
    if channel:
        log("channel: 4-tap in-CP multipath synthesized on the card "
            "(one descriptor per tap)")
    period = span + SOAK_GAP[phy]
    tol = SOAK_MATCH_TOL[phy]
    sps = PHY_SPS[phy]
    adv = air.advance
    air_per_round = adv / sps
    n_rounds = int(np.ceil(seconds / air_per_round))
    log(f"rx soak [{phy}]: {n_rounds} rounds x {air_per_round*1e3:.1f}"
        f" ms air ({adv} samples), frame span {span}, period {period}, "
        f"~{adv//period} frames/round")

    # warm: first-use tables, kernel load; not timed
    warm_rounds = 2
    t0 = time.perf_counter()
    for _ in range(warm_rounds):
        outs, _ = air.step([])
    fetch(outs[0]["ok"])
    log(f"  warm-up: {time.perf_counter()-t0:.1f}s")

    next_off = air.base + 1000
    inflight: deque = deque()
    delivered = 0
    scheduled = 0
    ok_rows = 0
    t_report = time.perf_counter() + 5.0
    t_start = time.perf_counter()
    base_start = air.base

    def drain_one():
        nonlocal delivered, ok_rows
        pending, base, expect = inflight.popleft()
        ok, lts1 = pending.get()
        ok = ok.astype(bool)
        pos = base + (np.arange(len(ok)) // air.n_frames) * air.hop + lts1
        ok_rows += int(ok.sum())
        okpos = np.sort(pos[ok])
        for off in expect:
            i = np.searchsorted(okpos, off + 192)
            hit = False
            for j in (i - 1, i):
                if 0 <= j < len(okpos) and abs(okpos[j] - (off + 192)) < tol:
                    hit = True
            delivered += int(hit)

    for r in range(n_rounds):
        base = air.base
        tx = []
        expect = []
        while next_off < base + adv:     # tails spill into the carry
            e = (next_off // period) % 64
            for d, c in taps:
                tx.append((int(e), int(next_off - base + d), c))
            expect.append(next_off)
            next_off += period
        scheduled += len(expect)
        outs, b = air.step(tx)
        inflight.append((Pending((outs[0]["ok"], outs[0]["lts1"])), b,
                         expect))
        while len(inflight) > depth:
            drain_one()
        now = time.perf_counter()
        if now > t_report:
            air_t = (air.base - base_start) / sps
            log(f"  [{now-t_start:6.1f}s wall] {air_t:6.1f}s air "
                f"dispatched, ratio so far "
                f"{(now-t_start)/max(air_t, 1e-9):.3f}, delivered "
                f"{delivered}/"
                f"{scheduled - sum(len(e) for _, _, e in inflight)}")
            t_report = now + 5.0
    while inflight:
        drain_one()
    wall = time.perf_counter() - t_start
    air_t = (air.base - base_start) / sps
    ratio = wall / air_t
    log(f"rx soak done: {air_t:.1f}s of {sps/1e6:.0f} Msps air in "
        f"{wall:.1f}s wall -> ratio {ratio:.3f}; delivered "
        f"{delivered}/{scheduled} ({ok_rows} ok candidate rows)")
    if delivered != scheduled:
        if strict:
            raise AssertionError(f"delivered {delivered} of {scheduled} "
                                 "scheduled frames")
        log(f"  WARNING: {scheduled - delivered} of {scheduled} frames "
            "not position-matched")
    return {"mode": "rx", "channel": bool(channel), "phy": phy,
            "rounds": n_rounds, "warm_rounds": warm_rounds,
            "air_seconds": round(air_t, 2),
            "wall_seconds": round(wall, 2), "ratio": round(ratio, 4),
            "frames_delivered": delivered, "frames_scheduled": scheduled,
            "msps": round(air_t * sps / 1e6 / wall, 2),
            "decoded_mbps": round(delivered * SOAK_PSDU[phy] * 8 / wall
                                  / 1e6, 1)}


def run_convo(seconds: float, depth: int, log, channel: bool = False,
              device=None) -> dict:
    def pad_psdu(p, n):
        # same SIGNAL length class for data and block-ack: pad the MPDU
        # before the FCS so the frame stays FCS-valid at full length
        return fr.append_fcs(p[:-4] + bytes(n - len(p)))

    taps = CH_TAPS if channel else [(0, 1.0)]
    if channel:
        log("channel: 4-tap in-CP multipath on every transmission "
            "(data and block-acks), synthesized on the card")
    depth = min(depth, 2)           # ack latency is ~2*(depth+1) rounds
    A, B = b"\x02SORAA", b"\x02SORAB"
    payload = 1464
    E = 2048                        # rotating data cache entries
    ma = BatchMac(A, B, n_seq=1 << 30, payload=payload,
                  timeout_rounds=2 * depth + 4, window_frames=E,
                  ba_bits=E)
    mb = BatchMac(B, A, n_seq=0, payload=payload, ba_bits=E)
    # hdr peek must cover the (E/8)-byte block-ack bitmap so one loss
    # cannot freeze the ack point past the bitmap span
    air = DeviceAir([np.zeros(4992, np.complex64)], n_entries=E + 1,
                    window=32768, batch=64, overlap=6144, n_frames=7,
                    n_decode=0, slots=896 if channel else 384,
                    noise_rms=0.02, max_psdu=1504,
                    hdr_bytes=24 + 6 + E // 8, min_rate_mbps=54,
                    n_receivers=2, pad_len=4992, seed=11, device=device)
    span = 4880
    gap = 640
    period = span + gap
    per_round = 216                 # ~29.7 Mbps offered goodput
    adv = air.advance
    n_rounds = int(np.ceil(seconds / (adv / SPS)))
    log(f"convo: {n_rounds} rounds, {per_round} data frames/round "
        f"+ 1 block-ack, round air {adv/SPS*1e3:.1f} ms, depth {depth}")

    warm_rounds = 1
    t0 = time.perf_counter()
    for _ in range(warm_rounds):
        outs, _ = air.step([])
    fetch((outs[0]["ok"], outs[1]["ok"]))
    air.stage_tx([0], np.frombuffer(ma.data_psdu(0), np.uint8)[None, :], 54)
    log(f"  warm-up: {time.perf_counter()-t0:.1f}s")

    staged: set = set()
    inflight: deque = deque()
    t_start = time.perf_counter()
    base_start = air.base
    t_report = time.perf_counter() + 5.0

    def drain_one():
        ha, oa, hb, ob = inflight.popleft().get()
        ma.consume(ha, oa)
        mb.consume(hb, ob)

    for rnd in range(n_rounds):
        tx = []
        seqs = ma.want_tx_seqs(rnd, per_round, span_limit=E)
        new = [s for s in seqs if s not in staged]
        st_idx = [s % E for s in new]
        st_psdu = [np.frombuffer(ma.data_psdu(s), np.uint8) for s in new]
        staged.update(new)
        if mb.rx_seqs:                  # block-ack rides the same call
            ba = pad_psdu(mb.block_ack_psdu(), len(ma.data_psdu(0)))
            st_idx.append(E)
            st_psdu.append(np.frombuffer(ba, np.uint8))
            tx += [(E, adv - period + d, c) for d, c in taps]
        if st_idx:
            air.stage_tx(st_idx, np.stack(st_psdu), 54)
        tx += [(s % E, 200 + i * period + d, c)
               for i, s in enumerate(seqs) for d, c in taps]
        outs, _ = air.step(tx)
        inflight.append(Pending((outs[0]["hdr"], outs[0]["ok"],
                                 outs[1]["hdr"], outs[1]["ok"])))
        while len(inflight) > depth:
            drain_one()
        now = time.perf_counter()
        if now > t_report:
            air_t = (air.base - base_start) / SPS
            log(f"  [{now-t_start:6.1f}s wall] {air_t:6.1f}s air, ratio "
                f"{(now-t_start)/max(air_t, 1e-9):.3f}, acked "
                f"{ma.stats.acked}, delivered {mb.stats.delivered}, "
                f"retx {ma.stats.retransmits}")
            t_report = now + 5.0
    while inflight:
        drain_one()
    wall = time.perf_counter() - t_start
    air_t = (air.base - base_start) / SPS
    ratio = wall / air_t
    goodput = ma.stats.acked * payload * 8 / air_t / 1e6
    log(f"convo done: {air_t:.1f}s air in {wall:.1f}s wall -> ratio "
        f"{ratio:.3f}; sent {ma.stats.sent} acked {ma.stats.acked} "
        f"retx {ma.stats.retransmits} delivered {mb.stats.delivered} "
        f"goodput {goodput:.1f} Mbps")
    if not (ma.stats.acked > 0 and mb.stats.delivered > 0):
        raise AssertionError(f"nothing acked or delivered: {ma.stats}")
    return {"mode": "convo", "channel": bool(channel),
            "rounds": n_rounds, "warm_rounds": warm_rounds,
            "air_seconds": round(air_t, 2),
            "wall_seconds": round(wall, 2), "ratio": round(ratio, 4),
            "sent": ma.stats.sent, "acked": ma.stats.acked,
            "retransmits": ma.stats.retransmits,
            "delivered": mb.stats.delivered,
            "goodput_mbps": round(goodput, 2)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("rx", "convo"), default="rx")
    ap.add_argument("--phy", choices=("a", "b", "n"), default="a",
                    help="the rx soak's PHY")
    ap.add_argument("--seconds", type=float, default=62.0)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--channel", action="store_true",
                    help="synthesize 4-tap in-CP multipath on the card")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    dev = resolve_device()
    log("device:", torch.cuda.get_device_name(dev))
    if args.mode == "rx":
        res = run_rx_soak(args.seconds, args.depth, log,
                          channel=args.channel, phy=args.phy)
    else:
        res = run_convo(args.seconds, args.depth, log, channel=args.channel)
    line = json.dumps(res)
    print(line, flush=True)
    if args.json:
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
