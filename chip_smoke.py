#!/usr/bin/env python3
"""Smoke run of ``sora_tpu_torch`` on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py        # from the repository root

Phases (any failure raises and the script exits nonzero):

1. card details (name and power limit from nvidia-smi, torch and CUDA);
2. build of the Viterbi kernel ``sora_tpu_torch/csrc/viterbi.cu`` with nvcc
   for sm_90a (forced, from the sources in the checkout);
3. the kernel against its plain PyTorch version on the card, bit for bit,
   in the three window regimes of ``decode_auto``, ``terminated`` both
   ways, on noisy codewords (sigma 0.25 and 0.9) and on tie-heavy input
   (all-zero soft values, every 7th step erased, |soft| beyond the +-7
   clamp); at the 24-step SIGNAL shape (block 24, overlap 0); at batch
   sizes that leave a ragged last block of warps (1 and 33 streams); on a
   non-contiguous and on a misaligned input; and at the bench shape
   (128, 12096);
4. the main path at full width: ``rx_pipeline(x, 54, max_psdu=1504)`` on
   128 streams of the 54 Mbps capture ``tests/data/fsample54.dmp``
   (decimated to 20 Msps, N = 5452 samples, T = 56*216 = 12096 trellis
   steps), with the launch counter reset just before and read just after;
   every row must decode, all PSDUs equal and FCS-valid, and the first
   rows must agree with the same chain run on the CPU; then timings
   (CUDA events after warm-up) of the chain (median of 5 windows of 20
   batches), its latency (100 batches), its stages, the kernel (replays of
   a CUDA graph of 50 launches) and the plain version; and the chain's
   device kernel time per batch from torch.profiler (its idle share
   against the event time);
5. TX: ``tx.modulate`` on the card and on the CPU for all 8 rates (16
   PSDUs of 1500 bytes each), equal within 1e-5; the card's waveforms
   decode through the card's ``rx_pipeline`` at their rate;
6. the mixed-rate path at full width: ``rx_pipeline_auto(x, max_psdu=
   1504)`` on 128 streams, 16 per rate, each one 1500-byte frame from the
   card's TX plus noise at 0.02 in a 40736-sample window: every row ``ok``
   with its rate and PSDU, the first 8 rows (one per rate) equal to the
   CPU run, and the kernel equal to the plain version on this path's own
   Viterbi input;
7. the front end: ``rx_pipeline(x40, 54, max_psdu=1504, input_rate=
   "40m")`` on 128 streams of the raw 40 Msps capture: every row decodes,
   the first 4 rows equal the CPU run;
8. the device-resident air, saturated 54 Mbps rx soak at the canonical
   configuration (``tools/realtime_soak.py``): one round under
   ``torch.cuda.set_sync_debug_mode("error")`` (a round makes no host
   sync), the kernel against the plain version and its time on that
   round's own Viterbi input (448, 12096), the round's device time from
   torch.profiler, then ``run_rx_soak`` over 10 s of air with every frame
   position-matched and one kernel launch per round;
9. the two-node conversation (``run_convo``) over 5 s of air: something
   acked and delivered;
10. the int16/int8 sample wire (``util/xfer.py``): card and CPU equal bit
   for bit;
11. the live node (``runtime/node.py``) at bench.py's node width
   (bench.py:352-363: windows of 32768, batch 64, 11 candidates per
   window, i8 wire, a ring of 2^25): one batch decoded on the card equal
   to the CPU on its first 16 windows; two ``step()`` calls under
   ``set_sync_debug_mode("error")``; the kernel against the plain version
   and its time on that batch's own Viterbi input (704, 2160); 5 s of
   paced, looped 24 Mbps traffic (frame_ok > 0, crc_fail <= 2% of it,
   kernel launches == decoded batches, the native feed in use); the
   device-only ratio and the device idle share; the sparse-air
   compaction pair (the same ok rows from all 704 rows and from the top
   128); the bridge selftest in-process;
12. a JSON line of the kernels, the card line, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Every path is driven with the kernel's launch counter set to 0 just before
and read just after, and fails if the kernel was not launched.  It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CAPTURE = ROOT / "tests" / "data" / "fsample54.dmp"
RATE, PSDU_LEN, BATCH, MAX_PSDU = 54, 1500, 128, 1504
RATES = (6, 9, 12, 18, 24, 36, 48, 54)
MIXED_N = 40736           # the 6 Mbps 1500-byte frame (40480) + 256
TX_ATOL = 1e-5            # card against CPU TX (unit-power samples)
SOAK_SECONDS, CONVO_SECONDS, SOAK_DEPTH = 10.0, 5.0, 6
# the live node at bench.py's node width (bench.py:352-363)
NODE_ADDR = b"\x02SORA1"
NODE_CFG = dict(max_psdu=256, min_rate_mbps=24, window=32768, batch=64,
                max_frames_per_window=11, rate_mbps=None, wire="i8")
NODE_RING, NODE_SECONDS = 1 << 25, 5.0
NODE_CPU_WINDOWS = 16     # windows of the node batch also decoded on the CPU
BRIDGE_ARGS = ("--pair", "--sockets", "--selftest", "--seconds", "120")

# The card's peaks for the kernel's bound: HBM bandwidth of one H100 SXM
# (NVIDIA's data sheet, at the full 700 W limit), and its int32 issue rate:
# 64 INT32 lanes per SM (Hopper architecture white paper) times the SMs
# times the SM clock (nvidia-smi's clocks.max.sm; 1.98 GHz published boost).
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
BOOST_SM_HZ = 1.98e9
# int32 operations of one exact Viterbi window step: a radix-2
# add-compare-select per state (2 adds, 1 min) for 64 states
ACS_OPS_PER_STEP = 64 * 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def max_sm_hz() -> float:
    """The card's maximum SM clock in Hz (nvidia-smi), else the published
    boost clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    try:
        return float(out.splitlines()[0]) * 1e6
    except (IndexError, ValueError):
        return BOOST_SM_HZ


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over reps calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn() from replays of a CUDA
    graph of reps calls, so that the host's work per call is not timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / reps


def profile_device(fn, reps: int):
    """Device time of fn() from torch.profiler: (kernel ms per call,
    device launches per call, top rows [(name, ms per call, launches per
    call)]), counting device events (kernels, copies) only; (None, 0, [])
    when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device events only: a CPU op's row repeats its kernels' time
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3 / reps, e.count / reps))
    if not rows:
        return None, 0, []
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:8])


def saturated_batch(B: int, seed: int = 1):
    """B streams, each the 54 Mbps capture (DC removed, 40 -> 20 Msps) at
    offset 25 + (13 i) % 120 in a window of len + 160 samples, plus small
    complex Gaussian noise."""
    from sora_tpu_torch.io.dumpfile import load_dump

    raw = load_dump(str(CAPTURE)).astype(np.complex128)
    raw -= raw.mean()
    x20 = raw[0::2].astype(np.complex64)
    rng = np.random.default_rng(seed)
    N = len(x20) + 160
    x = np.zeros((B, N), np.complex64)
    for i in range(B):
        off = 25 + (13 * i) % 120
        x[i, off: off + len(x20)] = x20
    scale = 0.02 * float(np.abs(x20).mean())
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * scale
    return x


def noisy_soft(B: int, T: int, sigma: float, seed: int):
    """Soft pairs (B, T, 2) of random terminated codewords plus noise."""
    import torch

    from sora_tpu_torch.dsp import viterbi as dvit

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, T), dtype=np.uint8)
    bits[:, -6:] = 0
    coded = dvit.encode(torch.from_numpy(bits)).numpy().reshape(B, T, 2)
    soft = 2.0 * coded - 1.0 + rng.normal(size=coded.shape) * sigma
    return torch.from_numpy(soft.astype(np.float32))


def tie_heavy(T: int, seed: int):
    """Soft pairs (16, T, 2) that force ties and saturation: all zero,
    noisy codewords with every 7th step erased, and codewords scaled
    beyond the +-7 quantizer clamp."""
    import torch

    erased = noisy_soft(16, T, 0.9, seed)
    erased[:, ::7] = 0.0
    return {"zeros": torch.zeros(16, T, 2), "erased7": erased,
            "saturated": 4.0 * noisy_soft(16, T, 0.75, seed + 1)}


def auto_window(T: int):
    """(block, overlap) that dsp.viterbi.decode_auto picks for T steps."""
    if T > 1024:
        return (1024, 64) if T >= 4096 else (512, 64)
    return -(-T // 8) * 8, 0


def viterbi_bound(B: int, T: int, block: int, overlap: int,
                  int32_ops_per_s: float) -> dict:
    """The least time of the decode: radix-2 ACS int32 operations of every
    window step at the int32 issue rate, or the bytes (fp32 soft in, uint8
    bits out) at the HBM rate, whichever is larger."""
    nwin = B * (-(-T // block))
    win = block + 2 * overlap
    ops = nwin * win * ACS_OPS_PER_STEP
    nbytes = B * T * 2 * 4 + B * T
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / int32_ops_per_s * 1e3
    return {"ops": ops, "ops_radix4": nwin * (win // 4) * 1024 * 3,
            "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


@contextmanager
def viterbi_inputs():
    """Records the soft input of every ``decode_auto`` call the receivers
    make (the kernel's real input on a path), passing each call on."""
    from sora_tpu_torch.dsp import viterbi as dvit

    seen = []
    orig = dvit.decode_auto

    def spy(soft_ab, *args, **kwargs):
        seen.append(soft_ab)
        return orig(soft_ab, *args, **kwargs)

    dvit.decode_auto = spy
    try:
        yield seen
    finally:
        dvit.decode_auto = orig


def launched(vc, what: str, want=None) -> int:
    """The kernel's launch count of the path just driven; raises when the
    path did not launch it (or not ``want`` times)."""
    n = vc.LAUNCHES
    if n == 0 or (want is not None and n != want):
        raise AssertionError(f"{what} launched the kernel {n} times, "
                             f"expected {want or 'at least 1'}")
    return n


def psdus_1500(n: int, seed: int) -> np.ndarray:
    """n distinct 1500-byte PSDUs (1472-byte random payloads)."""
    from sora_tpu_torch.mac.frame import build_data_frame

    rng = np.random.default_rng(seed)
    return np.stack([np.frombuffer(build_data_frame(bytes(rng.integers(
        0, 256, PSDU_LEN - 28, dtype=np.uint8)), seq=i), np.uint8)
        for i in range(n)])


def check_rows(card: dict, cpu: dict, rows: int, keys) -> None:
    """The first ``rows`` rows of the card's outputs equal the CPU's."""
    for key in keys:
        if not np.array_equal(cpu[key], card[key][:rows]):
            raise AssertionError(f"card and CPU disagree on {key}")
    for key, tol in (("det", 1e-4), ("cfo", 1e-5), ("snr_db", 0.05)):
        err = float(np.abs(cpu[key] - card[key][:rows]).max())
        if err > tol:
            raise AssertionError(f"card and CPU differ on {key} by {err}")


def tx_and_mixed_phase(torch, dev, rx, vc, parity) -> dict:
    """Phases 5 and 6: the card's TX against the CPU's, each rate decoded
    by the fixed-rate receiver, then the 128-stream mixed-rate batch."""
    from sora_tpu_torch.phy.dot11a import tx
    from sora_tpu_torch.util.xfer import fetch

    arr = psdus_1500(BATCH, seed=3)       # row i is sent at RATES[i % 8]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    noise = lambda shape: torch.randn(shape, dtype=torch.complex64,
                                      device=dev, generator=gen) * 0.02
    waves, worst = {}, 0.0
    for ri, rate in enumerate(RATES):
        rows = torch.from_numpy(arr[ri::len(RATES)].copy())
        w = tx.modulate(rows.to(dev), rate, PSDU_LEN)
        err = float((w.cpu() - tx.modulate(rows, rate, PSDU_LEN)).abs()
                    .max())
        worst = max(worst, err)
        if err > TX_ATOL:
            raise AssertionError(f"TX at {rate} Mbps: card and CPU differ "
                                 f"by {err}")
        x = torch.zeros(w.shape[0], w.shape[1] + 200,
                        dtype=torch.complex64, device=dev)
        x[:, 60: 60 + w.shape[1]] = w
        x += noise(x.shape)
        vc.LAUNCHES = 0
        out = fetch(rx.rx_pipeline(x, rate, max_psdu=MAX_PSDU))
        launched(vc, f"rx_pipeline at {rate} Mbps", 1)
        if not (out["ok"].all()
                and (out["psdu"][:, :PSDU_LEN] == rows.numpy()).all()):
            raise AssertionError(f"the card's {rate} Mbps waveforms do not "
                                 "decode")
        waves[rate] = w
    print(f"tx.modulate, 8 rates x 16 PSDUs of {PSDU_LEN} bytes: card and "
          f"CPU agree within {worst:.2e} (tolerance {TX_ATOL:g}); "
          "rx_pipeline on the card's waveforms at their rate: ok 128/128",
          flush=True)

    x = torch.zeros(BATCH, MIXED_N, dtype=torch.complex64, device=dev)
    for i in range(BATCH):
        w = waves[RATES[i % len(RATES)]][i // len(RATES)]
        off = 40 + (13 * (i // len(RATES))) % 120
        x[i, off: off + w.shape[0]] = w
    x += noise(x.shape)
    run = lambda: rx.rx_pipeline_auto(x, max_psdu=MAX_PSDU)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        out = run()
        torch.cuda.synchronize()
    launches = launched(vc, "rx_pipeline_auto", 1)
    host = fetch(out)
    want_rate = np.array([RATES[i % len(RATES)] for i in range(BATCH)])
    n_ok = int(host["ok"].sum())
    print(f"rx_pipeline_auto {BATCH}x{MIXED_N}, 16 streams per rate: ok "
          f"{n_ok}/{BATCH}, kernel launches {launches}", flush=True)
    if (n_ok != BATCH or not (host["rate_mbps"] == want_rate).all()
            or not (host["psdu"][:, :PSDU_LEN] == arr).all()):
        raise AssertionError("the mixed-rate batch did not decode")
    cpu = fetch(rx.rx_pipeline_auto(x[: len(RATES)].cpu(),
                                    max_psdu=MAX_PSDU))
    check_rows(host, cpu, len(RATES), ("psdu", "ok", "fcs_ok", "sig_ok",
                                       "cs_ok", "truncated", "length",
                                       "lts1", "rate_mbps"))
    print("card and CPU agree on the first 8 rows (one per rate)",
          flush=True)
    ab = seen[0]
    parity("mixed-rate path soft", ab, *auto_window(ab.shape[1]), True)
    for _ in range(2):
        run()
    ms = sorted(cuda_ms(run, 5) for _ in range(3))[1]
    print(f"rx_pipeline_auto: {ms:.3f} ms/batch (events, median of 3 "
          f"windows of 5); {BATCH * MIXED_N / ms / 1e3:.1f} Msamples/s, "
          f"{BATCH * PSDU_LEN * 8 / ms / 1e3:.1f} Mbps decoded", flush=True)
    return {"batch": [BATCH, MIXED_N], "trellis": list(ab.shape[:2]),
            "ms": ms, "msamples_per_s": BATCH * MIXED_N / ms / 1e3,
            "decoded_mbps": BATCH * PSDU_LEN * 8 / ms / 1e3,
            "tx_max_abs_err": worst, "launches": launches}


def frontend_phase(torch, dev, rx, vc, psdu0: np.ndarray) -> int:
    """Phase 7: the raw 40 Msps capture through the front end and the
    fixed-rate receiver, 128 streams."""
    from sora_tpu_torch.io.dumpfile import load_dump
    from sora_tpu_torch.util.xfer import device_complex, fetch

    raw = load_dump(str(CAPTURE)).astype(np.complex64)
    rng = np.random.default_rng(40)
    x = np.zeros((BATCH, len(raw) + 320), np.complex64)
    for i in range(BATCH):
        off = 2 * (25 + (13 * i) % 120)
        x[i, off: off + len(raw)] = raw
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * (0.02 * float(np.abs(raw).mean()))
    xd = device_complex(x, dev)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    host = fetch(rx.rx_pipeline(xd, RATE, max_psdu=MAX_PSDU,
                                input_rate="40m"))
    launches = launched(vc, "rx_pipeline(input_rate='40m')", 1)
    n_ok = int(host["ok"].sum())
    print(f"rx_pipeline(input_rate='40m') {BATCH}x{x.shape[1]} raw 40 Msps: "
          f"ok {n_ok}/{BATCH}, kernel launches {launches}", flush=True)
    if (n_ok != BATCH or not (host["length"] == PSDU_LEN).all()
            or not (host["psdu"] == psdu0).all()):
        raise AssertionError("the 40 Msps batch did not decode")
    cpu = fetch(rx.rx_pipeline(torch.from_numpy(x[:4]), RATE,
                               max_psdu=MAX_PSDU, input_rate="40m"))
    check_rows(host, cpu, 4, ("psdu", "ok", "fcs_ok", "sig_ok", "cs_ok",
                              "truncated", "length", "lts1"))
    print("card and CPU agree on the first 4 rows at 40 Msps", flush=True)
    return launches


def soak_phase(torch, vc, parity, int32_ops_per_s, card) -> dict:
    """Phase 8: one soak round checked (no host sync, the kernel on its
    real input, device time), then the timed saturated rx soak."""
    from sora_tpu_torch.tools import realtime_soak as soak
    from sora_tpu_torch.util.xfer import fetch

    air, _, span = soak.make_rx_soak_air()
    period = span + 640
    tx = [(int((off // period) % 64), int(off), 1.0)
          for off in range(1000, air.advance, period)]
    for _ in range(2):                           # warm: first-use tables
        outs, _ = air.step(tx)
    fetch(outs[0]["ok"])
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs, base = air.step(tx)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched(vc, "one soak round", 1)
    out = fetch(outs[0])
    print(f"soak round: no host sync inside DeviceAir.step "
          f"(set_sync_debug_mode('error')); {int(out['ok'].sum())} ok rows "
          f"of {len(out['ok'])} for {len(tx)} frames sent", flush=True)
    ab = seen[0]
    B, T = ab.shape[:2]
    block, overlap = auto_window(T)
    parity("soak round soft", ab, block, overlap, True)
    ms = graph_ms(lambda: vc.decode_blocks(ab, block, overlap, True), 50)
    plain_ms = cuda_ms(lambda: vc.decode_blocks_reference(
        ab, block, overlap, True), 1)
    bnd = viterbi_bound(B, T, block, overlap, int32_ops_per_s)
    print(f"viterbi kernel at the soak shape ({B}, {T}) = "
          f"{B * (-(-T // block))} windows: {ms:.4f} ms (graph replay); "
          f"plain version {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}: {bnd['ops'] / 1e9:.4f} G int32 ops = "
          f"{bnd['ops_ms']:.4f} ms; {bnd['bytes'] / 1e6:.2f} MB = "
          f"{bnd['bytes_ms']:.4f} ms); time/bound "
          f"{ms / bnd['bound_ms']:.2f}", flush=True)
    dev_ms, dev_launches, top = profile_device(lambda: air.step(tx), 3)

    log = lambda *a: print("  soak:", *a, flush=True)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    res = soak.run_rx_soak(SOAK_SECONDS, SOAK_DEPTH, log)
    torch.cuda.synchronize()
    n_rounds = res["rounds"] + res["warm_rounds"]
    launches = launched(vc, "the rx soak", n_rounds)
    wall_round_ms = res["wall_seconds"] * 1e3 / res["rounds"]
    idle = None if dev_ms is None else 1.0 - dev_ms / wall_round_ms
    print(f"rx soak: {res['air_seconds']} s of 20 Msps air in "
          f"{res['wall_seconds']} s wall, real-time ratio {res['ratio']}; "
          f"{res['msps']} Msamples/s, {res['decoded_mbps']} Mbps decoded; "
          f"frames delivered {res['frames_delivered']}/"
          f"{res['frames_scheduled']}; kernel launches {launches} in "
          f"{n_rounds} rounds ({launches / n_rounds:g} per round)",
          flush=True)
    if dev_ms is None:
        print("soak round device time: not measured (the profiler saw no "
              "device events)", flush=True)
    else:
        print(f"soak round device time: {dev_ms:.3f} ms of {wall_round_ms:.3f}"
              f" ms wall per round in the soak (idle share {idle:.3f}), "
              f"{dev_launches:.0f} device launches per round; top:",
              flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)
    print(card, flush=True)
    return {"result": res, "launches": launches,
            "launches_per_round": launches / n_rounds,
            "round": {"device_ms": dev_ms, "wall_ms": wall_round_ms,
                      "idle_share": idle, "device_launches": dev_launches},
            "shape": [B, T], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}


def convo_phase(vc, card) -> dict:
    """Phase 9: the two-node block-ack conversation."""
    from sora_tpu_torch.tools import realtime_soak as soak

    log = lambda *a: print("  convo:", *a, flush=True)
    vc.LAUNCHES = 0
    res = soak.run_convo(CONVO_SECONDS, SOAK_DEPTH, log)
    n_rounds = res["rounds"] + res["warm_rounds"]
    launches = launched(vc, "the conversation", 2 * n_rounds)
    print(f"convo: {res['air_seconds']} s of air in {res['wall_seconds']} s "
          f"wall, real-time ratio {res['ratio']}; sent {res['sent']}, acked "
          f"{res['acked']}, delivered {res['delivered']}, retransmits "
          f"{res['retransmits']}, goodput {res['goodput_mbps']} Mbps; kernel "
          f"launches {launches} in {n_rounds} rounds of 2 receivers",
          flush=True)
    print(card, flush=True)
    return {**res, "launches": launches}


def wire_phase(torch, dev) -> None:
    """Node phase 1: the int16/int8 sample wire, card against CPU, bit for
    bit, at several AGC gains (including saturating ones), and the
    pre-quantized path of the native feed."""
    from sora_tpu_torch.util import xfer

    rng = np.random.default_rng(16)
    x = ((rng.normal(size=(8, 4096)) + 1j * rng.normal(size=(8, 4096)))
         * 2.0).astype(np.complex64)
    x[0, :6] = [0.0, 1e9, -1e9, 0.4999 - 0.4999j, 15.99 + 1j, -3.97 - 8j]
    worst = 0
    for name, fn in (("device_complex16", xfer.device_complex16),
                     ("device_complex8", xfer.device_complex8)):
        for scale in (1.0, 0.37, 9.0, 300.0):
            card = torch.view_as_real(fn(x, dev, scale=scale)).cpu()
            cpu = torch.view_as_real(fn(x, "cpu", scale=scale))
            if not torch.equal(card, cpu):
                raise AssertionError(f"{name} scale {scale}: card and CPU "
                                     "differ")
    for dtype in (np.int16, np.int8):
        lim = np.iinfo(dtype).max
        h = rng.integers(-lim, lim + 1, (64, 1024, 2)).astype(dtype)
        card = torch.view_as_real(xfer.device_quantized(h, dev)).cpu()
        cpu = torch.view_as_real(xfer.device_quantized(h, "cpu"))
        scale = xfer.I8_SCALE if dtype == np.int8 else xfer.I16_SCALE
        want = h.astype(np.float32) * np.float32(1.0 / scale)
        if not (torch.equal(card, cpu) and np.array_equal(cpu.numpy(), want)):
            raise AssertionError(f"device_quantized {np.dtype(dtype).name}: "
                                 "card, CPU and host scale differ")
        worst = max(worst, int(np.abs(card.numpy() - want).max()))
    print("wire: device_complex16 / device_complex8 (4 gains, saturating "
          "input) and device_quantized (int16, int8): card and CPU equal "
          f"bit for bit (max difference {worst})", flush=True)


def _windows(node, src: np.ndarray, batches: int) -> np.ndarray:
    """The looped source tiled to ``batches`` node batches plus the
    overlap (what the ring would hold)."""
    cfg = node.cfg
    hop = cfg.window - cfg.overlap
    n = cfg.overlap + hop * cfg.batch * batches
    return np.tile(src, -(-n // len(src)))[:n]


def node_phase(torch, dev, vc, parity, int32_ops_per_s, card) -> dict:
    """Node phases 2-7: the live node at bench.py's node width
    (bench.py:352-363): one batch card against CPU, the issue path without
    an implicit sync, the kernel on the batch's own soft values, the 5 s
    paced run, the device-only ratio, the sparse-air compaction pair and
    the bridge selftest."""
    from sora_tpu_torch.apps import bridge
    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.mac.frame import build_ack_frame
    from sora_tpu_torch.phy.dot11a import rx
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink
    from sora_tpu_torch.util.xfer import (I8_SCALE, device_complex16,
                                          device_quantized, fetch)

    cfg = NodeConfig(addr=NODE_ADDR, **NODE_CFG)
    hop = cfg.window - cfg.overlap
    nsamp = cfg.window + hop * (cfg.batch - 1)
    air_s = nsamp / cfg.sample_rate_sps
    K = cfg.max_frames_per_window
    rows = cfg.batch * K
    ring = RxRing(capacity=NODE_RING)
    node = StreamingNode(ring, cfg, tx_sink=TxSink(), device=dev)
    t0 = time.perf_counter()
    node.warm_up()
    warm_s = time.perf_counter() - t0
    src = synthetic_traffic(400, NODE_ADDR, mixed=False, rate=24, gap=900,
                            device=dev)
    print(f"node: window {cfg.window} overlap {cfg.overlap} hop {hop} batch "
          f"{cfg.batch} K {K} ({rows} candidate rows), {nsamp} samples = "
          f"{air_s * 1e3:.2f} ms of air per batch, wire {cfg.wire}; warm-up "
          f"{warm_s:.2f} s; traffic {len(src)} samples (400 frames of 148 "
          "bytes at 24 Mbps, gap 900)", flush=True)

    # ---- 2. one batch at the node width, card against CPU --------------
    feed = RxRing(capacity=NODE_RING)
    vs = feed.alloc_vstream()
    feed.write(_windows(node, src, 1))
    h, _ = feed.read_windows(vs, cfg.window, hop, cfg.batch, I8_SCALE,
                             np.int8)
    feed.close()
    xd = device_quantized(h, dev)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        out = fetch(node._decode(xd))
    launched(vc, "one node batch", 1)
    ab = seen[0]
    n_cpu = NODE_CPU_WINDOWS
    cpu = fetch(node._decode(device_quantized(h[:n_cpu], "cpu")))
    for key in ("ok", "length", "psdu", "rate_mbps"):
        if not np.array_equal(cpu[key], out[key][: n_cpu * K]):
            raise AssertionError(f"node batch: card and CPU disagree on {key}")
    n_ok = int(out["ok"].sum())
    if n_ok == 0:
        raise AssertionError("the node batch decoded nothing")
    print(f"node batch {cfg.batch}x{cfg.window} (i8 wire): {n_ok} ok rows of "
          f"{rows}, Viterbi input {tuple(ab.shape)}, kernel launches 1; card "
          f"and CPU agree on ok, length, psdu, rate_mbps of the first "
          f"{n_cpu} windows ({n_cpu * K} rows, {int(cpu['ok'].sum())} ok)",
          flush=True)

    # ---- 3. the issue path makes no implicit host sync ------------------
    ring.write(_windows(node, src, 3))
    node.step()                          # batch 1: its detect in flight
    node.cache.get(build_ack_frame(b"\x02PEER0"), cfg.ack_rate)  # pre-staged
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # batch 2: assemble, upload, detect; gate batch 1 (an explicit
        # event wait) and issue its decode.  Batch 3: the same, and
        # batch 1 retires (an event wait, the MAC, a cached ACK)
        node.step()
        node.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    node.flush()
    if node.stats.decoded_batches < 3 or node.stats.frame_ok == 0:
        raise AssertionError("the checked steps did not decode:\n"
                             + node.report())
    print("node step: no implicit host sync while it assembles, uploads and "
          "issues detect and decode (set_sync_debug_mode('error'), 2 steps; "
          f"the gate's and retire's event waits are explicit); "
          f"{node.stats.frame_ok} frames in {node.stats.decoded_batches} "
          "batches", flush=True)
    ring.close()

    # ---- 4. the kernel at the node shape --------------------------------
    B, T = ab.shape[:2]
    block, overlap = auto_window(T)
    parity("node batch soft", ab, block, overlap, True)
    k_ms = graph_ms(lambda: vc.decode_blocks(ab, block, overlap, True), 50)
    k_plain = cuda_ms(lambda: vc.decode_blocks_reference(ab, block, overlap,
                                                         True), 1)
    bnd = viterbi_bound(B, T, block, overlap, int32_ops_per_s)
    print(f"viterbi kernel at the node shape ({B}, {T}) block {block} overlap "
          f"{overlap} = {B * (-(-T // block))} windows: {k_ms:.4f} ms (graph "
          f"replay); plain version {k_plain:.3f} ms; bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
          f"{bnd['ops'] / 1e9:.4f} G int32 ops = {bnd['ops_ms']:.4f} ms; "
          f"{bnd['bytes'] / 1e6:.2f} MB = {bnd['bytes_ms']:.4f} ms); "
          f"time/bound {k_ms / bnd['bound_ms']:.2f}", flush=True)

    # ---- 5. the 5 s paced run -------------------------------------------
    ring = RxRing(capacity=NODE_RING)
    node = StreamingNode(ring, cfg, tx_sink=TxSink(), device=dev)
    node.warm_up()
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    ring.start_replay(src, rate_sps=cfg.sample_rate_sps, loop=True)
    t0 = time.perf_counter()
    t_end = t0 + NODE_SECONDS
    try:
        while time.perf_counter() < t_end:
            if not node.step():
                time.sleep(0.001)
    finally:
        ring.stop()
    node.flush()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ring.close()
    st, rep = node.stats, node.sw.report()
    batches = st.decoded_batches
    launches = launched(vc, "the paced node run", batches)
    if not node._native_feed:
        raise AssertionError("the paced run left the native windowed feed")
    print(f"node run ({NODE_SECONDS:g} s, paced 20 Msps, looped): "
          f"{st.frame_ok} frames, {st.frame_ok / NODE_SECONDS:.0f} frames/s, "
          f"MacStopwatch avg ratio {rep.avg_ratio:.4f} (max "
          f"{rep.max_ratio:.4f}), dup {st.dup}, backlog_dropped "
          f"{st.backlog_dropped}, crc_fail {st.crc_fail}, truncated "
          f"{st.truncated}, cs_timeout {st.cs_timeout}, plcp_fail "
          f"{st.plcp_fail}, acks {st.acks_tx}; decoded batches {batches}, "
          f"kernel launches {launches}; native feed {node._native_feed}; "
          f"{run_s:.2f} s wall with the flush", flush=True)
    if st.frame_ok == 0 or st.crc_fail > 0.02 * st.frame_ok:
        raise AssertionError("paced node run failed:\n" + node.report())

    # device-only ratio: detect + decode of one batch, CUDA events
    issue = lambda: (node._detect(xd), node._decode(xd))
    issue()
    dev_only_ms = cuda_ms(issue, 20)
    out1 = node._decode(xd)
    d2h = sum(v.numel() * v.element_size() for v in out1.values()) + 8 * (
        cfg.batch)
    h2d = h.nbytes
    dev_ms, dev_launches, top = profile_device(issue, 3)
    wall_batch_ms = run_s * 1e3 / max(1, batches)
    idle = None if dev_ms is None else 1.0 - dev_ms / wall_batch_ms
    busy = None if dev_ms is None else dev_ms / dev_only_ms
    print(f"node device-only: {dev_only_ms:.3f} ms detect+decode per batch "
          f"(events, 20 calls) over {air_s * 1e3:.2f} ms of air: ratio "
          f"{dev_only_ms / 1e3 / air_s:.4f}; host->device {h2d} bytes per "
          f"batch (i8 wire), device->host {d2h} bytes", flush=True)
    if dev_ms is None:
        print("node batch device time: not measured (the profiler saw no "
              "device events)", flush=True)
    else:
        print(f"node batch device time: {dev_ms:.3f} ms per detect+decode "
              f"({dev_launches:.0f} device launches; {busy:.3f} of the event "
              f"time); idle share of the paced run {idle:.4f} "
              f"(wall {wall_batch_ms:.2f} ms per decoded batch); top:",
              flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)

    # ---- 6. sparse-air compaction (bench.py:412-438) --------------------
    src_sp = synthetic_traffic(80, NODE_ADDR, mixed=False, rate=24,
                               gap=30000, device=dev)
    xw_sp = np.stack([src_sp[(i * hop) % max(1, len(src_sp) - cfg.window):]
                      [: cfg.window] for i in range(cfg.batch)])
    xd_sp = device_complex16(xw_sp, dev)
    full = lambda: rx.rx_pipeline_auto(xd_sp, max_psdu=cfg.max_psdu,
                                       n_frames=K)
    comp = lambda: rx.rx_pipeline_auto(xd_sp, max_psdu=cfg.max_psdu,
                                       n_frames=K, n_decode=2 * cfg.batch)
    fo, co = fetch(full()), fetch(comp())
    f_rows = {(int(i), bytes(fo["psdu"][i][: fo["length"][i]]))
              for i in np.flatnonzero(fo["ok"])}
    c_rows = {(int(co["src"][i]), bytes(co["psdu"][i][: co["length"][i]]))
              for i in np.flatnonzero(co["ok"])}
    if len(f_rows) != len(c_rows) or f_rows != c_rows or not f_rows:
        raise AssertionError(f"compaction: {len(c_rows)} ok rows of the top "
                             f"{2 * cfg.batch} against {len(f_rows)} of all "
                             f"{rows} (or the rows differ)")
    full_ms = sorted(cuda_ms(full, 10) for _ in range(3))[1]
    comp_ms = sorted(cuda_ms(comp, 10) for _ in range(3))[1]
    print(f"sparse-air compaction: {len(f_rows)} ok rows per batch, the same "
          f"set from all {rows} rows and from the top {2 * cfg.batch}; full "
          f"{full_ms:.3f} ms (ratio {full_ms / 1e3 / air_s:.4f}) -> top-"
          f"{2 * cfg.batch} {comp_ms:.3f} ms (ratio "
          f"{comp_ms / 1e3 / air_s:.4f}), {full_ms / comp_ms:.2f}x (events, "
          "median of 3 windows of 10)", flush=True)

    # ---- 7. the bridge selftest -----------------------------------------
    vc.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = bridge.main([*BRIDGE_ARGS, "--device", str(dev)])
    bridge_s = time.perf_counter() - t0
    b_launches = launched(vc, "the bridge selftest")
    if rc != 0:
        raise AssertionError(f"bridge selftest returned {rc}")
    print(f"bridge selftest (--pair --sockets --selftest): rc 0 in "
          f"{bridge_s:.2f} s, kernel launches {b_launches}", flush=True)
    print(card, flush=True)
    return {"config": {"window": cfg.window, "overlap": cfg.overlap,
                       "hop": hop, "batch": cfg.batch, "K": K,
                       "wire": cfg.wire, "air_ms_per_batch": air_s * 1e3},
            "warm_s": warm_s, "frames": st.frame_ok,
            "frames_per_s": st.frame_ok / NODE_SECONDS,
            "avg_ratio": rep.avg_ratio, "max_ratio": rep.max_ratio,
            "dup": st.dup, "backlog_dropped": st.backlog_dropped,
            "crc_fail": st.crc_fail, "truncated": st.truncated,
            "cs_timeout": st.cs_timeout, "plcp_fail": st.plcp_fail,
            "acks_tx": st.acks_tx, "decoded_batches": batches,
            "launches": launches, "run_s": run_s,
            "device_only_ms": dev_only_ms,
            "device_only_ratio": dev_only_ms / 1e3 / air_s,
            "h2d_bytes_per_batch": h2d, "d2h_bytes_per_batch": d2h,
            "device_ms_per_batch": dev_ms,
            "device_launches_per_batch": dev_launches,
            "idle_share": idle, "compaction_full_ms": full_ms,
            "compaction_top_ms": comp_ms,
            "compaction_speedup": full_ms / comp_ms,
            "compaction_ok_rows": len(f_rows), "bridge_s": bridge_s,
            "bridge_launches": b_launches, "shape": [B, T], "ms": k_ms,
            "plain_ms": k_plain, "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sora_tpu_torch.mac.frame import check_fcs
    from sora_tpu_torch.ops import viterbi_cuda as vc
    from sora_tpu_torch.phy.dot11a import rx
    from sora_tpu_torch.util.xfer import device_complex, fetch

    dev = torch.device("cuda")

    # ---- 1. card ------------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    log = vc.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"build viterbi.cu: {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # ---- 3. kernel against the plain version --------------------------------
    max_err = 0

    def parity(name, soft, block, overlap, terminated):
        nonlocal max_err
        got = vc.decode_blocks(soft, block, overlap, terminated)
        want = vc.decode_blocks_reference(soft, block, overlap, terminated)
        bad = int((got != want).sum())
        print(f"parity {name} {tuple(soft.shape)} block={block} "
              f"overlap={overlap} terminated={terminated}: {bad} mismatches",
              flush=True)
        if bad:
            raise AssertionError("kernel disagrees with the plain version")
        max_err = max(max_err, int((got.int() - want.int()).abs().max()))

    for T in (203, 1500, 4200):
        block, overlap = auto_window(T)
        for terminated in (True, False):
            for sigma in (0.25, 0.9):
                parity(f"sigma={sigma}", noisy_soft(16, T, sigma, seed=T).to(
                    dev), block, overlap, terminated)
            for kind, soft in tie_heavy(T, seed=T).items():
                parity(kind, soft.to(dev), block, overlap, terminated)
    signal = noisy_soft(BATCH, 24, 0.9, seed=24)
    signal[:, ::5] = 0.0
    parity("SIGNAL", signal.to(dev), 24, 0, True)
    parity("ragged", noisy_soft(1, 4200, 0.9, seed=1).to(dev), 1024, 64,
           True)
    parity("ragged", noisy_soft(33, 1500, 0.9, seed=33).to(dev), 512, 64,
           False)
    parity("ragged", noisy_soft(33, 203, 0.9, seed=203).to(dev), 208, 0,
           True)
    pairs_last = noisy_soft(16, 1500, 0.9, seed=5).to(dev)
    parity("non-contiguous",
           pairs_last.transpose(1, 2).contiguous().transpose(1, 2), 512, 64,
           True)
    flat = torch.empty(16 * 1500 * 2 + 1, device=dev)
    flat[1:] = pairs_last.reshape(-1)
    parity("misaligned", flat[1:].view(16, 1500, 2), 512, 64, True)

    x = saturated_batch(BATCH)
    N = x.shape[1]
    xd = device_complex(x)
    nsym = min(rx.max_symbols(rx.C.RATES[RATE], MAX_PSDU),
               max(1, (N - 208) // 80))
    lts1, cfo, det = rx.synchronize(xd)
    eq, snr, wgt = rx.extract_symbols(xd, lts1, cfo, nsym,
                                      return_weights=True)
    _, length, _ = rx.decode_signal(eq[:, 0, :])
    length = torch.clamp(length, 0, MAX_PSDU).to(torch.int32)
    ab = rx.data_soft(eq[:, 1:, :], length, RATE, wgt)     # main-path input
    T = ab.shape[1]
    block, overlap = auto_window(T)
    bench_inputs = {"main-path soft": ab,
                    "sigma 0.9 soft": noisy_soft(BATCH, T, 0.9, 7).to(dev)}
    for name, soft in bench_inputs.items():
        parity(f"bench shape {name}", soft, block, overlap, True)

    # ---- 4. the main path ----------------------------------------------------
    vc.LAUNCHES = 0
    out = rx.rx_pipeline(xd, RATE, max_psdu=MAX_PSDU)
    torch.cuda.synchronize()
    launches = vc.LAUNCHES
    if launches != 1:
        raise AssertionError(f"rx_pipeline launched the kernel {launches} "
                             "times, expected 1")
    host = fetch(out)
    n_ok = int(host["ok"].sum())
    print(f"rx_pipeline {BATCH}x{N}: ok {n_ok}/{BATCH}, kernel launches "
          f"{launches}", flush=True)
    if n_ok != BATCH or not (host["length"] == PSDU_LEN).all():
        raise AssertionError("not every frame decoded")
    psdu = host["psdu"][:, :PSDU_LEN]
    if not (psdu == psdu[0]).all() or not check_fcs(psdu[0].tobytes()):
        raise AssertionError("PSDUs differ or fail the FCS")
    for key in ("det", "cfo", "snr_db"):
        if not np.isfinite(host[key]).all():
            raise AssertionError(f"non-finite {key}")
    small = fetch(rx.rx_pipeline(torch.from_numpy(x[:4]), RATE,
                                 max_psdu=MAX_PSDU))
    check_rows(host, small, 4, ("psdu", "ok", "fcs_ok", "sig_ok", "cs_ok",
                                "truncated", "length", "lts1"))
    print("card and CPU agree on the first 4 rows", flush=True)

    run = lambda: rx.rx_pipeline(xd, RATE, max_psdu=MAX_PSDU)
    for _ in range(3):
        run()
    # throughput: the median of 5 windows of 20 back-to-back batches (the
    # chain is host-launch-bound, so a host hiccup moves one window)
    windows = sorted(cuda_ms(run, 20) for _ in range(5))
    chain_ms = windows[2]
    lat = []                          # per-batch latency, host clock
    for _ in range(100):
        t0 = time.perf_counter()
        fetch(run()["ok"])
        lat.append((time.perf_counter() - t0) * 1e3)
    lat_p50, lat_p90 = (float(v) for v in np.percentile(lat, [50, 90]))
    msps = BATCH * N / chain_ms / 1e3
    mbps = BATCH * PSDU_LEN * 8 / chain_ms / 1e3
    stage_ms = {
        "synchronize": cuda_ms(lambda: rx.synchronize(xd), 20),
        "extract_symbols": cuda_ms(lambda: rx.extract_symbols(
            xd, lts1, cfo, nsym, return_weights=True), 20),
        "decode_signal": cuda_ms(lambda: rx.decode_signal(eq[:, 0, :]), 20),
        "data_soft": cuda_ms(lambda: rx.data_soft(eq[:, 1:, :], length,
                                                  RATE, wgt), 20),
        "viterbi": cuda_ms(lambda: vc.decode_blocks(ab, block, overlap,
                                                    True), 50),
    }
    bits = vc.decode_blocks(ab, block, overlap, True)
    stage_ms["finish_frame"] = cuda_ms(
        lambda: rx._finish_frame(bits, length, T), 20)
    # the kernel alone: the wrapper's host work per call is not timed
    kernel_ms = graph_ms(lambda: vc.decode_blocks(ab, block, overlap, True),
                         50)
    plain_ms = cuda_ms(lambda: vc.decode_blocks_reference(
        ab, block, overlap, True), 3)
    print(f"rx_pipeline: {chain_ms:.3f} ms/batch back to back (events, "
          f"median of 5 windows of 20; range {windows[0]:.3f}-"
          f"{windows[-1]:.3f}); "
          f"{msps:.1f} Msamples/s, {mbps:.1f} Mbps decoded; latency with "
          f"fetch p50 {lat_p50:.3f} ms, p90 {lat_p90:.3f} ms (100 batches)",
          flush=True)
    print("stages ms: " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in stage_ms.items()), flush=True)

    dev_ms, dev_launches, top = profile_device(run, 5)
    if dev_ms is None:
        print("device time: not measured (the profiler saw no device "
              "events)", flush=True)
        idle = None
    else:
        idle = 1.0 - dev_ms / chain_ms
        print(f"device time: kernels {dev_ms:.3f} ms of {chain_ms:.3f} ms "
              f"per batch (idle share {idle:.3f}), {dev_launches:.0f} device "
              "launches per batch; top:", flush=True)
        for name, ms, n in top:
            print(f"  {ms:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)

    sm_hz = max_sm_hz()
    int32_ops_per_s = (INT32_LANES_PER_SM
                       * torch.cuda.get_device_properties(0)
                       .multi_processor_count * sm_hz)
    bnd = viterbi_bound(BATCH, T, block, overlap, int32_ops_per_s)
    # radix-2 ACS, any exact decoder; the TPU's 1024 candidates per step
    ops, ops_radix4, nbytes = bnd["ops"], bnd["ops_radix4"], bnd["bytes"]
    ops_ms, bytes_ms = bnd["ops_ms"], bnd["bytes_ms"]
    bound_ms, bound_by = bnd["bound_ms"], bnd["bound_by"]
    print(f"viterbi kernel ({BATCH}, {T}) block {block} overlap {overlap}: "
          f"{kernel_ms:.4f} ms (graph replay) = "
          f"{BATCH * T / kernel_ms / 1e3:.1f} Mbit/s; "
          f"plain version {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}: {ops / 1e9:.4f} G int32 ops of radix-2 ACS at "
          f"{int32_ops_per_s / 1e12:.2f} T/s (SM clock {sm_hz / 1e9:.3f} "
          f"GHz) = {ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB = {bytes_ms:.4f} "
          f"ms; the TPU formulation's radix-4 count was "
          f"{ops_radix4 / 1e9:.4f} G ops); time/bound "
          f"{kernel_ms / bound_ms:.2f}", flush=True)

    # ---- 5-7. TX, the mixed-rate path, the front end ------------------------
    paths = {"rx_pipeline": launches}
    mixed = tx_and_mixed_phase(torch, dev, rx, vc, parity)
    paths["rx_pipeline_auto"] = mixed.pop("launches")
    paths["rx_pipeline 40m"] = frontend_phase(torch, dev, rx, vc,
                                              host["psdu"][0])

    # ---- 8-9. the device-resident air ----------------------------------------
    soak = soak_phase(torch, vc, parity, int32_ops_per_s, card)
    paths["rx soak"] = soak["launches"]
    convo = convo_phase(vc, card)
    paths["convo"] = convo.pop("launches")

    # ---- 10-11. the wire and the live node ------------------------------------
    wire_phase(torch, dev)
    node = node_phase(torch, dev, vc, parity, int32_ops_per_s, card)
    paths["node"] = node["launches"]
    paths["bridge"] = node["bridge_launches"]

    summary = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s,
               "batch": [BATCH, N], "trellis": [BATCH, T],
               "rx_pipeline_ms": chain_ms, "rx_pipeline_windows_ms": windows,
               "latency_p50_ms": lat_p50,
               "latency_p90_ms": lat_p90,
               "msamples_per_s": msps, "decoded_mbps": mbps,
               "stage_ms": stage_ms, "device_kernel_ms": dev_ms,
               "device_idle_share": idle,
               "device_launches_per_batch": dev_launches,
               "viterbi_mbit_per_s": BATCH * T / kernel_ms / 1e3,
               "viterbi_bound_ms": bound_ms, "viterbi_int32_ops": ops,
               "viterbi_radix4_ops": ops_radix4, "sm_hz": sm_hz,
               "mixed_rate": mixed, "rx_soak": soak["result"],
               "rx_soak_round": soak["round"], "convo": convo,
               "node": node,
               "kernel_launches_by_path": paths}
    print("summary " + json.dumps(summary), flush=True)
    kernels = {"kernels": [{
        "name": "viterbi_radix4", "route": "cuda",
        "source": "sora_tpu_torch/csrc/viterbi.cu",
        "replaces": "sora_tpu/ops/viterbi_pallas.py:218",
        "design": "radix-2 butterfly walk: four radix-2 sub-steps per "
                  "radix-4 step, register branch metrics, shuffled "
                  "butterflies, survivor marks in the packed key for a "
                  "three-lane traceback, soft values prefetched in chunks",
        "launches": launches, "parity": "exact", "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "launches_by_path": paths,
        "soak_shape": soak["shape"], "soak_ms": soak["ms"],
        "soak_plain_ms": soak["plain_ms"],
        "soak_bound_ms": soak["bound_ms"],
        "soak_bound_by": soak["bound_by"],
        "soak_launches_per_round": soak["launches_per_round"],
        "node_shape": node["shape"], "node_ms": node["ms"],
        "node_plain_ms": node["plain_ms"],
        "node_bound_ms": node["bound_ms"],
        "node_bound_by": node["bound_by"],
        "node_launches_per_batch":
            node["launches"] / node["decoded_batches"]}]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
