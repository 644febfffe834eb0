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
5. a JSON line of the kernels, the card line, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CAPTURE = ROOT / "tests" / "data" / "fsample54.dmp"
RATE, PSDU_LEN, BATCH, MAX_PSDU = 54, 1500, 128, 1504

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
    for key in ("psdu", "ok", "fcs_ok", "sig_ok", "cs_ok", "truncated",
                "length", "lts1"):
        if not np.array_equal(small[key], host[key][:4]):
            raise AssertionError(f"card and CPU disagree on {key}")
    for key, tol in (("det", 1e-4), ("cfo", 1e-5), ("snr_db", 0.05)):
        err = float(np.abs(small[key] - host[key][:4]).max())
        if err > tol:
            raise AssertionError(f"card and CPU differ on {key} by {err}")
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

    nwin = BATCH * (-(-T // block))
    win = block + 2 * overlap
    ops = nwin * win * ACS_OPS_PER_STEP        # radix-2 ACS, any exact decoder
    ops_radix4 = nwin * (win // 4) * 1024 * 3  # the TPU's 1024 candidates
    sm_hz = max_sm_hz()
    int32_ops_per_s = (INT32_LANES_PER_SM
                       * torch.cuda.get_device_properties(0)
                       .multi_processor_count * sm_hz)
    nbytes = BATCH * T * 2 * 4 + BATCH * T    # fp32 soft in, uint8 bits out
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / int32_ops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms > ops_ms else "operations"
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
               "viterbi_radix4_ops": ops_radix4, "sm_hz": sm_hz}
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
        "bound_by": bound_by, "library_ms": None}]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
