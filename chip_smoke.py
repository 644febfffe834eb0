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
12. the 11n TX (``phy/dot11n/tx.py``): ``modulate`` on the card and on
   the CPU for MCS 0-15, long and short GI (16 PSDUs of 1500 bytes each),
   equal within 1e-5; the card's waveforms decode through the card's
   fixed-MCS receivers at their MCS and guard;
13. bench.py's 11n row (bench.py:294-336): ``rx_pipeline(x, 15,
   max_psdu=1504)`` on 128 streams of MCS 15 2x2 frames (2 x 3120
   samples) and ``rx_pipeline_1ss(x, 7, ...)`` on 128 streams of MCS 7
   (2 x 4880): ok 128/128 with 2 kernel launches each (HT-SIG and data),
   the first 8 rows equal to the CPU run, timings, stages, the device's
   share, and the kernel on both Viterbi inputs ((128, 48), (128, 12480),
   (128, 12220)); then 128 MCS 15 short-GI frames: 128/128 through
   ``short_gi=True``, 0 through the long-GI call;
14. the mixed-MCS receivers at full width: 16 streams per MCS 8-15
   through ``rx_pipeline_auto`` and 0-7 through ``rx_pipeline_auto_1ss``:
   every row ok with its MCS and PSDU, one row per MCS equal to the CPU
   run, 2 launches per call;
15. the 11n soak air (``tools/realtime_soak.py --phy n``: 512 windows of
   2 x 11264, 64 cached MCS 15 frames): one round without a host sync,
   the kernel on the round's (512, 12480) input, then about 10 s of air
   with every frame position-matched and 2 launches per round;
16. the 11n node on two rings (``apps/node.py --phy n --synthetic 400
   --mixed --batch 64``): one batch card against CPU (4 launches: both
   stream classes' pipelines), two steps without an implicit sync, the
   400 frames written once and decoded (frame_ok >= 98%, crc_fail <= 2%,
   4 launches per decoded batch);
17. the 11b TX (``phy/dot11b/tx.py``): ``modulate`` on the card and on the
   CPU at 1, 2, 5.5 and 11 Mbps long and 2, 5.5 and 11 Mbps short (16
   PSDUs of 1000 bytes each), equal within 1e-5; the card's waveforms
   decode through the card's ``rx_pipeline`` at their rate and through
   ``rx_pipeline_auto``;
18. bench.py's 11b row (bench.py:269-291, built by ``tools/bench.py``):
   ``rx_pipeline_auto(x, max_psdu=1024)`` on 128 streams of one 1000-byte
   11 Mbps CCK frame (10512 chips): ok 128/128, the PSDUs FCS-valid, the
   first 8 rows equal to the CPU run; ``rx_pipeline(x, 11, ...)`` and the
   short-preamble batch at 128/128; timings (median of 5 windows of 20),
   latency, stages and the device's share;
19. the 11b chip front end: the same row pulse shaped to 44 Msps, and
   resampled to 40 Msps, through ``chip_frontend_44m`` / ``_40m`` and the
   receiver: 128/128 each, the first 4 rows equal to the CPU run;
20. the 11b soak air (``tools/realtime_soak.py --phy b``: 512 windows of
   8192 chips, 64 cached 278-byte 11 Mbps frames): one round without a
   host sync, its device time, then about 10 s of air with every frame
   position-matched;
21. the 11b node (``apps/node.py --phy b --synthetic 400 --mixed --batch
   64``, the gap at the node's hop): one batch card against CPU, two steps
   without an implicit sync, the 400 frames written once and decoded
   (frame_ok >= 98%, crc_fail <= 2%, ACKs sent), the device-only ratio;
22. sharding: ``parallel.shard.make_mesh(1)`` (a (1, 1) mesh over an
   NCCL world of 1) and the six sharded receivers on the inputs the
   earlier phases built — ``rx_pipeline_sharded(x, mesh, 54, max_psdu=
   1504)`` on the 128 x 5452 capture batch, ``rx_pipeline_sharded_auto``
   on the 128 x 40736 mixed-rate batch and on the raw 40 Msps capture
   (``input_rate="40m"``), ``rx_pipeline_sharded_11n`` MCS 15 on 128 x 2 x
   3120, ``rx_pipeline_sharded_11n_auto`` on the mixed-MCS 8-15 batch and
   ``rx_pipeline_sharded_11b`` on bench.py's 11b row: ok 128/128, 1, 1, 1,
   2, 2 and 0 kernel launches, every exact field (and lts1 from the
   sharded sync) equal to the unsharded pipeline on the same input, cfo /
   det / snr_db within 1e-6 / 1e-4 / 1e-3; the kernel against its plain
   version on the sharded 11a call's own Viterbi input; sharded and
   unsharded times (median of 5 interleaved windows of 20) and their
   ratio, the sharding tax at (1, 1), with each one's device time and
   launches; the event time of each size-1 NCCL collective.  Several
   ranks on one card are not driven: NCCL refuses two ranks on one GPU,
   and gloo's send/recv of CUDA tensors, which the halo needs, fails on
   the card (PERF.md); the multi-rank program is held by the CPU tests;
23. ``apps.tvws`` at its CLI defaults: exit 0, 8/8 frames, 1 launch per
   ``decode_band``; ``decode_band`` on the card equal to the CPU frame for
   frame;
24. ``apps.sniffer``: 32 mixed-rate synthetic frames to a pcap that reads
   back equal to the logged frames, and the 40 Msps capture replayed for
   3 s, frames above 0; each run 1 launch for the node's warm-up and 1
   per decoded batch;
25. ``apps.demod11``: mod then demod through the torch chain for 11a (54
   Mbps), 11b (11 Mbps) and 11n (MCS 15, two dumps), the raw 40 Msps
   capture through the device front end, and ``--mode ack --rate 24``
   MATCH; 1, 0, 2, 1 and 0 launches;
26. the SDL layer (``sdl.py``): ``Signal`` through a 14- and a 16-bit
   dump, ``resample`` 20 -> 40 -> 20 Msps on the card against the CPU
   within 1e-5, ``spectrum`` and ``snr_db`` on a tone; ``Radio(phy="a")``
   at the node width of phase 11 fed the most frames of the node app's
   24 Mbps traffic (gap 900) that one write into its ring of 2^22 holds,
   drained through ``rx``: crc_fail <= 2% and the data frames delivered
   >= 98% of the K-frames-a-hop ceiling (K = 11 candidates a window bind
   on this traffic, as they do in the JAX package's Radio:
   tests/test_torch_sdl.py holds the two to one payload list there; the
   node's frame_ok also counts the ACKs that its loopback sink writes
   back, so it is not gated), one launch per decoded batch;
   ``Radio(phy="n")`` on two rings at phase 16's node (4 launches per
   batch) and ``Radio(phy="b")`` at phase 21's node with the largest
   batch whose two spans fit the ring (0 launches), each delivering >= 98%
   of its frames; the device-only ratio of each;
   ``Radio.replay`` of the 40 Msps capture in the wire's units: crc_fail
   0;
27. ``apps.speanalyzer`` ``--tone 3.2e6 --msps 20 --trace`` and ``--dump``
   of the capture: exit 0 with the CPU's peak, the trace read back by
   ``apps.plotview``, ``welch_spectrum`` card against CPU within 0.01 dB
   over the bins above peak - 80 dB, its time at 262144 samples, nfft
   1024; 0 launches;
28. ``apps.node --dump fsample54.dmp --msps 40`` for 3 s: the 64-QAM
   frames decode with crc_fail 0; the same run on raw ADC counts (the JAX
   app's replay) loses them to the CRC; 1 launch for the warm-up and 1
   per decoded batch;
29. the sensitivity sweep (``tools/sensitivity_sweep.py``) at its default
   grid, all five sweeps: the tables, exactly 1 launch per 11a call, 2
   per 11n call, 0 per 11b call; the kernel against its plain version on
   the 11a 6 Mbps call at 3 dB; the 54 Mbps and MCS 15 rows frame for
   frame against the CPU; the wall time; the kernel's time and bound at
   the sweep's largest 11a and 11n shapes;
30. ``tools.ping_over_air`` where the machine has root, /dev/net/tun and
   iproute2's ``ip`` (exit 0, ``udp-echo-over-air OK``), else one line
   saying why not;
31. a JSON line of the kernels, the card line, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Every path is driven with the kernel's launch counter set to 0 just before
and read just after, and fails if the kernel was not launched — or, for
the 11b paths, the ACK and the spectrum analyzer, which reach no Viterbi,
if it was launched at all.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from sora_tpu_torch.tools.bench import card_line, cuda_ms, graph_ms

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
# the 802.11n cells: bench.py's 11n row (bench.py:294-336), the soak air
# (tools/realtime_soak.py:83-101) and the node that apps/node.py --phy n
# --synthetic 400 --mixed --batch 64 builds (apps/node.py:176-233)
HT_BATCH, HT_NOISE, HT_CPU_ROWS = 128, 0.02, 8
HT_SOAK_SECONDS = 10.0
HT_NODE_CFG = dict(phy="n", max_psdu=256, min_rate_mbps=8, batch=64)
HT_NODE_FRAMES, HT_NODE_RING = 400, 1 << 22
# the 802.11b cells: bench.py's 11b row (bench.py:269-291), the soak air
# (tools/realtime_soak.py:72-82) and the node that apps/node.py --phy b
# --synthetic 400 --mixed --batch 64 builds (apps/node.py:176-212)
B11_PSDU, B11_MAX_PSDU, B11_TX_ROWS, B11_CPU_ROWS = 1000, 1024, 16, 8
B11_SOAK_SECONDS = 10.0
B11_NODE_CFG = dict(phy="b", max_psdu=256, min_rate_mbps=1, batch=64,
                    input_rate="11m", sample_rate_sps=11e6)
B11_NODE_FRAMES, B11_NODE_RING = 400, 1 << 25

# The card's peaks for the kernel's bound: HBM bandwidth of one H100 SXM
# (NVIDIA's data sheet, at the full 700 W limit), and its int32 issue rate:
# 64 INT32 lanes per SM (Hopper architecture white paper) times the SMs
# times the SM clock (nvidia-smi's clocks.max.sm; 1.98 GHz published boost).
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
BOOST_SM_HZ = 1.98e9
# int32 operations of one decoded Viterbi step: a radix-2
# add-compare-select per state (2 adds, 1 min) for 64 states
ACS_OPS_PER_STEP = 64 * 3


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
    """The least time of the decode: radix-2 ACS int32 operations of the
    B * T steps that the decode needs at the int32 issue rate, or the bytes
    (fp32 soft in, uint8 bits out) at the HBM rate, whichever is larger.
    ``window_steps`` is what the block-parallel windows run: the last
    block padded to a whole one, plus an overlap on each side."""
    nwin = B * (-(-T // block))
    win = block + 2 * overlap
    ops = B * T * ACS_OPS_PER_STEP
    nbytes = B * T * 2 * 4 + B * T
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / int32_ops_per_s * 1e3
    return {"ops": ops, "ops_radix4": nwin * (win // 4) * 1024 * 3,
            "window_steps": nwin * win, "steps": B * T,
            "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


def kernel_timing(vc, ab, int32_ops_per_s, plain_reps: int = 1) -> dict:
    """The kernel's graph-replay time, the plain version's time and the
    bound at the decode_auto window of ab (B, T, 2)."""
    B, T = ab.shape[:2]
    block, overlap = auto_window(T)
    ms = graph_ms(lambda: vc.decode_blocks(ab, block, overlap, True), 50)
    plain = cuda_ms(lambda: vc.decode_blocks_reference(ab, block, overlap,
                                                       True), plain_reps)
    bnd = viterbi_bound(B, T, block, overlap, int32_ops_per_s)
    return {"shape": [B, T], "block": block, "overlap": overlap, "ms": ms,
            "plain_ms": plain, **{k: bnd[k] for k in (
                "bound_ms", "bound_by", "ops", "ops_ms", "bytes",
                "bytes_ms", "steps", "window_steps")}}


def print_kernel(name: str, k: dict) -> None:
    B, T = k["shape"]
    print(f"viterbi kernel at the {name} shape ({B}, {T}) block {k['block']} "
          f"overlap {k['overlap']} = {B * (-(-T // k['block']))} windows: "
          f"{k['ms']:.4f} ms (graph replay); plain version "
          f"{k['plain_ms']:.3f} ms; bound {k['bound_ms']:.4f} ms "
          f"({k['bound_by']}: {k['ops'] / 1e9:.4f} G int32 ops = "
          f"{k['ops_ms']:.4f} ms; {k['bytes'] / 1e6:.2f} MB = "
          f"{k['bytes_ms']:.4f} ms); time/bound "
          f"{k['ms'] / k['bound_ms']:.2f}; the windows run "
          f"{k['window_steps'] / k['steps']:.3f}x the {k['steps']} steps "
          "the decode needs", flush=True)


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
            "tx_max_abs_err": worst, "launches": launches, "x": x}


def frontend_phase(torch, dev, rx, vc, psdu0: np.ndarray):
    """Phase 7: the raw 40 Msps capture through the front end and the
    fixed-rate receiver, 128 streams.  Returns (launches, the batch on
    the card)."""
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
    return launches, xd


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
    parity("soak round soft", ab, *auto_window(ab.shape[1]), True)
    kern = kernel_timing(vc, ab, int32_ops_per_s)
    print_kernel("soak", kern)
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
            "kernel": kern}


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
    parity("node batch soft", ab, *auto_window(ab.shape[1]), True)
    kern = kernel_timing(vc, ab, int32_ops_per_s)
    print_kernel("node", kern)

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
            "bridge_launches": b_launches, "kernel": kern}


# ---------------------------------------------------------------------------
# 802.11n (phases 12-16)
# ---------------------------------------------------------------------------


def ht_place(torch, dev, w, offs, N: int, gen, noise: float = HT_NOISE):
    """Streams (B, 2, N) on the card holding waveform w[i] at offs[i]:
    a (2, n) 2x2 waveform puts chain a on antenna a (bench.py's identity
    channel), a (1, n) single-stream one goes to both antennas; plus
    complex Gaussian noise of ``noise`` rms per part, drawn on the card."""
    B = w.shape[0]
    x = torch.zeros(B, 2, N, dtype=torch.complex64, device=dev)
    for i in range(B):
        x[i, :, offs[i]: offs[i] + w.shape[-1]] = w[i]
    nz = torch.randn(2, B, 2, N, generator=gen, device=dev) * noise
    return x + torch.complex(nz[0], nz[1])


HT_ROW_KEYS = ("psdu", "ok", "fcs_ok", "sig_ok", "mcs", "length")


def ht_tx_phase(torch, dev, vc) -> dict:
    """Phase 12: the 11n TX on the card against the CPU for MCS 0-15, long
    and short GI (16 PSDUs of 1500 bytes each); the card's waveforms
    decode through the card's fixed-MCS receivers at their MCS."""
    from sora_tpu_torch.phy.dot11n import rx as nrx
    from sora_tpu_torch.phy.dot11n import tx as ntx
    from sora_tpu_torch.util.xfer import fetch

    arr = psdus_1500(16, seed=12)
    rows = torch.from_numpy(arr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    worst, launches = 0.0, 0
    for mcs in range(16):
        for sgi in (False, True):
            w = ntx.modulate(rows.to(dev), mcs, PSDU_LEN, short_gi=sgi)
            err = float((w.cpu() - ntx.modulate(rows, mcs, PSDU_LEN,
                                                short_gi=sgi)).abs().max())
            worst = max(worst, err)
            if err > TX_ATOL:
                raise AssertionError(f"11n TX MCS {mcs} sgi {sgi}: card and "
                                     f"CPU differ by {err}")
            x = ht_place(torch, dev, w, [60] * 16, w.shape[-1] + 200, gen)
            pipe = nrx.rx_pipeline_1ss if mcs < 8 else nrx.rx_pipeline
            vc.LAUNCHES = 0
            out = fetch(pipe(x, mcs, max_psdu=MAX_PSDU, short_gi=sgi))
            launches += launched(vc, f"11n MCS {mcs} sgi {sgi}", 2)
            if not (out["ok"].all() and (out["mcs"] == mcs).all() and (
                    out["psdu"][:, :PSDU_LEN] == arr).all()):
                raise AssertionError(f"the card's MCS {mcs} (sgi {sgi}) "
                                     "waveforms do not decode")
    print(f"ntx.modulate, MCS 0-15 x long/short GI x {len(arr)} PSDUs of "
          f"{PSDU_LEN} "
          f"bytes: card and CPU agree within {worst:.2e} (tolerance "
          f"{TX_ATOL:g}); the card's waveforms decode at their MCS and GI: "
          f"ok {len(arr)}/{len(arr)} in each of 32 calls, kernel launches "
          f"{launches} (2 per call)", flush=True)
    return {"max_abs_err": worst, "launches": launches}


def ht_fixed_phase(torch, dev, vc, parity, int32_ops_per_s, mcs: int,
                   seed: int) -> dict:
    """Phase 13: bench.py's 11n row (bench.py:294-336) on the card:
    128 streams of one MCS (15: 2x2; 7: single stream), 1500-byte frames
    from the card's TX at offsets 30 + (7 i) % 300 in n + 400 samples,
    noise 0.02.  ok 128/128 with 2 kernel launches (HT-SIG and data), the
    first rows equal to the CPU run, timings, the device's share, and the
    kernel on both of the path's Viterbi inputs."""
    from sora_tpu_torch.phy.dot11n import rx as nrx
    from sora_tpu_torch.phy.dot11n import tx as ntx
    from sora_tpu_torch.util.xfer import fetch

    one_ss = mcs < 8
    name = f"MCS {mcs} {'single-stream' if one_ss else '2x2'}"
    arr = psdus_1500(HT_BATCH, seed=seed)
    w = ntx.modulate(torch.from_numpy(arr).to(dev), mcs, PSDU_LEN)
    N = w.shape[-1] + 400
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    offs = [30 + (7 * i) % 300 for i in range(HT_BATCH)]
    xd = ht_place(torch, dev, w, offs, N, gen)
    pipe = nrx.rx_pipeline_1ss if one_ss else nrx.rx_pipeline
    run = lambda: pipe(xd, mcs, max_psdu=MAX_PSDU)
    run()                                        # first-use tables
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        out = run()
        torch.cuda.synchronize()
    launches = launched(vc, f"{pipe.__name__} {name}", 2)
    host = fetch(out)
    n_ok = int(host["ok"].sum())
    print(f"{pipe.__name__} {name} {HT_BATCH}x2x{N}: ok {n_ok}/{HT_BATCH}, "
          f"kernel launches {launches}", flush=True)
    if (n_ok != HT_BATCH or not (host["mcs"] == mcs).all()
            or not (host["psdu"][:, :PSDU_LEN] == arr).all()):
        raise AssertionError(f"the {name} batch did not decode")
    for key in ("det", "cfo", "snr_db"):
        if not np.isfinite(host[key]).all():
            raise AssertionError(f"non-finite {key}")
    cpu = fetch(pipe(xd[:HT_CPU_ROWS].cpu(), mcs, max_psdu=MAX_PSDU))
    check_rows(host, cpu, HT_CPU_ROWS, HT_ROW_KEYS + ("cs_ok", "lts1"))
    print(f"card and CPU agree on the first {HT_CPU_ROWS} rows", flush=True)
    sig_ab, data_ab = seen
    parity(f"{name} HT-SIG soft", sig_ab, *auto_window(sig_ab.shape[1]), True)
    parity(f"{name} data soft", data_ab, *auto_window(data_ab.shape[1]),
           True)

    for _ in range(2):
        run()
    windows = sorted(cuda_ms(run, 20) for _ in range(5))
    chain_ms = windows[2]
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        fetch(run()["ok"])
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = (float(v) for v in np.percentile(lat, [50, 90]))
    msps = HT_BATCH * N / chain_ms / 1e3          # per antenna
    mbps = HT_BATCH * PSDU_LEN * 8 / chain_ms / 1e3
    nsym = min(nrx.max_symbols(mcs, MAX_PSDU),
               max(1, (N - (528 if one_ss else 608)) // 80))
    lts1, cfo, det = nrx.synchronize(xd)
    if one_ss:
        ext = lambda: nrx.extract_symbols_1ss(xd, lts1, cfo, nsym,
                                              return_weights=True)
    else:
        ext = lambda: nrx.extract_symbols(xd, lts1, cfo, nsym,
                                          return_weights=True)
    sig_eq, xdd, _, wgt = ext()
    _, length, _, _ = nrx.decode_htsig(sig_eq[:, 1:])
    length = torch.clamp(length, 0, MAX_PSDU).to(torch.int32)
    block, overlap = auto_window(data_ab.shape[1])
    bits = vc.decode_blocks(data_ab, block, overlap, True)
    stage_ms = {
        "synchronize": cuda_ms(lambda: nrx.synchronize(xd), 20),
        "extract_symbols": cuda_ms(ext, 20),
        "decode_lsig": cuda_ms(lambda: nrx.decode_lsig(sig_eq[:, 0]), 20),
        "decode_htsig": cuda_ms(lambda: nrx.decode_htsig(sig_eq[:, 1:]), 20),
        "data_soft": cuda_ms(lambda: nrx.data_soft(xdd, length, mcs, wgt),
                             20),
        "viterbi": cuda_ms(lambda: vc.decode_blocks(data_ab, block, overlap,
                                                    True), 50),
        "finish_frame": cuda_ms(lambda: nrx._finish_frame(
            bits, length, data_ab.shape[1], MAX_PSDU), 20),
    }
    dev_ms, dev_launches, top = profile_device(run, 5)
    idle = None if dev_ms is None else 1.0 - dev_ms / chain_ms
    print(f"{pipe.__name__} {name}: {chain_ms:.3f} ms/batch (events, median "
          f"of 5 windows of 20; range {windows[0]:.3f}-{windows[-1]:.3f}); "
          f"{msps:.1f} Msamples/s per antenna, {mbps:.1f} Mbps decoded; "
          f"latency with fetch p50 {p50:.3f} ms, p90 {p90:.3f} ms (50 "
          "batches)", flush=True)
    print("stages ms: " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in stage_ms.items()), flush=True)
    if dev_ms is None:
        print("device time: not measured (the profiler saw no device "
              "events)", flush=True)
    else:
        print(f"device time: kernels {dev_ms:.3f} ms of {chain_ms:.3f} ms per "
              f"batch (idle share {idle:.3f}), {dev_launches:.0f} device "
              "launches per batch; top:", flush=True)
        for kname, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {kname[:90]}", flush=True)
    kern = {"htsig": kernel_timing(vc, sig_ab, int32_ops_per_s, 3),
            "data": kernel_timing(vc, data_ab, int32_ops_per_s)}
    print_kernel(f"{name} HT-SIG", kern["htsig"])
    print_kernel(f"{name} data", kern["data"])
    return {"batch": [HT_BATCH, 2, N], "ms": chain_ms, "windows_ms": windows,
            "msamples_per_s_per_antenna": msps, "decoded_mbps": mbps,
            "latency_p50_ms": p50, "latency_p90_ms": p90,
            "stage_ms": stage_ms, "device_ms": dev_ms, "idle_share": idle,
            "device_launches": dev_launches, "launches": launches,
            "kernel": kern, "x": xd}


def ht_sgi_phase(torch, dev, vc) -> int:
    """Phase 13, short GI: 128 streams of MCS 15 short-GI frames: ok
    128/128 through ``rx_pipeline(..., short_gi=True)``, ok 0 through the
    long-GI call."""
    from sora_tpu_torch.phy.dot11n import rx as nrx
    from sora_tpu_torch.phy.dot11n import tx as ntx
    from sora_tpu_torch.util.xfer import fetch

    arr = psdus_1500(HT_BATCH, seed=14)
    w = ntx.modulate(torch.from_numpy(arr).to(dev), 15, PSDU_LEN,
                     short_gi=True)
    N = w.shape[-1] + 400
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    xd = ht_place(torch, dev, w, [30 + (7 * i) % 300 for i in range(HT_BATCH)],
                  N, gen)
    got = {}
    for sgi in (True, False):
        vc.LAUNCHES = 0
        out = fetch(nrx.rx_pipeline(xd, 15, max_psdu=MAX_PSDU, short_gi=sgi))
        launched(vc, f"rx_pipeline short_gi={sgi}", 2)
        got[sgi] = int(out["ok"].sum())
        if sgi and not (out["psdu"][:, :PSDU_LEN] == arr).all():
            raise AssertionError("the short-GI PSDUs differ")
    print(f"rx_pipeline MCS 15 short GI {HT_BATCH}x2x{N}: ok "
          f"{got[True]}/{HT_BATCH} with short_gi=True, ok {got[False]} "
          "through the long-GI call", flush=True)
    if got[True] != HT_BATCH or got[False] != 0:
        raise AssertionError("short GI: wrong ok counts")
    return 2 * 2


def ht_mixed_phase(torch, dev, vc, parity, one_ss: bool) -> dict:
    """Phase 14: the mixed-MCS receivers at full width, 128 streams, 16
    per MCS (8-15 through ``rx_pipeline_auto``, 0-7 through
    ``rx_pipeline_auto_1ss``), 1500-byte frames from the card's TX plus
    noise 0.02 in a window that holds the slowest MCS's frame + 400."""
    from sora_tpu_torch.phy.dot11n import rx as nrx
    from sora_tpu_torch.phy.dot11n import tx as ntx
    from sora_tpu_torch.util.xfer import fetch

    mcss = list(range(8)) if one_ss else list(range(8, 16))
    arr = psdus_1500(HT_BATCH, seed=15 + one_ss)  # row i at mcss[i % 8]
    rows = torch.from_numpy(arr).to(dev)
    waves = [ntx.modulate(rows[ri::8], mc, PSDU_LEN)
             for ri, mc in enumerate(mcss)]
    N = max(w.shape[-1] for w in waves) + 400
    gen = torch.Generator(device=dev)
    gen.manual_seed(15 + one_ss)
    x = torch.zeros(HT_BATCH, 2, N, dtype=torch.complex64, device=dev)
    for i in range(HT_BATCH):
        w = waves[i % 8][i // 8]
        off = 30 + (7 * (i // 8)) % 300
        x[i, :, off: off + w.shape[-1]] = w
    nz = torch.randn(2, HT_BATCH, 2, N, generator=gen, device=dev) * HT_NOISE
    x = x + torch.complex(nz[0], nz[1])
    pipe = nrx.rx_pipeline_auto_1ss if one_ss else nrx.rx_pipeline_auto
    run = lambda: pipe(x, max_psdu=MAX_PSDU)
    run()
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        out = run()
        torch.cuda.synchronize()
    launches = launched(vc, pipe.__name__, 2)
    host = fetch(out)
    want_mcs = np.array([mcss[i % 8] for i in range(HT_BATCH)])
    n_ok = int(host["ok"].sum())
    print(f"{pipe.__name__} {HT_BATCH}x2x{N}, 16 streams per MCS "
          f"{mcss[0]}-{mcss[-1]}: ok {n_ok}/{HT_BATCH}, kernel launches "
          f"{launches}", flush=True)
    if (n_ok != HT_BATCH or not (host["mcs"] == want_mcs).all()
            or not (host["psdu"][:, :PSDU_LEN] == arr).all()):
        raise AssertionError(f"the {pipe.__name__} batch did not decode")
    cpu = fetch(pipe(x[:8].cpu(), max_psdu=MAX_PSDU))
    check_rows(host, cpu, 8, HT_ROW_KEYS + ("cs_ok", "lts1"))
    print("card and CPU agree on the first 8 rows (one per MCS)", flush=True)
    for name, ab in zip(("HT-SIG", "data"), seen):
        parity(f"{pipe.__name__} {name} soft", ab, *auto_window(ab.shape[1]),
               True)
    for _ in range(2):
        run()
    ms = sorted(cuda_ms(run, 5) for _ in range(3))[1]
    print(f"{pipe.__name__}: {ms:.3f} ms/batch (events, median of 3 windows "
          f"of 5); {HT_BATCH * N / ms / 1e3:.1f} Msamples/s per antenna, "
          f"{HT_BATCH * PSDU_LEN * 8 / ms / 1e3:.1f} Mbps decoded",
          flush=True)
    return {"batch": [HT_BATCH, 2, N], "trellis": list(seen[1].shape[:2]),
            "ms": ms, "msamples_per_s_per_antenna": HT_BATCH * N / ms / 1e3,
            "decoded_mbps": HT_BATCH * PSDU_LEN * 8 / ms / 1e3,
            "launches": launches, "x": x}


def ht_soak_phase(torch, vc, parity, int32_ops_per_s, card) -> dict:
    """Phase 15: the 11n soak air (tools/realtime_soak.py --phy n): one
    round under set_sync_debug_mode("error"), the kernel on the round's
    own Viterbi inputs, the round's device time, then ``run_rx_soak(phy=
    "n")`` with every frame position-matched and 2 launches per round."""
    from sora_tpu_torch.tools import realtime_soak as soak
    from sora_tpu_torch.util.xfer import fetch

    air, _, span = soak.make_rx_soak_air(phy="n")
    period = span + soak.SOAK_GAP["n"]
    tx = [(int((off // period) % 64), int(off), 1.0)
          for off in range(1000, air.advance, period)]
    for _ in range(2):
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
    launched(vc, "one 11n soak round", 2)
    out = fetch(outs[0])
    print(f"11n soak round ({air.batch}x2x{air.window}, hop {air.hop}): no "
          f"host sync inside DeviceAir.step (set_sync_debug_mode('error')); "
          f"{int(out['ok'].sum())} ok rows of {len(out['ok'])} for {len(tx)} "
          "frames sent", flush=True)
    for name, ab in zip(("HT-SIG", "data"), seen):
        parity(f"11n soak round {name} soft", ab, *auto_window(ab.shape[1]),
               True)
    kern = kernel_timing(vc, seen[1], int32_ops_per_s)
    print_kernel("11n soak", kern)
    dev_ms, dev_launches, top = profile_device(lambda: air.step(tx), 3)

    log = lambda *a: print("  11n soak:", *a, flush=True)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    res = soak.run_rx_soak(HT_SOAK_SECONDS, SOAK_DEPTH, log, phy="n")
    torch.cuda.synchronize()
    n_rounds = res["rounds"] + res["warm_rounds"]
    launches = launched(vc, "the 11n soak", 2 * n_rounds)
    wall_round_ms = res["wall_seconds"] * 1e3 / res["rounds"]
    idle = None if dev_ms is None else 1.0 - dev_ms / wall_round_ms
    print(f"11n soak: {res['air_seconds']} s of 20 Msps 2-antenna air in "
          f"{res['wall_seconds']} s wall, real-time ratio {res['ratio']}; "
          f"{res['msps']} Msamples/s per antenna, {res['decoded_mbps']} Mbps "
          f"decoded; frames delivered {res['frames_delivered']}/"
          f"{res['frames_scheduled']}; kernel launches {launches} in "
          f"{n_rounds} rounds ({launches / n_rounds:g} per round)",
          flush=True)
    if dev_ms is None:
        print("11n soak round device time: not measured (the profiler saw no "
              "device events)", flush=True)
    else:
        print(f"11n soak round device time: {dev_ms:.3f} ms of "
              f"{wall_round_ms:.3f} ms wall per round in the soak (idle share "
              f"{idle:.3f}), {dev_launches:.0f} device launches per round; "
              "top:", flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)
    print(card, flush=True)
    return {"result": res, "launches": launches,
            "launches_per_round": launches / n_rounds,
            "round": {"device_ms": dev_ms, "wall_ms": wall_round_ms,
                      "idle_share": idle, "device_launches": dev_launches},
            "kernel": kern}


def _ht_windows(node, src: np.ndarray, batches: int) -> np.ndarray:
    """The (2, N) source tiled to ``batches`` node batches plus the overlap
    on each antenna."""
    cfg = node.cfg
    n = cfg.overlap + (cfg.window - cfg.overlap) * cfg.batch * batches
    return np.tile(src, (1, -(-n // src.shape[-1])))[:, :n]


def ht_node_phase(torch, dev, vc, parity, int32_ops_per_s, card) -> dict:
    """Phase 16: the 11n node on two rings at the configuration of
    ``apps/node.py --phy n --synthetic 400 --mixed --batch 64``: one batch
    card against CPU, two steps without an implicit host sync, then the
    400 mixed-MCS frames written once into both rings and decoded until
    idle."""
    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.mac.frame import build_ack_frame
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink
    from sora_tpu_torch.util.xfer import I16_SCALE, device_quantized, fetch

    cfg = NodeConfig(addr=NODE_ADDR, **HT_NODE_CFG)
    hop = cfg.window - cfg.overlap
    nsamp = cfg.window + hop * (cfg.batch - 1)
    air_s = nsamp / cfg.sample_rate_sps
    rings = [RxRing(capacity=HT_NODE_RING) for _ in range(2)]
    node = StreamingNode(rings, cfg, tx_sink=TxSink(), device=dev)
    t0 = time.perf_counter()
    node.warm_up()
    warm_s = time.perf_counter() - t0
    src = synthetic_traffic(HT_NODE_FRAMES, NODE_ADDR, mixed=True, rate=8,
                            gap=hop, phy="n", device=dev)
    print(f"11n node: window {cfg.window} overlap {cfg.overlap} hop {hop} "
          f"batch {cfg.batch}, two rings of {HT_NODE_RING}, {nsamp} samples "
          f"= {air_s * 1e3:.2f} ms of air per batch, wire {cfg.wire}; "
          f"warm-up {warm_s:.2f} s; traffic 2x{src.shape[-1]} samples "
          f"({HT_NODE_FRAMES} frames of 148 bytes, MCS 8-15, gap {hop})",
          flush=True)

    # ---- one batch, card against CPU ----------------------------------------
    hs = []
    for a in range(2):
        feed = RxRing(capacity=HT_NODE_RING)
        vs = feed.alloc_vstream()
        feed.write(_ht_windows(node, src, 1)[a])
        hs.append(feed.read_windows(vs, cfg.window, hop, cfg.batch,
                                    I16_SCALE, np.int16)[0])
        feed.close()
    h = np.stack(hs, axis=1)                        # (B, 2, window, 2)
    xd = device_quantized(h, dev)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        out = fetch(node._decode(xd))
    launched(vc, "one 11n node batch", 4)
    cpu = fetch(node._decode(device_quantized(h[:HT_CPU_ROWS], "cpu")))
    for k in (1, 2):
        for key in ("ok", "length", "psdu", "mcs"):
            if not np.array_equal(cpu[k][key], out[k][key][:HT_CPU_ROWS]):
                raise AssertionError(f"11n node batch: card and CPU disagree "
                                     f"on {key}")
    n_ok = int(out[1]["ok"].sum() + out[2]["ok"].sum())
    if n_ok == 0:
        raise AssertionError("the 11n node batch decoded nothing")
    print(f"11n node batch {cfg.batch}x2x{cfg.window} (i16 wire, n_both): "
          f"{n_ok} ok rows (2x2 {int(out[1]['ok'].sum())}, single-stream "
          f"{int(out[2]['ok'].sum())}), Viterbi inputs "
          f"{[tuple(s.shape) for s in seen]}, kernel launches 4; card and "
          f"CPU agree on ok, length, psdu, mcs of the first {HT_CPU_ROWS} "
          "windows in both pipelines", flush=True)
    for ab in seen:
        parity("11n node batch soft", ab, *auto_window(ab.shape[1]), True)
    kern = kernel_timing(vc, seen[1], int32_ops_per_s)
    print_kernel("11n node 2x2 data", kern)

    # ---- two steps without an implicit host sync ----------------------------
    for a, r in enumerate(rings):
        r.write(_ht_windows(node, src, 3)[a])
    node.step()
    node.cache.get(build_ack_frame(b"\x02PEER0"), cfg.ack_rate)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        node.step()
        node.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    node.flush()
    if node.stats.decoded_batches < 3 or node.stats.frame_ok == 0:
        raise AssertionError("the checked 11n steps did not decode:\n"
                             + node.report())
    print("11n node step: no implicit host sync while it assembles, uploads "
          "and issues detect and decode on two rings "
          "(set_sync_debug_mode('error'), 2 steps); "
          f"{node.stats.frame_ok} frames in {node.stats.decoded_batches} "
          "batches", flush=True)
    for r in rings:
        r.close()

    # ---- the 400 frames, written once, decoded until idle -------------------
    rings = [RxRing(capacity=HT_NODE_RING) for _ in range(2)]
    node = StreamingNode(rings, cfg, tx_sink=TxSink(), device=dev)
    node.warm_up()
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    t0 = time.perf_counter()
    for a, r in enumerate(rings):
        r.write(src[a])
    idle = 0
    while idle < 3:
        idle = 0 if node.step() else idle + 1
    node.flush()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    for r in rings:
        r.close()
    st, rep = node.stats, node.sw.report()
    batches = st.decoded_batches
    launches = launched(vc, "the 11n node run", 4 * batches)
    wall_batch_ms = run_s * 1e3 / max(1, batches)
    print(f"11n node run ({HT_NODE_FRAMES} frames written once, stepped to "
          f"idle): frame_ok {st.frame_ok}, crc_fail {st.crc_fail}, plcp_fail "
          f"{st.plcp_fail}, dup {st.dup}, cs_timeout {st.cs_timeout}, acks "
          f"{st.acks_tx}; decoded batches {batches}, kernel launches "
          f"{launches} (4 per batch); {run_s:.2f} s wall, {wall_batch_ms:.2f} "
          f"ms per batch of {air_s * 1e3:.2f} ms air, MacStopwatch avg ratio "
          f"{rep.avg_ratio:.4f} (max {rep.max_ratio:.4f}; not gated)",
          flush=True)
    if (st.frame_ok < 0.98 * HT_NODE_FRAMES
            or st.crc_fail > 0.02 * HT_NODE_FRAMES):
        raise AssertionError("11n node run failed:\n" + node.report())

    # device-only: detect + decode of one batch, CUDA events and profiler
    issue = lambda: (node._detect(xd), node._decode(xd))
    issue()
    dev_only_ms = cuda_ms(issue, 10)
    dev_ms, dev_launches, top = profile_device(issue, 3)
    idle = None if dev_ms is None else 1.0 - dev_ms / wall_batch_ms
    print(f"11n node device-only: {dev_only_ms:.3f} ms detect+decode per "
          f"batch (events, 10 calls) over {air_s * 1e3:.2f} ms of air: ratio "
          f"{dev_only_ms / 1e3 / air_s:.4f}", flush=True)
    if dev_ms is None:
        print("11n node batch device time: not measured (the profiler saw "
              "no device events)", flush=True)
    else:
        print(f"11n node batch device time: {dev_ms:.3f} ms per "
              f"detect+decode ({dev_launches:.0f} device launches); idle "
              f"share of the run {idle:.4f}; top:", flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)
    print(card, flush=True)
    return {"config": {"window": cfg.window, "overlap": cfg.overlap,
                       "hop": hop, "batch": cfg.batch,
                       "air_ms_per_batch": air_s * 1e3},
            "warm_s": warm_s, "frames": st.frame_ok,
            "crc_fail": st.crc_fail, "plcp_fail": st.plcp_fail,
            "dup": st.dup, "decoded_batches": batches, "launches": launches,
            "run_s": run_s, "wall_ms_per_batch": wall_batch_ms,
            "avg_ratio": rep.avg_ratio, "max_ratio": rep.max_ratio,
            "device_only_ms": dev_only_ms,
            "device_only_ratio": dev_only_ms / 1e3 / air_s,
            "device_ms_per_batch": dev_ms,
            "device_launches_per_batch": dev_launches, "idle_share": idle,
            "kernel": kern, "shapes": [list(s.shape[:2]) for s in seen]}



# ---------------------------------------------------------------------------
# 802.11b (phases 17-21): no Viterbi on these paths
# ---------------------------------------------------------------------------


def no_launch(vc, what: str) -> int:
    """The 11b paths reach no Viterbi: raises if the kernel was launched
    in the path just driven; returns the count (0)."""
    if vc.LAUNCHES != 0:
        raise AssertionError(f"{what} launched the kernel {vc.LAUNCHES} "
                             "times, expected 0")
    return 0


B11_ROW_KEYS = ("psdu", "ok", "fcs_ok", "plcp_ok", "length", "signal",
                "length_us", "t0", "preamble", "data_chip0", "rate_mbps")


def b11_check_rows(card: dict, cpu: dict, rows: int, what: str) -> None:
    """The first ``rows`` rows of the card's 11b outputs equal the CPU's,
    every field exactly."""
    for key in cpu:
        if not np.array_equal(cpu[key], card[key][:rows]):
            raise AssertionError(f"{what}: card and CPU disagree on {key}")


def b11_tx_phase(torch, dev, vc) -> dict:
    """Phase 17: the 11b TX on the card against the CPU (rates 1, 2, 5.5,
    11 long; 2, 5.5, 11 short; 16 PSDUs of 1000 bytes each); each card
    waveform decodes through the card's rx_pipeline at its rate and
    through rx_pipeline_auto, with no kernel launch."""
    from sora_tpu_torch.mac.frame import build_data_frame
    from sora_tpu_torch.phy.dot11b import rx as brx
    from sora_tpu_torch.phy.dot11b import tx as btx
    from sora_tpu_torch.util.xfer import fetch

    rng = np.random.default_rng(17)
    arr = np.stack([np.frombuffer(build_data_frame(bytes(rng.integers(
        0, 256, B11_PSDU - 28, dtype=np.uint8)), seq=i), np.uint8)
        for i in range(B11_TX_ROWS)])
    rows = torch.from_numpy(arr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    worst, classes = 0.0, 0
    for preamble, rates in (("long", (1, 2, 5.5, 11)),
                            ("short", (2, 5.5, 11))):
        for rate in rates:
            w = btx.modulate(rows.to(dev), rate, B11_PSDU, preamble=preamble)
            err = float((w.cpu() - btx.modulate(rows, rate, B11_PSDU,
                                                preamble=preamble)).abs()
                        .max())
            worst = max(worst, err)
            if err > TX_ATOL:
                raise AssertionError(f"11b TX {rate} Mbps {preamble}: card "
                                     f"and CPU differ by {err}")
            x = torch.zeros(w.shape[0], w.shape[1] + 200,
                            dtype=torch.complex64, device=dev)
            x[:, 60: 60 + w.shape[1]] = w
            x += torch.randn(x.shape, dtype=torch.complex64, device=dev,
                             generator=gen) * 0.02
            vc.LAUNCHES = 0
            outs = [fetch(brx.rx_pipeline(x, rate, max_psdu=B11_MAX_PSDU)),
                    fetch(brx.rx_pipeline_auto(x, max_psdu=B11_MAX_PSDU))]
            no_launch(vc, f"11b {rate} Mbps {preamble} decodes")
            for out in outs:
                if not (out["ok"].all()
                        and (out["psdu"][:, :B11_PSDU] == arr).all()
                        and (out["preamble"] == (preamble == "short")).all()):
                    raise AssertionError(f"the card's 11b {rate} Mbps "
                                         f"{preamble} waveforms do not decode")
            classes += 1
    print(f"btx.modulate, 1/2/5.5/11 Mbps long and 2/5.5/11 Mbps short x "
          f"{B11_TX_ROWS} PSDUs of {B11_PSDU} bytes: card and CPU agree "
          f"within {worst:.2e} (tolerance {TX_ATOL:g}); the card's waveforms "
          f"decode through rx_pipeline at their rate and rx_pipeline_auto: "
          f"ok {B11_TX_ROWS}/{B11_TX_ROWS} in each of {2 * classes} calls, "
          "kernel launches 0", flush=True)
    return {"max_abs_err": worst, "launches": 0}


def b11_batch_phase(torch, dev, vc) -> dict:
    """Phase 18: bench.py's 11b row on the card (the inputs of
    tools/bench.py): rx_pipeline_auto and rx_pipeline at 128/128 with the
    first rows equal to the CPU run, the short-preamble batch, timings,
    stages and the device's share; 0 kernel launches."""
    from sora_tpu_torch.mac.frame import check_fcs
    from sora_tpu_torch.phy.dot11b import rx as brx
    from sora_tpu_torch.tools.bench import b11_batch, median_ms
    from sora_tpu_torch.util.xfer import device_complex, fetch

    x, psdu = b11_batch(dev)
    B, N = x.shape
    xd = device_complex(x, dev)
    want = np.frombuffer(psdu, np.uint8)
    run = lambda: brx.rx_pipeline_auto(xd, max_psdu=B11_MAX_PSDU)
    run()                                        # first-use tables
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    host = fetch(run())
    launches = no_launch(vc, "rx_pipeline_auto 11b")
    n_ok = int(host["ok"].sum())
    print(f"rx_pipeline_auto 11b {B}x{N}: ok {n_ok}/{B}, kernel launches "
          f"{launches}", flush=True)
    if (n_ok != B or not (host["rate_mbps"] == 11).all()
            or not (host["psdu"][:, :B11_PSDU] == want).all()
            or not check_fcs(psdu)):
        raise AssertionError("the 11b batch did not decode")
    cpu = fetch(brx.rx_pipeline_auto(torch.from_numpy(x[:B11_CPU_ROWS]),
                                     max_psdu=B11_MAX_PSDU))
    b11_check_rows(host, cpu, B11_CPU_ROWS, "11b batch")
    print(f"card and CPU agree on the first {B11_CPU_ROWS} rows (every "
          "field)", flush=True)

    vc.LAUNCHES = 0
    fixed = fetch(brx.rx_pipeline(xd, 11, max_psdu=B11_MAX_PSDU))
    xs, _ = b11_batch(dev, preamble="short")
    short = fetch(brx.rx_pipeline_auto(device_complex(xs, dev),
                                       max_psdu=B11_MAX_PSDU))
    no_launch(vc, "rx_pipeline 11b, short preamble")
    print(f"rx_pipeline(x, 11) 11b {B}x{N}: ok {int(fixed['ok'].sum())}/{B}; "
          f"short preamble {B}x{xs.shape[1]}: ok {int(short['ok'].sum())}/{B}"
          f" with preamble {int(short['preamble'].min())}", flush=True)
    if (int(fixed["ok"].sum()) != B or int(short["ok"].sum()) != B
            or not (short["preamble"] == 1).all()
            or not (short["psdu"][:, :B11_PSDU] == want).all()):
        raise AssertionError("the fixed-rate or short-preamble 11b batch "
                             "did not decode")

    ms, windows = median_ms(run)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        fetch(run()["ok"])
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = (float(v) for v in np.percentile(lat, [50, 90]))
    msps = B * N / ms / 1e3
    mbps = B * B11_PSDU * 8 / ms / 1e3
    c = brx.barker_correlate(xd)
    corr, t0, _ = brx.synchronize_from_corr(xd, c)
    bits = brx._dbpsk_bits(corr)
    desc = brx._descramble(bits)
    plcp = brx._parse_plcp_both(corr, bits, desc)
    dc0 = t0 + 11 * plcp["data_sym0"]
    max_bits = 8 * B11_MAX_PSDU
    raw = brx._decode_data(xd, c, dc0, max_bits, 11)
    nbytes = torch.full((B,), B11_PSDU, dtype=torch.int32, device=dev)
    stage_ms = {
        "barker_correlate": cuda_ms(lambda: brx.barker_correlate(xd), 20),
        "synchronize": cuda_ms(lambda: brx.synchronize_from_corr(xd, c), 20),
        "parse_plcp_both": cuda_ms(
            lambda: brx._parse_plcp_both(corr, bits, desc), 20),
        **{f"decode_{r}": cuda_ms(lambda r=r: brx._decode_data(
            xd, c, dc0, max_bits, r), 20) for r in brx.RATES},
        "frame_tail": cuda_ms(lambda: brx._frame_tail(
            raw, plcp["prev7"], nbytes, B11_MAX_PSDU), 20),
    }
    dev_ms, dev_launches, top = profile_device(run, 5)
    idle = None if dev_ms is None else 1.0 - dev_ms / ms
    print(f"rx_pipeline_auto 11b: {ms:.3f} ms/batch (events, median of 5 "
          f"windows of 20; range {windows[0]:.3f}-{windows[-1]:.3f}); "
          f"{msps:.1f} Msamples/s at 11 Msps (b11_msps), {mbps:.1f} Mbps "
          f"decoded; latency with fetch p50 {p50:.3f} ms, p90 {p90:.3f} ms "
          "(50 batches)", flush=True)
    print("stages ms: " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in stage_ms.items()), flush=True)
    if dev_ms is None:
        print("device time: not measured (the profiler saw no device "
              "events)", flush=True)
    else:
        print(f"device time: kernels {dev_ms:.3f} ms of {ms:.3f} ms per "
              f"batch (idle share {idle:.3f}), {dev_launches:.0f} device "
              "launches per batch; top:", flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)
    return {"batch": [B, N], "ms": ms, "windows_ms": windows,
            "b11_msps": msps, "decoded_mbps": mbps, "latency_p50_ms": p50,
            "latency_p90_ms": p90, "stage_ms": stage_ms, "device_ms": dev_ms,
            "idle_share": idle, "device_launches": dev_launches,
            "short_batch": list(xs.shape), "launches": launches, "x": xd}


def b11_frontend_phase(torch, dev, vc) -> int:
    """Phase 19: the 11b row pulse shaped to 44 Msps (and resampled to 40)
    through the chip front end and rx_pipeline_auto: 128/128 each, the
    first 4 rows equal to the CPU run."""
    from sora_tpu_torch.phy import frontend as fe
    from sora_tpu_torch.phy.dot11b import rx as brx
    from sora_tpu_torch.tools.bench import b11_batch
    from sora_tpu_torch.util.xfer import device_complex, fetch

    x, psdu = b11_batch(dev)
    want = np.frombuffer(psdu, np.uint8)
    x44 = fe.pulse_shape_11b(device_complex(x, dev))
    x40 = fe.resample(x44, 10, 11)
    for name, xr, front in (("44m", x44, fe.chip_frontend_44m),
                            ("40m", x40, fe.chip_frontend_40m)):
        decode = lambda v: brx.rx_pipeline_auto(front(v),
                                                max_psdu=B11_MAX_PSDU)
        torch.cuda.synchronize()
        vc.LAUNCHES = 0
        host = fetch(decode(xr))
        no_launch(vc, f"11b {name} front end")
        n_ok = int(host["ok"].sum())
        print(f"chip_frontend_{name} + rx_pipeline_auto 11b "
              f"{xr.shape[0]}x{xr.shape[1]}: ok {n_ok}/{xr.shape[0]}, kernel "
              "launches 0", flush=True)
        if n_ok != xr.shape[0] or not (host["psdu"][:, :B11_PSDU]
                                       == want).all():
            raise AssertionError(f"the 11b {name} batch did not decode")
        cpu = fetch(decode(xr[:4].cpu()))
        b11_check_rows(host, cpu, 4, f"11b {name}")
        print(f"card and CPU agree on the first 4 rows at {name}", flush=True)
    return 0


def b11_soak_phase(torch, vc, card) -> dict:
    """Phase 20: the 11b soak air (tools/realtime_soak.py --phy b): one
    round under set_sync_debug_mode("error"), its device time, then
    ``run_rx_soak(phy="b")`` with every frame position-matched and no
    kernel launch."""
    from sora_tpu_torch.tools import realtime_soak as soak
    from sora_tpu_torch.util.xfer import fetch

    air, _, span = soak.make_rx_soak_air(phy="b")
    period = span + soak.SOAK_GAP["b"]
    tx = [(int((off // period) % 64), int(off), 1.0)
          for off in range(1000, air.advance, period)]
    for _ in range(2):
        outs, _ = air.step(tx)
    fetch(outs[0]["ok"])
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, _ = air.step(tx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    no_launch(vc, "one 11b soak round")
    out = fetch(outs[0])
    print(f"11b soak round ({air.batch}x{air.window} chips, hop {air.hop}): "
          f"no host sync inside DeviceAir.step (set_sync_debug_mode('error'))"
          f"; {int(out['ok'].sum())} ok rows of {len(out['ok'])} for "
          f"{len(tx)} frames sent", flush=True)
    dev_ms, dev_launches, top = profile_device(lambda: air.step(tx), 3)

    log = lambda *a: print("  11b soak:", *a, flush=True)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    res = soak.run_rx_soak(B11_SOAK_SECONDS, SOAK_DEPTH, log, phy="b")
    torch.cuda.synchronize()
    launches = no_launch(vc, "the 11b soak")
    n_rounds = res["rounds"] + res["warm_rounds"]
    wall_round_ms = res["wall_seconds"] * 1e3 / res["rounds"]
    idle = None if dev_ms is None else 1.0 - dev_ms / wall_round_ms
    print(f"11b soak: {res['air_seconds']} s of 11 Msps air in "
          f"{res['wall_seconds']} s wall, real-time ratio {res['ratio']}; "
          f"{res['msps']} Msamples/s, {res['decoded_mbps']} Mbps decoded; "
          f"frames delivered {res['frames_delivered']}/"
          f"{res['frames_scheduled']}; kernel launches {launches} in "
          f"{n_rounds} rounds", flush=True)
    if dev_ms is None:
        print("11b soak round device time: not measured (the profiler saw no "
              "device events)", flush=True)
    else:
        print(f"11b soak round device time: {dev_ms:.3f} ms of "
              f"{wall_round_ms:.3f} ms wall per round in the soak (idle share "
              f"{idle:.3f}), {dev_launches:.0f} device launches per round; "
              "top:", flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)
    print(card, flush=True)
    return {"result": res, "launches": launches,
            "round": {"device_ms": dev_ms, "wall_ms": wall_round_ms,
                      "idle_share": idle, "device_launches": dev_launches}}


def b11_node_phase(torch, dev, vc, card) -> dict:
    """Phase 21: the 11b node at the configuration of ``apps/node.py --phy
    b --synthetic 400 --mixed --batch 64`` (the gap at the node's hop: the
    DSSS receiver locks on the first burst of each window): one batch card
    against CPU, two steps without an implicit host sync, the 400
    mixed-rate frames written once and decoded until idle, and the
    device-only ratio."""
    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.mac.frame import build_ack_frame
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink
    from sora_tpu_torch.util.xfer import I16_SCALE, device_quantized, fetch

    cfg = NodeConfig(addr=NODE_ADDR, **B11_NODE_CFG)
    hop = cfg.window - cfg.overlap
    nsamp = cfg.window + hop * (cfg.batch - 1)
    air_s = nsamp / cfg.sample_rate_sps
    ring = RxRing(capacity=B11_NODE_RING)
    node = StreamingNode(ring, cfg, tx_sink=TxSink(), device=dev)
    t0 = time.perf_counter()
    node.warm_up()
    warm_s = time.perf_counter() - t0
    src = synthetic_traffic(B11_NODE_FRAMES, NODE_ADDR, mixed=True, rate=2,
                            gap=hop, phy="b", device=dev)
    print(f"11b node: window {cfg.window} overlap {cfg.overlap} hop {hop} "
          f"batch {cfg.batch}, ring of {B11_NODE_RING}, {nsamp} chips = "
          f"{air_s * 1e3:.2f} ms of air per batch, wire {cfg.wire}; warm-up "
          f"{warm_s:.2f} s; traffic {len(src)} chips ({B11_NODE_FRAMES} "
          f"frames of 88 bytes at 1/2/5.5/11 Mbps, gap {hop})", flush=True)

    # ---- one batch, card against CPU ----------------------------------------
    feed = RxRing(capacity=B11_NODE_RING)
    vs = feed.alloc_vstream()
    feed.write(_windows(node, src, 1))
    h, _ = feed.read_windows(vs, cfg.window, hop, cfg.batch, I16_SCALE,
                             np.int16)
    feed.close()
    xd = device_quantized(h, dev)
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    out = fetch(node._decode(xd))
    no_launch(vc, "one 11b node batch")
    cpu = fetch(node._decode(device_quantized(h[:B11_CPU_ROWS], "cpu")))
    b11_check_rows(out, cpu, B11_CPU_ROWS, "11b node batch")
    n_ok = int(out["ok"].sum())
    if n_ok == 0:
        raise AssertionError("the 11b node batch decoded nothing")
    print(f"11b node batch {cfg.batch}x{cfg.window} (i16 wire): {n_ok} ok "
          f"rows of {cfg.batch}, kernel launches 0; card and CPU agree on "
          f"every field of the first {B11_CPU_ROWS} windows", flush=True)

    # ---- two steps without an implicit host sync ----------------------------
    ring.write(_windows(node, src, 3))
    node.step()
    node.cache.get(build_ack_frame(b"\x02PEER0"), cfg.ack_rate)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        node.step()
        node.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    node.flush()
    ring.close()
    if node.stats.decoded_batches < 3 or node.stats.frame_ok == 0:
        raise AssertionError("the checked 11b steps did not decode:\n"
                             + node.report())
    print("11b node step: no implicit host sync while it assembles, uploads "
          "and issues detect and decode (set_sync_debug_mode('error'), 2 "
          f"steps); {node.stats.frame_ok} frames in "
          f"{node.stats.decoded_batches} batches", flush=True)

    # ---- the 400 frames, written once, decoded until idle -------------------
    ring = RxRing(capacity=B11_NODE_RING)
    node = StreamingNode(ring, cfg, tx_sink=TxSink(), device=dev)
    node.warm_up()
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    t0 = time.perf_counter()
    ring.write(src)
    idle = 0
    while idle < 3:
        idle = 0 if node.step() else idle + 1
    node.flush()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ring.close()
    launches = no_launch(vc, "the 11b node run")
    st, rep = node.stats, node.sw.report()
    batches = st.decoded_batches
    wall_batch_ms = run_s * 1e3 / max(1, batches)
    print(f"11b node run ({B11_NODE_FRAMES} frames written once, stepped to "
          f"idle): frame_ok {st.frame_ok}, crc_fail {st.crc_fail}, plcp_fail "
          f"{st.plcp_fail}, dup {st.dup}, cs_timeout {st.cs_timeout}, acks "
          f"{st.acks_tx}; decoded batches {batches}, kernel launches "
          f"{launches}; {run_s:.2f} s wall, {wall_batch_ms:.2f} ms per batch "
          f"of {air_s * 1e3:.2f} ms air, MacStopwatch avg ratio "
          f"{rep.avg_ratio:.4f} (max {rep.max_ratio:.4f}; not gated)",
          flush=True)
    if (st.frame_ok < 0.98 * B11_NODE_FRAMES
            or st.crc_fail > 0.02 * B11_NODE_FRAMES or st.acks_tx == 0):
        raise AssertionError("11b node run failed:\n" + node.report())

    issue = lambda: (node._detect(xd), node._decode(xd))
    issue()
    dev_only_ms = cuda_ms(issue, 20)
    dev_ms, dev_launches, top = profile_device(issue, 3)
    idle = None if dev_ms is None else 1.0 - dev_ms / wall_batch_ms
    print(f"11b node device-only: {dev_only_ms:.3f} ms detect+decode per "
          f"batch (events, 20 calls) over {air_s * 1e3:.2f} ms of air: ratio "
          f"{dev_only_ms / 1e3 / air_s:.4f}", flush=True)
    if dev_ms is None:
        print("11b node batch device time: not measured (the profiler saw "
              "no device events)", flush=True)
    else:
        print(f"11b node batch device time: {dev_ms:.3f} ms per "
              f"detect+decode ({dev_launches:.0f} device launches); idle "
              f"share of the run {idle:.4f}; top:", flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms {n:6.0f}x  {name[:90]}", flush=True)
    print(card, flush=True)
    return {"config": {"window": cfg.window, "overlap": cfg.overlap,
                       "hop": hop, "batch": cfg.batch,
                       "air_ms_per_batch": air_s * 1e3},
            "warm_s": warm_s, "frames": st.frame_ok,
            "crc_fail": st.crc_fail, "plcp_fail": st.plcp_fail,
            "dup": st.dup, "acks_tx": st.acks_tx, "decoded_batches": batches,
            "launches": launches, "run_s": run_s,
            "wall_ms_per_batch": wall_batch_ms, "avg_ratio": rep.avg_ratio,
            "max_ratio": rep.max_ratio, "device_only_ms": dev_only_ms,
            "device_only_ratio": dev_only_ms / 1e3 / air_s,
            "device_ms_per_batch": dev_ms,
            "device_launches_per_batch": dev_launches, "idle_share": idle}



# ---------------------------------------------------------------------------
# sharding and the apps (phases 22-25)
# ---------------------------------------------------------------------------

# sharded against unsharded on the same card input (the JAX package's
# sharding tolerances, tests/test_sharding.py:46-47, 139-142)
SHARD_ATOL = {"cfo": 1e-6, "det": 1e-4, "snr_db": 1e-3}
A_KEYS = ("psdu", "ok", "fcs_ok", "length")
A_AUTO_KEYS = A_KEYS + ("sig_ok", "cs_ok", "rate_mbps")
N_KEYS = ("ok", "fcs_ok", "cs_ok", "mcs", "length")
TVWS_ARGS = ("--synthetic", "8", "--channels=-10e6,10e6")


def shard_path(torch, vc, name: str, sharded, plain, sync, want: int,
               keys, full_psdu: bool = True) -> dict:
    """One sharded receiver against the unsharded one on the same input:
    ok on every row, ``want`` kernel launches, the exact fields equal
    (the PSDU bytes in full, or within each row's length where the two
    decode different trellis lengths), lts1 from the sharded sync equal,
    cfo / det / snr within SHARD_ATOL, and both timed (interleaved
    windows) and profiled."""
    from sora_tpu_torch.tools.scaling_bench import tax_ms
    from sora_tpu_torch.util.xfer import fetch

    sharded()                                   # first-use tables
    torch.cuda.synchronize()
    vc.LAUNCHES = 0
    with viterbi_inputs() as seen:
        out = sharded()
        torch.cuda.synchronize()
    launches = vc.LAUNCHES
    if launches != want:
        raise AssertionError(f"{name} launched the kernel {launches} times, "
                             f"expected {want}")
    got, ref = fetch(out), fetch(plain())
    B = len(got["ok"])
    n_ok = int(got["ok"].sum())
    if n_ok != B:
        raise AssertionError(f"{name}: ok {n_ok}/{B}")
    for k in keys:
        if k == "psdu" and not full_psdu:
            bad = any(not np.array_equal(got["psdu"][i, :n],
                                         ref["psdu"][i, :n])
                      for i, n in enumerate(ref["length"]))
        else:
            bad = not np.array_equal(got[k], ref[k])
        if bad:
            raise AssertionError(f"{name}: sharded and unsharded disagree "
                                 f"on {k}")
    diffs = {}
    if sync is not None:
        l1, cfo, det = fetch(sync[0]())
        u1, ucfo, udet = fetch(sync[1]())
        if not np.array_equal(l1, u1):
            raise AssertionError(f"{name}: the sharded sync's lts1 differs")
        diffs.update(cfo=float(np.abs(cfo - ucfo).max()),
                     det=float(np.abs(det - udet).max()))
    for k in ("det", "snr_db"):
        if k in got and k in ref:
            diffs[k] = max(diffs.get(k, 0.0),
                           float(np.abs(got[k] - ref[k]).max()))
    for k, v in diffs.items():
        if not v <= SHARD_ATOL[k]:
            raise AssertionError(f"{name}: {k} differs by {v}")
    ms_plain, ms_shard = tax_ms(plain, sharded)
    dev = {k: profile_device(fn, 3)[:2] for k, fn in (("plain", plain),
                                                      ("sharded", sharded))}
    print(f"{name}: ok {n_ok}/{B}, kernel launches {launches}; "
          f"{', '.join(keys)}{' (within length)' if not full_psdu else ''}"
          f"{', lts1' if sync else ''} equal to the unsharded pipeline; "
          + "".join(f"{k} within {v:.2e}; " for k, v in diffs.items())
          + f"sharded {ms_shard:.3f} ms, unsharded {ms_plain:.3f} ms per "
          f"batch (events, median of 5 interleaved windows of 20): "
          f"sharding tax {ms_shard / ms_plain:.3f}; device time / device "
          "launches per call: " + ", ".join(
              f"{k} {'not measured' if v[0] is None else f'{v[0]:.3f} ms'}"
              f" / {v[1]:.0f}" for k, v in dev.items()), flush=True)
    return {"launches": launches, "ms": ms_shard, "plain_ms": ms_plain,
            "tax": ms_shard / ms_plain, "diffs": diffs,
            "device_ms": {k: v[0] for k, v in dev.items()},
            "device_launches": {k: v[1] for k, v in dev.items()},
            "soft": seen}


def collective_ms(torch, mesh, dev) -> dict:
    """Event time of each size-1 NCCL collective the sharded receivers
    issue, at their shapes on the (1, 1) mesh (100 calls each)."""
    import torch.distributed as tdist

    sp = mesh.get_group("sp")
    v = torch.ones(BATCH, device=dev)
    i = torch.ones(BATCH, dtype=torch.int64, device=dev)
    gi = torch.empty_like(i)
    xb = torch.ones(BATCH, 5452, dtype=torch.complex64, device=dev)
    xo = torch.empty_like(xb)
    return {
        "all_reduce (128,) f32": cuda_ms(
            lambda: tdist.all_reduce(v, group=sp), 100),
        "all_gather (128,) i64": cuda_ms(
            lambda: tdist.all_gather_into_tensor(gi, i, group=sp), 100),
        "all_to_all_single 128x5452 c64": cuda_ms(
            lambda: tdist.all_to_all_single(torch.view_as_real(xo),
                                            torch.view_as_real(xb),
                                            group=sp), 100)}


def sharded_phase(torch, dev, vc, parity, xs: dict) -> dict:
    """Phase 22: the sharded receivers on a (1, 1) NCCL mesh of the card
    at bench.py's widths, on the inputs the earlier phases built, each
    against its unsharded pipeline; the kernel against its plain version
    on the sharded 11a call's own Viterbi input; the size-1 collectives'
    cost."""
    from sora_tpu_torch.parallel import shard as psh
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.phy.dot11b import rx as brx
    from sora_tpu_torch.phy.dot11n import rx as nrx

    t0 = time.perf_counter()
    mesh = psh.make_mesh(1)
    world = torch.distributed.get_world_size()
    backend = torch.distributed.get_backend()
    print(f"make_mesh(1): {tuple(mesh.mesh.shape)} mesh over a world of "
          f"{world} ({backend}) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    x, xa, x40, x15, xn, xb = (xs[k] for k in ("a", "auto", "40m", "n15",
                                               "nauto", "b"))
    sync_a = lambda v: (lambda: psh.synchronize_sharded(v, mesh),
                        lambda: arx.synchronize(v))
    sync_n = lambda v: (lambda: psh.synchronize_sharded_11n(v, mesh),
                        lambda: nrx.synchronize(v))
    res = {}
    res["rx_pipeline_sharded"] = shard_path(
        torch, vc, f"rx_pipeline_sharded(x, mesh, 54, max_psdu=1504) "
        f"{tuple(x.shape)}",
        lambda: psh.rx_pipeline_sharded(x, mesh, RATE, max_psdu=MAX_PSDU),
        lambda: arx.rx_pipeline(x, RATE, max_psdu=MAX_PSDU), sync_a(x), 1,
        A_KEYS)
    ab = res["rx_pipeline_sharded"]["soft"][0]
    parity("sharded rx_pipeline soft", ab, *auto_window(ab.shape[1]), True)
    res["rx_pipeline_sharded_auto"] = shard_path(
        torch, vc, f"rx_pipeline_sharded_auto {tuple(xa.shape)}",
        lambda: psh.rx_pipeline_sharded_auto(xa, mesh, max_psdu=MAX_PSDU),
        lambda: arx.rx_pipeline_auto(xa, max_psdu=MAX_PSDU), sync_a(xa), 1,
        A_AUTO_KEYS)
    res["rx_pipeline_sharded_auto 40m"] = shard_path(
        torch, vc, f"rx_pipeline_sharded_auto(input_rate='40m') raw 40 Msps "
        f"{tuple(x40.shape)}",
        lambda: psh.rx_pipeline_sharded_auto(x40, mesh, max_psdu=MAX_PSDU,
                                             input_rate="40m"),
        lambda: arx.rx_pipeline_auto(x40, max_psdu=MAX_PSDU,
                                     input_rate="40m"), None, 1, A_AUTO_KEYS)
    res["rx_pipeline_sharded_11n MCS 15"] = shard_path(
        torch, vc, f"rx_pipeline_sharded_11n MCS 15 {tuple(x15.shape)}",
        lambda: psh.rx_pipeline_sharded_11n(x15, mesh, 15,
                                            max_psdu=MAX_PSDU),
        lambda: nrx.rx_pipeline(x15, 15, max_psdu=MAX_PSDU), sync_n(x15), 2,
        ("psdu",) + N_KEYS)
    res["rx_pipeline_sharded_11n_auto"] = shard_path(
        torch, vc, f"rx_pipeline_sharded_11n_auto MCS 8-15 "
        f"{tuple(xn.shape)}",
        lambda: psh.rx_pipeline_sharded_11n_auto(xn, mesh, max_psdu=MAX_PSDU),
        lambda: nrx.rx_pipeline_auto(xn, max_psdu=MAX_PSDU), sync_n(xn), 2,
        ("psdu", "sig_ok") + N_KEYS, full_psdu=False)
    res["rx_pipeline_sharded_11b"] = shard_path(
        torch, vc, f"rx_pipeline_sharded_11b {tuple(xb.shape)}",
        lambda: psh.rx_pipeline_sharded_11b(xb, mesh, max_psdu=B11_MAX_PSDU),
        lambda: brx.rx_pipeline_auto(xb, max_psdu=B11_MAX_PSDU), None, 0,
        B11_ROW_KEYS)
    for r in res.values():
        r.pop("soft")
    coll = collective_ms(torch, mesh, dev)
    # per call: 11a / 11n sync 5 all_reduce + 2 all_gather, then one
    # all_to_all (two with the 40 Msps front end; the 11b path reshards
    # the chips and the correlation: two)
    counts = {"rx_pipeline_sharded": (5, 2, 1),
              "rx_pipeline_sharded_auto": (5, 2, 1),
              "rx_pipeline_sharded_auto 40m": (5, 2, 2),
              "rx_pipeline_sharded_11n MCS 15": (5, 2, 1),
              "rx_pipeline_sharded_11n_auto": (5, 2, 1),
              "rx_pipeline_sharded_11b": (0, 0, 2)}
    per = list(coll.values())
    for name, n in counts.items():
        res[name]["collectives"] = list(n)
        res[name]["collective_ms"] = sum(a * b for a, b in zip(n, per))
    print("size-1 NCCL collectives (events, 100 calls): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in coll.items()) + "; per call: "
        + ", ".join(f"{k} {res[k]['collective_ms']:.3f} ms"
                    for k in counts), flush=True)
    return {"mesh": list(mesh.mesh.shape), "paths": res,
            "collectives_ms": coll}


def capture_stdout(fn):
    """(fn's return value, its standard output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue()


def tvws_phase(torch, dev, vc) -> dict:
    """Phase 23: ``apps.tvws`` at its CLI defaults on the card (8 frames
    over two 20 MHz channels of a 40 Msps band): exit 0, 8/8 frames, one
    kernel launch per ``decode_band``; then ``decode_band`` on the card
    and on the CPU, frame for frame."""
    from sora_tpu_torch.apps import tvws

    calls = []
    orig = tvws.decode_band

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tvws.decode_band = counted
    try:
        vc.LAUNCHES = 0
        rc, out = capture_stdout(lambda: tvws.main(list(TVWS_ARGS)))
        launches = vc.LAUNCHES
    finally:
        tvws.decode_band = orig
    last = out.strip().splitlines()[-1]
    print(f"apps.tvws {' '.join(TVWS_ARGS)}: rc {rc}, '{last}', kernel "
          f"launches {launches} in {len(calls)} decode_band calls",
          flush=True)
    if rc != 0 or "decoded 8/8" not in last or launches != len(calls):
        raise AssertionError("apps.tvws failed")
    offs = [-10e6, 10e6]
    x, _ = tvws.synth_band(8, offs, 40e6)
    card = tvws.decode_band(x, offs, 40e6)
    cpu = tvws.decode_band(x, offs, 40e6, device="cpu")
    if len(card) != 8 or [{k: f[k] for k in f if k != "snr_db"}
                          for f in card] != [{k: f[k] for k in f
                                              if k != "snr_db"}
                                             for f in cpu]:
        raise AssertionError("tvws: card and CPU frames differ")
    snr = max(abs(a["snr_db"] - b["snr_db"]) for a, b in zip(card, cpu))
    if snr > 0.05:
        raise AssertionError(f"tvws: snr differs by {snr}")
    print(f"tvws decode_band: card and CPU agree on all {len(card)} frames "
          f"(channel, rate, length, psdu; snr within {snr:.1e} dB)",
          flush=True)
    return {"rc": rc, "frames": len(card), "launches": launches,
            "decode_band_calls": len(calls)}


def sniffer_phase(torch, vc) -> dict:
    """Phase 24: ``apps.sniffer`` in-process on the card: 32 mixed-rate
    synthetic frames to a pcap that reads back equal to the logged frames,
    then the 40 Msps capture replayed for 3 s."""
    import tempfile

    from sora_tpu_torch.apps import sniffer as sn

    made = []

    class Spy(sn.Sniffer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    orig = sn.Sniffer
    sn.Sniffer = Spy
    res = {}
    try:
        with tempfile.TemporaryDirectory() as d:
            pcap = str(Path(d) / "sniff.pcap")
            vc.LAUNCHES = 0
            rc, _ = capture_stdout(lambda: sn.main(
                ["--synthetic", "32", "--mixed", "--pcap", pcap]))
            frames = [m["psdu"] for m in made[-1].frames]
            back = [f for _, f in sn.read_pcap(pcap)]
            # one launch for the warm-up, then one per decoded batch
            batches = made[-1].node.stats.decoded_batches
            launches = launched(vc, "apps.sniffer --synthetic",
                                1 + batches)
            res["synthetic"] = {"rc": rc, "frames": len(frames),
                                "launches": launches}
            print(f"apps.sniffer --synthetic 32 --mixed --pcap: rc {rc}, "
                  f"frames {len(frames)} ({dict(made[-1].hist)}), pcap "
                  f"{len(back)} records equal to the logged frames "
                  f"{back == frames}, kernel launches {launches} (1 "
                  f"warm-up + {batches} decoded batches)", flush=True)
            if rc != 0 or not frames or back != frames:
                raise AssertionError("apps.sniffer synthetic run failed")
        vc.LAUNCHES = 0
        rc, _ = capture_stdout(lambda: sn.main(
            ["--dump", str(CAPTURE), "--seconds", "3"]))
        n = sum(made[-1].hist.values())
        batches = made[-1].node.stats.decoded_batches
        launches = launched(vc, "apps.sniffer --dump", 1 + batches)
        res["dump"] = {"rc": rc, "frames": n, "launches": launches}
        print(f"apps.sniffer --dump {CAPTURE.name} --seconds 3: rc {rc}, "
              f"frames {n}, kernel launches {launches} (1 warm-up + "
              f"{batches} decoded batches)", flush=True)
        if rc != 0 or n == 0:
            raise AssertionError("apps.sniffer dump replay failed")
    finally:
        sn.Sniffer = orig
    return res


def demod11_phase(torch, vc) -> dict:
    """Phase 25: ``apps.demod11`` on the card: mod then demod through the
    torch chain for 11a (54 Mbps), 11b (11 Mbps) and 11n (MCS 15, two
    dumps); the raw 40 Msps capture through the device front end; the ACK
    of the port's TX against the golden model."""
    import tempfile

    from sora_tpu_torch.apps import demod11

    runs = {}
    # the Viterbi decodes one 11a frame in one launch, one 11n frame in
    # two (HT-SIG and data); 11b and the TX-only ACK launch nothing
    want = {"11a round trip": 1, "11b round trip": 0, "11n round trip": 2,
            "raw 40 Msps": 1, "ack 24": 0}
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "w.dmp")
        for std, rate in (("11a", "54"), ("11b", "11"), ("11n", "15")):
            rc_mod, _ = capture_stdout(lambda: demod11.main(
                ["--std", std, "--mode", "mod", "--rate", rate, "--outfile",
                 out]))
            files = [out + ".s0", out + ".s1"] if std == "11n" else [out]
            vc.LAUNCHES = 0
            rc, text = capture_stdout(lambda: demod11.main(
                ["--std", std, "--mode", "demod", "--chain", "torch",
                 "--msps", "20"] + [a for f in files
                                    for a in ("--infile", f)]))
            runs[f"{std} round trip"] = {"rc": rc_mod or rc,
                                         "launches": vc.LAUNCHES,
                                         "line": text.splitlines()[0]}
    vc.LAUNCHES = 0
    rc, text = capture_stdout(lambda: demod11.main(
        ["--mode", "demod", "--chain", "torch", "--infile", str(CAPTURE),
         "--msps", "40"]))
    runs["raw 40 Msps"] = {"rc": rc, "launches": vc.LAUNCHES,
                           "line": text.splitlines()[0]}
    vc.LAUNCHES = 0
    rc, text = capture_stdout(lambda: demod11.main(["--mode", "ack",
                                                    "--rate", "24"]))
    runs["ack 24"] = {"rc": rc, "launches": vc.LAUNCHES,
                      "line": text.strip()}
    for name, r in runs.items():
        print(f"apps.demod11 {name}: rc {r['rc']}, kernel launches "
              f"{r['launches']} (expected {want[name]}): {r['line']}",
              flush=True)
    if any(r["rc"] for r in runs.values()) or \
            not runs["ack 24"]["line"].endswith("-> MATCH"):
        raise AssertionError("apps.demod11 failed")
    bad = {k: r["launches"] for k, r in runs.items()
           if r["launches"] != want[k]}
    if bad:
        raise AssertionError(f"apps.demod11 kernel launches {bad}, "
                             f"expected {want}")
    return runs


# ---------------------------------------------------------------------------
# the SDL layer, the last apps and tools (phases 26-30)
# ---------------------------------------------------------------------------

# sdl.Radio's rings have the fixed capacity of sora_tpu/sdl.py:124; its node
# at the node app's width as phase 11 runs it, 11n as phase 16, 11b as
# phase 21 but at the largest batch whose two spans fit in one ring
RADIO_RING = 1 << 22
RADIO_RX_SECONDS = 120.0  # rx's wall-clock bound: the ring drains long before
RESAMPLE_ATOL = 1e-5      # Signal.resample, card against CPU (unit tone)
SPE_DB_ATOL = 0.01        # welch_spectrum card against CPU, dB, over the
#                           bins above peak - 80 dB (float32 FFTs)
SPE_TONE = ("--tone", "3.2e6", "--msps", "20")
NODE_DUMP_ARGS = ("--dump", str(CAPTURE), "--msps", "40", "--seconds", "3")
# each sweep at the tool's default grid and its Viterbi launches per
# receiver call; the calls themselves are counted as the sweep runs
SWEEPS = (("11a", "sweep_11a", "SNRS_A", 1),
          ("11b", "sweep_11b", "SNRS_B", 0),
          ("11n", "sweep_11n", "SNRS_N", 2),
          ("11a multipath", "sweep_11a_multipath", "SNRS_AM", 1),
          ("11n mixed", "sweep_11n_mixed", "SNRS_NM", 2))
# the receiver entry points the sweeps call, by module of the port
SWEEP_RECEIVERS = (("phy.dot11a.rx", ("rx_pipeline", "decode_data")),
                   ("phy.dot11b.rx", ("rx_pipeline_auto",)),
                   ("phy.dot11n.rx", ("rx_pipeline", "rx_pipeline_1ss")))


def status_count(out: str, key: str) -> int:
    """A counter of the node's status page in ``out``."""
    import re

    return int(re.search(rf"\b{key}\s+(\d+)", out).group(1))


def radio_run(torch, vc, phy: str, src: np.ndarray, what: str, **kw) -> dict:
    """``sdl.Radio(phy)`` on the card: ``src`` injected in one write, then
    ``rx`` until the ring drains; the delivered payloads, the counters,
    the kernel launches of that run, frames/s, and the device-only ratio
    of one batch of ``src`` (detect + decode, CUDA events, over its air)."""
    from sora_tpu_torch.sdl import Radio
    from sora_tpu_torch.util.xfer import device_complex8, device_complex16

    with Radio(phy=phy, **kw) as r:
        node, cfg = r.node, r.node.cfg
        hop = cfg.window - cfg.overlap
        span = cfg.window + hop * (cfg.batch - 1)
        if src.shape[-1] > RADIO_RING:
            raise AssertionError(f"{what}: {src.shape[-1]} samples do not "
                                 "fit one write into the ring")
        torch.cuda.synchronize()
        vc.LAUNCHES = 0
        t0 = time.perf_counter()
        r.inject(src)
        got = list(r.rx(seconds=RADIO_RX_SECONDS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, st = vc.LAUNCHES, r.stats
        wins = np.stack([src[..., i * hop: i * hop + cfg.window]
                         for i in range(cfg.batch)])
        wire = device_complex8 if cfg.wire == "i8" else device_complex16
        xd = wire(wins, node.device)
        issue = lambda: (node._detect(xd), node._decode(xd))
        issue()
        dev_ms = cuda_ms(issue, 10)
    air_s = span / cfg.sample_rate_sps
    res = {"window": cfg.window, "overlap": cfg.overlap, "batch": cfg.batch,
           "wire": cfg.wire, "samples": int(src.shape[-1]),
           "delivered": len(got), "frame_ok": st.frame_ok,
           "crc_fail": st.crc_fail, "plcp_fail": st.plcp_fail,
           "dup": st.dup, "acks_tx": st.acks_tx,
           "decoded_batches": st.decoded_batches, "launches": launches,
           "wall_s": wall, "frames_per_s": len(got) / wall,
           "device_only_ms": dev_ms, "air_ms_per_batch": air_s * 1e3,
           "device_only_ratio": dev_ms / 1e3 / air_s}
    print(f"{what}: window {cfg.window} overlap {cfg.overlap} batch "
          f"{cfg.batch} ({cfg.wire} wire), {res['samples']} samples in one "
          f"write; delivered {len(got)}, frame_ok {st.frame_ok}, crc_fail "
          f"{st.crc_fail}, plcp_fail {st.plcp_fail}, dup {st.dup}, acks "
          f"{st.acks_tx}; decoded batches {st.decoded_batches}, kernel "
          f"launches {launches}; {wall:.2f} s wall, "
          f"{res['frames_per_s']:.0f} frames/s; device-only {dev_ms:.3f} ms "
          f"per batch over {air_s * 1e3:.2f} ms of air: ratio "
          f"{res['device_only_ratio']:.4f}", flush=True)
    return res


def most_frames(make, cycle: int) -> tuple:
    """The most frames of ``make(n)`` traffic that one write into the
    Radio's ring holds, and that traffic.  Mixed traffic cycles over
    ``cycle`` rates whose frames differ in length."""
    one = make(1).shape[-1]
    per = (make(1 + cycle).shape[-1] - one) / cycle
    n = int((RADIO_RING - one) / per) + 1
    src = make(n)
    while src.shape[-1] > RADIO_RING:
        n -= max(1, int((src.shape[-1] - RADIO_RING) / per))
        src = make(n)
    return n, src


def sdl_phase(torch, dev, vc) -> dict:
    """Phase 26: the SDL layer on the card.  ``Signal``: 14- and 16-bit dump
    round trips, ``resample`` 20 -> 40 -> 20 Msps card against CPU,
    ``spectrum`` and ``snr_db`` on a tone.  ``Radio`` phy "a" at the node
    app's width, "n" on two rings, "b" at the largest batch whose two
    spans fit the ring, each fed the most frames of the node app's
    synthetic traffic that one write into the ring holds; ``replay`` of
    the 40 Msps capture."""
    import tempfile

    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.runtime.node import NodeConfig
    from sora_tpu_torch.sdl import RadioConfig, Radio, Signal

    res = {}
    # ---- Signal ------------------------------------------------------------
    rng = np.random.default_rng(26)
    x = ((rng.normal(size=8192) + 1j * rng.normal(size=8192)) * 0.3
         ).astype(np.complex64)
    corr = {}
    with tempfile.TemporaryDirectory() as d:
        for bits in (14, 16):
            path = str(Path(d) / f"sig{bits}.dmp")
            Signal(x, 40e6).to_dump(path, bits=bits)
            back = Signal.from_dump(path, 40e6).samples[: len(x)]
            corr[bits] = float(abs(np.vdot(back, x)) / (
                np.linalg.norm(back) * np.linalg.norm(x)))
    tone = Signal((np.exp(2j * np.pi * 2e6 / 20e6 * np.arange(65536))
                   + 0.003 * (rng.normal(size=65536)
                              + 1j * rng.normal(size=65536))
                   ).astype(np.complex64), 20e6)
    vc.LAUNCHES = 0
    up = tone.resample(40e6)
    down = up.resample(20e6)
    up_h = tone.resample(40e6, device="cpu")
    down_h = up_h.resample(20e6, device="cpu")
    err = max(float(np.abs(up.samples - up_h.samples).max()),
              float(np.abs(down.samples - down_h.samples).max()))
    f, p = up.spectrum(1024)
    peak_hz, snr = float(f[int(np.argmax(p))]), tone.snr_db()
    no_launch(vc, "Signal")
    print(f"Signal: 14/16-bit dump round trips correlate "
          f"{corr[14]:.6f}/{corr[16]:.6f}; resample 20 -> 40 -> 20 Msps "
          f"on the card against the CPU within {err:.2e} (tolerance "
          f"{RESAMPLE_ATOL:g}); spectrum peak {peak_hz / 1e6:+.3f} MHz, "
          f"snr_db {snr:.1f}", flush=True)
    if (min(corr.values()) < 0.9999 or err > RESAMPLE_ATOL
            or len(down) != len(tone) or abs(peak_hz - 2e6) > 1e5
            or snr < 30):
        raise AssertionError("Signal on the card failed")
    res["signal"] = {"dump_corr": corr, "resample_err": err,
                     "peak_hz": peak_hz, "snr_db": snr}

    # ---- Radio phy "a": the node app's width, one write of traffic ------
    n, src = most_frames(lambda k: synthetic_traffic(
        k, NODE_ADDR, mixed=False, rate=24, gap=900, device=dev), 1)
    a = radio_run(torch, vc, "a", src, f"Radio(phy='a') {n} frames",
                  device=dev, addr=NODE_ADDR, **NODE_CFG)
    if a["launches"] != a["decoded_batches"] or not a["launches"]:
        raise AssertionError("Radio(phy='a'): launches != decoded batches")
    # frame_ok counts every FCS-clean frame, the ACKs that the loopback
    # sink writes back into the ring among them, so the gate reads the data
    # frames delivered.  The node decodes at most K candidates a window and
    # advances a hop a window, so it can deliver at most K frames a hop:
    # K * period / hop of this traffic (the JAX Radio loses the same frames
    # where K binds: tests/test_torch_sdl.py)
    K = NODE_CFG["max_frames_per_window"]
    hop = a["window"] - a["overlap"]
    cap = min(1.0, K * src.shape[-1] / n / hop)
    print(f"Radio(phy='a'): delivered {a['delivered']} of {n} data frames "
          f"({a['delivered'] / n:.4f}); at most K = {K} frames a hop of "
          f"{hop} samples, a frame every {src.shape[-1] / n:.1f}: "
          f"{cap:.4f} of them", flush=True)
    if a["crc_fail"] > 0.02 * n or a["delivered"] < 0.98 * cap * n:
        raise AssertionError(f"Radio(phy='a'): frame_ok {a['frame_ok']}, "
                             f"delivered {a['delivered']}, crc_fail "
                             f"{a['crc_fail']} of {n} frames")
    a["k_cap"] = cap
    res["a"] = dict(a, frames=n)

    # ---- Radio phy "n": two rings ------------------------------------------
    hcfg = NodeConfig(addr=NODE_ADDR, **HT_NODE_CFG)
    hop = hcfg.window - hcfg.overlap
    n, src = most_frames(lambda k: synthetic_traffic(
        k, NODE_ADDR, mixed=True, rate=8, gap=hop, phy="n", device=dev), 8)
    nn = radio_run(torch, vc, "n", src, f"Radio(phy='n') {n} frames",
                   device=dev, addr=NODE_ADDR, **{
                       k: v for k, v in HT_NODE_CFG.items() if k != "phy"})
    if nn["launches"] != 4 * nn["decoded_batches"] or not nn["launches"]:
        raise AssertionError("Radio(phy='n'): launches != 4 per batch")
    if nn["delivered"] < 0.98 * n:
        raise AssertionError(f"Radio(phy='n') decoded {nn['delivered']} of "
                             f"{n} frames")
    res["n"] = dict(nn, frames=n)

    # ---- Radio phy "b": the largest batch whose two spans fit -----------
    bkw = {k: v for k, v in B11_NODE_CFG.items()
           if k not in ("phy", "sample_rate_sps")}
    bcfg = NodeConfig(addr=NODE_ADDR, **B11_NODE_CFG)
    hop = bcfg.window - bcfg.overlap
    batch = min(bcfg.batch, (RADIO_RING // 2 - bcfg.window) // hop + 1)
    print(f"Radio(phy='b'): batch {batch} (the app's {bcfg.batch} spans "
          f"{bcfg.window + hop * (bcfg.batch - 1)} chips; two spans of "
          f"{batch} fit the ring of {RADIO_RING})", flush=True)
    bkw["batch"] = batch
    n, src = most_frames(lambda k: synthetic_traffic(
        k, NODE_ADDR, mixed=True, rate=2, gap=hop, phy="b", device=dev), 4)
    b = radio_run(torch, vc, "b", src, f"Radio(phy='b') {n} frames",
                  device=dev, addr=NODE_ADDR,
                  radio=RadioConfig(sample_rate=11e6), **bkw)
    if b["launches"]:
        raise AssertionError("Radio(phy='b') launched the kernel")
    if b["delivered"] < 0.98 * n:
        raise AssertionError(f"Radio(phy='b') decoded {b['delivered']} of "
                             f"{n} frames")
    res["b"] = dict(b, frames=n, app_batch=bcfg.batch)

    # ---- Radio.replay of the 40 Msps capture, in the wire's units -------
    with Radio(phy="a", device=dev, radio=RadioConfig(sample_rate=40e6),
               input_rate="40m", max_psdu=1600, min_rate_mbps=6,
               batch=4) as r:
        torch.cuda.synchronize()
        vc.LAUNCHES = 0
        r.replay(str(CAPTURE))
        got = list(r.rx(seconds=RADIO_RX_SECONDS))
        torch.cuda.synchronize()
        st = r.stats
        launches = launched(vc, "Radio.replay", st.decoded_batches)
    print(f"Radio.replay({CAPTURE.name}, paced at 40 Msps): delivered "
          f"{len(got)}, frame_ok {st.frame_ok}, crc_fail {st.crc_fail}; "
          f"decoded batches {st.decoded_batches}, kernel launches "
          f"{launches}", flush=True)
    if st.frame_ok == 0 or st.crc_fail:
        raise AssertionError("Radio.replay of the capture failed")
    res["replay"] = {"delivered": len(got), "frame_ok": st.frame_ok,
                     "crc_fail": st.crc_fail,
                     "decoded_batches": st.decoded_batches,
                     "launches": launches}
    return res


def speanalyzer_phase(torch, dev, vc) -> dict:
    """Phase 27: ``apps.speanalyzer`` on the card: the tone and the capture
    through the CLI (exit 0, the peak where the CPU finds it), the trace
    read back by ``apps.plotview``, ``welch_spectrum`` card against CPU,
    and its time at 262144 samples, nfft 1024."""
    import re
    import tempfile

    from sora_tpu_torch.apps import plotview, speanalyzer
    from sora_tpu_torch.io.dumpfile import load_dump

    peak = lambda out: re.search(r"^peak .* @ ([+-][0-9.]+) MHz", out,
                                 re.MULTILINE).group(1)
    runs = {}
    vc.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "spe.trace")
        for name, args in (("tone", list(SPE_TONE) + ["--trace", path]),
                           ("dump", ["--dump", str(CAPTURE)])):
            rc, out = capture_stdout(lambda: speanalyzer.main(args))
            rc_h, out_h = capture_stdout(lambda: speanalyzer.main(
                [a for a in args if a != path and a != "--trace"]
                + ["--device", "cpu"]))
            runs[name] = {"rc": rc, "peak_mhz": peak(out),
                          "cpu_peak_mhz": peak(out_h)}
            print(f"apps.speanalyzer --{name}: rc {rc}, peak "
                  f"{peak(out)} MHz (CPU {peak(out_h)} MHz)", flush=True)
            if rc or rc_h or peak(out) != peak(out_h):
                raise AssertionError(f"apps.speanalyzer --{name} failed")
        rc, view = capture_stdout(lambda: plotview.main([path]))
    if rc or "== spectrum [spectrum] ==" not in view:
        raise AssertionError("apps.plotview did not read the trace")
    print(f"apps.plotview of the --trace file: rc {rc}, "
          f"{len(view.splitlines())} lines", flush=True)
    t = np.arange(262144)
    tone = np.exp(2j * np.pi * 3.2e6 / 20e6 * t).astype(np.complex64)
    tone += (np.random.default_rng(0).normal(size=len(t))
             + 1j * np.random.default_rng(1).normal(size=len(t))
             ).astype(np.complex64) * 0.01
    cap = load_dump(str(CAPTURE))
    errs = {}
    for name, x, fs in (("tone", tone, 20e6), ("capture", cap - cap.mean(),
                                               40e6)):
        _, p = speanalyzer.welch_spectrum(x, 1024, fs, device=dev)
        _, p_h = speanalyzer.welch_spectrum(x, 1024, fs, device="cpu")
        live = p_h > p_h.max() - 80.0
        errs[name] = float(np.abs(p - p_h)[live].max())
        if errs[name] > SPE_DB_ATOL or np.argmax(p) != np.argmax(p_h):
            raise AssertionError(f"welch_spectrum {name}: card and CPU "
                                 f"differ by {errs[name]} dB")
    launches = no_launch(vc, "apps.speanalyzer")
    call = lambda: speanalyzer.welch_spectrum(tone, 1024, 20e6, device=dev)
    for _ in range(3):
        call()
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        call()                      # host array in, host array out
        ms.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(ms))
    seg = torch.as_tensor(tone.reshape(-1, 1024), device=dev)
    fft_ms = cuda_ms(lambda: torch.fft.fft(seg, dim=-1), 50)
    print(f"welch_spectrum card against CPU over the bins above peak - 80 "
          f"dB: tone {errs['tone']:.2e} dB, capture {errs['capture']:.2e} "
          f"dB (tolerance {SPE_DB_ATOL}), the same peak bin; kernel "
          f"launches {launches}; 262144 samples, nfft 1024: {ms:.3f} ms a "
          f"call (host clock, median of 20, host array in and out), the "
          f"library FFT of its 256 segments {fft_ms:.4f} ms (events)",
          flush=True)
    return {"runs": runs, "card_cpu_db": errs, "launches": launches,
            "welch_ms_262144_1024": ms, "fft_ms_256x1024": fft_ms}


def node_dump_phase(torch, vc) -> dict:
    """Phase 28: ``apps.node --dump fsample54.dmp --msps 40`` for 3 s on the
    card: the capture's 64-QAM frames decode with crc_fail 0 (the replay
    in the wire's units); the same run on raw ADC counts, as the JAX app
    replays them, loses them to the CRC."""
    from sora_tpu_torch.apps import node as appnode
    from sora_tpu_torch.runtime import native

    res = {}
    orig = native.replay_samples
    for name, replay in (("wire units", orig),
                         ("raw counts", lambda p: native.parse_dump(p))):
        native.replay_samples = replay
        try:
            vc.LAUNCHES = 0
            rc, out = capture_stdout(lambda: appnode.main(
                list(NODE_DUMP_ARGS)))
        finally:
            native.replay_samples = orig
        r = {k: status_count(out, k) for k in ("frame_ok", "crc_fail",
                                               "batches")}
        # one launch for the node's warm-up, then one per decoded batch
        r["launches"] = launched(vc, f"apps.node --dump ({name})",
                                 1 + r["batches"])
        r["rc"] = rc
        res[name] = r
        print(f"apps.node {' '.join(NODE_DUMP_ARGS)} ({name}): rc {rc}, "
              f"frame_ok {r['frame_ok']}, crc_fail {r['crc_fail']}, decoded "
              f"batches {r['batches']}, kernel launches {r['launches']}",
              flush=True)
    if res["wire units"]["frame_ok"] == 0 or res["wire units"]["crc_fail"]:
        raise AssertionError("apps.node --dump lost the capture's frames")
    if res["raw counts"]["crc_fail"] == 0:
        raise AssertionError("the raw-count replay no longer clips")
    return res


@contextmanager
def receiver_calls():
    """Counts the outermost calls of the sweeps' receiver entry points
    while it is open (a receiver that calls another, as ``rx_pipeline``
    calls ``decode_data``, counts once), passing each call on."""
    import importlib

    count, depth, saved = [0], [0], []

    def counted(orig):
        def call(*args, **kwargs):
            count[0] += depth[0] == 0
            depth[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    for mod_name, names in SWEEP_RECEIVERS:
        mod = importlib.import_module(f"sora_tpu_torch.{mod_name}")
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, counted(getattr(mod, name)))
    try:
        yield count
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def sweep_rows(sw, rx_mod, fn, snrs, dev, **kw) -> list:
    """Each receiver call's ok, length and PSDU of one sweep row."""
    from sora_tpu_torch.util.xfer import fetch

    recs = []
    orig = rx_mod.rx_pipeline

    def record(*a, **k):
        out = orig(*a, **k)
        recs.append(fetch({key: out[key] for key in ("ok", "length",
                                                     "psdu")}))
        return out

    rx_mod.rx_pipeline = record
    try:
        fn(snrs, device=dev, **kw)
    finally:
        rx_mod.rx_pipeline = orig
    return recs


def sweep_phase(torch, dev, vc, parity, int32_ops_per_s) -> dict:
    """Phase 29: the sensitivity sweep's default grid on the card (all five
    sweeps): the tables, exactly 1 launch per 11a call, 2 per 11n call, 0
    per 11b call; the kernel against its plain version on the 11a 6 Mbps
    call at 3 dB (noisy soft values at the waterfall); the 54 Mbps and
    MCS 15 rows frame for frame against the CPU; the sweep's wall time;
    the kernel's time at the largest 11a and 11n shapes."""
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.phy.dot11n import rx as nrx
    from sora_tpu_torch.tools import sensitivity_sweep as sw

    res, inputs = {}, {}
    wall = 0.0
    for name, fn, grid, per_call in SWEEPS:
        snrs = getattr(sw, grid)
        vc.LAUNCHES = 0
        with viterbi_inputs() as seen, receiver_calls() as count:
            t0 = time.perf_counter()
            rows = getattr(sw, fn)(snrs, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        calls = count[0]
        if not calls:
            raise AssertionError(f"sweep {name} made no receiver call")
        want = calls * per_call
        if want:
            launches = launched(vc, f"sweep {name}", want)
        else:
            launches = no_launch(vc, f"sweep {name}")
        wall += dt
        inputs[name] = seen
        res[name] = {"calls": calls, "launches": launches, "wall_s": dt,
                     "rows": {k: [[s, f, b] for s, f, b in v]
                              for k, v in rows.items()}}
        print(sw._table(f"{name} (card)", rows, snrs), flush=True)
        print(f"sweep {name}: {calls} receiver calls counted, kernel "
              f"launches {launches} ({launches / calls:g} per call), "
              f"{dt:.2f} s", flush=True)
    print(f"sensitivity sweep, default grid: {wall:.2f} s of wall time for "
          f"{sum(r['calls'] for r in res.values())} receiver calls",
          flush=True)

    # the kernel at the waterfall: 11a 6 Mbps (the first rate) at 3 dB
    if sw.A_RATES[0] != 6 or sw.SNRS_A[1] != 3:
        raise AssertionError("the sweep's first 11a row is not 6 Mbps")
    ab = inputs["11a"][1]
    parity("sweep 11a 6 Mbps at 3 dB soft", ab, *auto_window(ab.shape[1]),
           True)
    kernels = {}
    for name in ("11a", "11n"):
        big = max(inputs[name], key=lambda t: t.numel())
        kernels[name] = kernel_timing(vc, big, int32_ops_per_s)
        print_kernel(f"sweep's largest {name}", kernels[name])

    # one 11a and one 11n row, card against CPU, frame for frame
    same = {}
    for name, rx_mod, fn, grid, kw in (
            ("11a 54 Mbps", arx, sw.sweep_11a, sw.SNRS_A, {"rates": (54,)}),
            ("11n MCS 15", nrx, sw.sweep_11n, sw.SNRS_N,
             {"mcs_list": (15,)})):
        card = sweep_rows(sw, rx_mod, fn, grid, dev, **kw)
        cpu = sweep_rows(sw, rx_mod, fn, grid, "cpu", **kw)
        for snr, c, h in zip(grid, card, cpu):
            ok = h["ok"].astype(bool)
            if not (np.array_equal(c["ok"], h["ok"])
                    and np.array_equal(c["length"][ok], h["length"][ok])
                    and all(np.array_equal(c["psdu"][i][: h["length"][i]],
                                           h["psdu"][i][: h["length"][i]])
                            for i in np.flatnonzero(ok))):
                raise AssertionError(f"sweep {name} at {snr} dB: card and "
                                     "CPU frames differ")
        same[name] = [int(h["ok"].sum()) for h in cpu]
        print(f"sweep row {name}: card and CPU agree frame for frame at all "
              f"{len(grid)} SNR points (ok frames {same[name]})", flush=True)
    return {"sweeps": res, "wall_s": wall, "kernel": kernels,
            "card_cpu_ok_frames": same}


def ping_phase(torch, vc) -> dict:
    """Phase 30: ``tools.ping_over_air`` (two port nodes bridged to TAPs in
    two network namespaces) where the machine has root, /dev/net/tun and
    iproute2's ``ip``; otherwise one line saying it was not run and why."""
    import os
    import shutil

    from sora_tpu_torch.tools import ping_over_air

    euid, tun = os.geteuid(), os.path.exists("/dev/net/tun")
    ip = shutil.which("ip")
    if euid != 0 or not tun or ip is None:
        print(f"tools.ping_over_air: not run (it needs root, /dev/net/tun "
              f"and the ip command; euid {euid}, /dev/net/tun present "
              f"{tun}, ip {ip})", flush=True)
        return {"run": False, "euid": euid, "tun": tun, "ip": ip}
    vc.LAUNCHES = 0
    t0 = time.perf_counter()
    rc, out = capture_stdout(lambda: ping_over_air.main([]))
    dt = time.perf_counter() - t0
    launches = launched(vc, "tools.ping_over_air")
    for line in out.strip().splitlines():
        print(f"  {line}", flush=True)
    print(f"tools.ping_over_air: rc {rc} in {dt:.2f} s, kernel launches "
          f"{launches}", flush=True)
    if rc != 0 or "udp-echo-over-air OK" not in out:
        raise AssertionError("tools.ping_over_air failed")
    return {"run": True, "rc": rc, "s": dt, "launches": launches}


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
          f"{kernel_ms / bound_ms:.2f}; the windows run "
          f"{bnd['window_steps'] / bnd['steps']:.3f}x the steps the "
          "decode needs", flush=True)

    # ---- 5-7. TX, the mixed-rate path, the front end ------------------------
    paths = {"rx_pipeline": launches}
    mixed = tx_and_mixed_phase(torch, dev, rx, vc, parity)
    paths["rx_pipeline_auto"] = mixed.pop("launches")
    paths["rx_pipeline 40m"], x40 = frontend_phase(torch, dev, rx, vc,
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

    # ---- 12-16. 802.11n -----------------------------------------------------
    ht_tx = ht_tx_phase(torch, dev, vc)
    paths["11n tx decodes"] = ht_tx["launches"]
    ht15 = ht_fixed_phase(torch, dev, vc, parity, int32_ops_per_s, 15, 13)
    paths["rx_pipeline 11n MCS 15"] = ht15["launches"]
    ht7 = ht_fixed_phase(torch, dev, vc, parity, int32_ops_per_s, 7, 17)
    paths["rx_pipeline_1ss MCS 7"] = ht7["launches"]
    paths["rx_pipeline 11n short GI"] = ht_sgi_phase(torch, dev, vc)
    ht_auto = ht_mixed_phase(torch, dev, vc, parity, False)
    paths["rx_pipeline_auto 11n"] = ht_auto["launches"]
    ht_auto1 = ht_mixed_phase(torch, dev, vc, parity, True)
    paths["rx_pipeline_auto_1ss"] = ht_auto1["launches"]
    ht_soak = ht_soak_phase(torch, vc, parity, int32_ops_per_s, card)
    paths["11n soak"] = ht_soak["launches"]
    ht_node = ht_node_phase(torch, dev, vc, parity, int32_ops_per_s, card)
    paths["11n node"] = ht_node["launches"]

    # ---- 17-21. 802.11b: no Viterbi launch on any of these paths -----------
    b11_tx = b11_tx_phase(torch, dev, vc)
    paths["11b tx decodes"] = b11_tx.pop("launches")
    b11 = b11_batch_phase(torch, dev, vc)
    paths["rx_pipeline_auto 11b, rx_pipeline 11b, short preamble"] = \
        b11.pop("launches")
    paths["11b 44m and 40m front ends"] = b11_frontend_phase(torch, dev, vc)
    b11_soak = b11_soak_phase(torch, vc, card)
    paths["11b soak"] = b11_soak["launches"]
    b11_node = b11_node_phase(torch, dev, vc, card)
    paths["11b node"] = b11_node["launches"]

    # ---- 22. the sharded receivers on a (1, 1) NCCL mesh -------------------
    shard = sharded_phase(torch, dev, vc, parity, {
        "a": xd, "auto": mixed.pop("x"), "40m": x40, "n15": ht15.pop("x"),
        "nauto": ht_auto.pop("x"), "b": b11.pop("x")})
    for name, r in shard["paths"].items():
        paths[name] = r["launches"]
    for d in (ht7, ht_auto1):
        d.pop("x")

    # ---- 23-25. the tvws, sniffer and demod11 apps -------------------------
    tv = tvws_phase(torch, dev, vc)
    paths["apps.tvws"] = tv["launches"]
    sniff = sniffer_phase(torch, vc)
    paths["apps.sniffer synthetic"] = sniff["synthetic"]["launches"]
    paths["apps.sniffer dump"] = sniff["dump"]["launches"]
    dm = demod11_phase(torch, vc)
    for name, r in dm.items():
        paths[f"apps.demod11 {name}"] = r["launches"]

    # ---- 26-30. the SDL layer, speanalyzer, node replay, sweep, ping ------
    sdl = sdl_phase(torch, dev, vc)
    for phy in ("a", "n", "b"):
        paths[f"sdl.Radio phy {phy}"] = sdl[phy]["launches"]
    paths["sdl.Radio.replay"] = sdl["replay"]["launches"]
    spe = speanalyzer_phase(torch, dev, vc)
    paths["apps.speanalyzer"] = spe["launches"]
    ndump = node_dump_phase(torch, vc)
    for name, r in ndump.items():
        paths[f"apps.node --dump ({name})"] = r["launches"]
    sweep = sweep_phase(torch, dev, vc, parity, int32_ops_per_s)
    for name, r in sweep["sweeps"].items():
        paths[f"sensitivity_sweep {name}"] = r["launches"]
    ping = ping_phase(torch, vc)
    paths["tools.ping_over_air"] = ping.get("launches")

    ht_shapes = [
        {"path": "rx_pipeline MCS 15 HT-SIG", **ht15["kernel"]["htsig"],
         "launches_per_call": 1},
        {"path": "rx_pipeline MCS 15 data", **ht15["kernel"]["data"],
         "launches_per_call": 1},
        {"path": "rx_pipeline_1ss MCS 7 HT-SIG", **ht7["kernel"]["htsig"],
         "launches_per_call": 1},
        {"path": "rx_pipeline_1ss MCS 7 data", **ht7["kernel"]["data"],
         "launches_per_call": 1},
        {"path": "11n soak round data", **ht_soak["kernel"],
         "launches_per_round": ht_soak["launches_per_round"]},
        {"path": "11n node batch 2x2 data", **ht_node["kernel"],
         "launches_per_batch":
             ht_node["launches"] / ht_node["decoded_batches"]}]

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
               "dot11n": {"tx": ht_tx, "mcs15": ht15, "mcs7": ht7,
                          "auto": ht_auto, "auto_1ss": ht_auto1,
                          "soak": ht_soak["result"],
                          "soak_round": ht_soak["round"], "node": ht_node},
               "dot11b": {"tx": b11_tx, "batch": b11,
                          "soak": b11_soak["result"],
                          "soak_round": b11_soak["round"], "node": b11_node},
               "sharded": shard, "tvws": tv, "sniffer": sniff,
               "demod11": dm, "sdl": sdl, "speanalyzer": spe,
               "node_dump": ndump, "sweep": sweep, "ping_over_air": ping,
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
        **{f"{path}_{key}": res["kernel"][key]
           for path, res in (("soak", soak), ("node", node))
           for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
        "soak_launches_per_round": soak["launches_per_round"],
        "node_launches_per_batch":
            node["launches"] / node["decoded_batches"],
        "ht_shapes": ht_shapes,
        "sharded_launches_per_call": {
            name: r["launches"] for name, r in shard["paths"].items()},
        "radio_launches_per_batch": {
            phy: sdl[phy]["launches"] / max(1, sdl[phy]["decoded_batches"])
            for phy in ("a", "n", "b")},
        "sweep_receiver_calls": {
            name: r["calls"] for name, r in sweep["sweeps"].items()},
        "sweep_launches_per_call": {
            name: r["launches"] / r["calls"]
            for name, r in sweep["sweeps"].items()},
        "sweep_shapes": [
            {"path": f"sensitivity sweep's largest {name} call",
             **{k: sweep["kernel"][name][k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by")}}
            for name in ("11a", "11n")]}]}
    print(json.dumps(kernels), flush=True)
    torch.distributed.destroy_process_group()
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
