"""The port's benchmark: bench.py's rows on one CUDA card.

    python3 -m sora_tpu_torch.tools.bench        # from the repository root

Prints one JSON line on stdout with the keys of the JAX package's
``bench.py`` (bench.py:233-250) and a ``"card"`` key holding
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
diagnostics go to stderr.  Without CUDA it exits nonzero and prints no
result.

The inputs are bench.py's own, with every waveform from the port's TX on
the card: the saturated 54 Mbps batch (bench.py:36-52), the Viterbi row
((128, 12096), block 1024, overlap 64, unterminated; :137-145), the
mixed-rate path (:191-196), the TX row (:201-225), the 11b and 11n rows
(:269-336), the live node (:339-440) and an 8 s rx soak (:253-266).

Timing follows PERF.md section 2 instead of bench.py's amortized fetch:
a batch row's time is the median of 5 windows of 20 back-to-back calls
between CUDA events, after warm-up; the Viterbi kernel is timed by
replaying a CUDA graph of 50 launches, so the wrapper's host work is not
in its time; the node runs 5 s of paced traffic on the host clock.
``compile_first_s`` is the first 54 Mbps call, the kernel's nvcc build
included when the library is not yet built.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

ADDR = b"\x02SORA1"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over reps back-to-back calls
    (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def median_ms(fn, windows: int = 5, reps: int = 20):
    """(median, sorted windows): milliseconds per call of fn() in
    ``windows`` windows of ``reps`` back-to-back calls, after two warm-up
    calls (the batch paths are host-launch-bound, so a host hiccup moves
    one window)."""
    for _ in range(2):
        fn()
    ms = sorted(cuda_ms(fn, reps) for _ in range(windows))
    return ms[len(ms) // 2], ms


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn() from replays of a CUDA
    graph of reps calls, so that the host's work per call is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / reps


# ---------------------------------------------------------------------------
# bench.py's inputs, from the port's TX
# ---------------------------------------------------------------------------


def _data_frame(rng, payload: int, seq: int) -> np.ndarray:
    from sora_tpu_torch.mac.frame import build_data_frame

    return np.frombuffer(build_data_frame(bytes(rng.integers(
        0, 256, payload, dtype=np.uint8)), seq=seq), np.uint8)


def _place(wave: np.ndarray, B: int, N: int, offset, rng) -> np.ndarray:
    """B streams of N samples holding ``wave`` at offset(i), plus complex
    Gaussian noise of 0.02 per part drawn from rng (bench.py's layout)."""
    x = np.zeros((B,) + wave.shape[:-1] + (N,), np.complex64)
    for i in range(B):
        o = offset(i)
        x[i, ..., o: o + wave.shape[-1]] = wave
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * 0.02
    return x


def saturated_batch(rate_mbps: int, B: int, psdu_len: int, seed: int,
                    device):
    """bench.py's ``_saturated_batch``: B streams, each one frame at
    offset 25 + (13 i) % 120 in its length + 160 samples.  Returns (x host
    complex64 (B, N), psdu bytes)."""
    from sora_tpu_torch.phy.dot11a import tx as atx
    from sora_tpu_torch.util.xfer import fetch, upload

    rng = np.random.default_rng(seed)
    psdu = _data_frame(rng, psdu_len - 28, 1)
    wave = fetch(atx.modulate(upload(psdu[None], device), rate_mbps,
                              psdu_len))[0]
    x = _place(wave, B, len(wave) + 160, lambda i: 25 + (13 * i) % 120, rng)
    return x, psdu.tobytes()


def b11_batch(device, preamble: str = "long"):
    """bench.py's 11b row (bench.py:269-291): 128 streams of one 1000-byte
    11 Mbps CCK frame (972-byte payload, seq 2, default_rng(5)) at offsets
    30 + (7 i) % 300 in its length + 400 chips, noise 0.02 — 10512 chips a
    stream with the long preamble.  Returns (x host complex64 (128, N),
    psdu bytes)."""
    from sora_tpu_torch.phy.dot11b import tx as btx
    from sora_tpu_torch.util.xfer import fetch, upload

    rng = np.random.default_rng(5)
    psdu = _data_frame(rng, 972, 2)
    wave = fetch(btx.modulate(upload(psdu[None], device), 11, len(psdu),
                              preamble=preamble))[0]
    x = _place(wave, 128, len(wave) + 400, lambda i: 30 + (7 * i) % 300, rng)
    return x, psdu.tobytes()


def n11_batches(device):
    """bench.py's 11n rows (bench.py:294-336): 128 streams of a 1500-byte
    MCS 15 2x2 frame (chain a on antenna a), then from the same generator
    128 streams of a 1500-byte MCS 7 frame on both antennas; offsets
    30 + (7 i) % 300 in the length + 400.  Returns ((x15, psdu15),
    (x7, psdu7)), x host complex64 (128, 2, N)."""
    from sora_tpu_torch.phy.dot11n import tx as ntx
    from sora_tpu_torch.util.xfer import fetch, upload

    rng = np.random.default_rng(6)
    out = []
    for mcs, seq in ((15, 3), (7, 4)):
        psdu = _data_frame(rng, 1472, seq)
        w = fetch(ntx.modulate(upload(psdu[None], device), mcs, 1500))[0]
        if mcs < 8:
            w = np.repeat(w, 2, axis=0)        # one chain on both antennas
        x = _place(w, 128, w.shape[-1] + 400, lambda i: 30 + (7 * i) % 300,
                   rng)
        out.append((x, psdu.tobytes()))
    return tuple(out)


def viterbi_soft(B: int, T: int, device):
    """bench.py's Viterbi input (bench.py:137-142): random bits encoded,
    +-1 soft values plus Gaussian noise of 0.25.  Returns (soft (B, T, 2)
    on device, bits host (B, T))."""
    from sora_tpu_torch.dsp import viterbi as dvit

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (B, T), dtype=np.uint8)
    coded = dvit.encode(torch.from_numpy(bits)).numpy().reshape(B, T, 2)
    soft = (2.0 * coded - 1.0).astype(np.float32) \
        + rng.normal(size=(B, T, 2)).astype(np.float32) * 0.25
    return torch.from_numpy(soft).to(device), bits


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def _all_ok(out: dict, B: int, what: str) -> None:
    n = int(out["ok"].sum())
    if n != B:
        raise AssertionError(f"{what}: ok {n}/{B}")


def bench_11a(dev) -> dict:
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.phy.dot11a import tx as atx
    from sora_tpu_torch.util.xfer import device_complex, fetch, upload

    rate, psdu_len, B, max_psdu = 54, 1500, 128, 1504
    x, psdu = saturated_batch(rate, B, psdu_len, 1, dev)
    xd = device_complex(x, dev)
    N = x.shape[1]
    run = lambda: arx.rx_pipeline(xd, rate, max_psdu=max_psdu)
    t0 = time.perf_counter()
    out = fetch(run())
    compile_s = time.perf_counter() - t0
    _all_ok(out, B, "54 Mbps batch")
    ms, win = median_ms(run)
    res = {"compile_first_s": compile_s, "ms": ms,
           "msps": B * N / ms / 1e3,
           "decoded_mbps": B * psdu_len * 8 / ms / 1e3}
    log(f"compile+first run {compile_s:.2f} s; saturated batch {B}x{N}: "
        f"{ms:.3f} ms/batch (events, median of 5 windows of 20; range "
        f"{win[0]:.3f}-{win[-1]:.3f}) -> {res['msps']:.1f} Msamples/s, "
        f"{res['decoded_mbps']:.1f} Mbps decoded")

    xa, _ = saturated_batch(rate, B, psdu_len, 3, dev)
    xad = device_complex(xa, dev)
    run_a = lambda: arx.rx_pipeline_auto(xad, max_psdu=max_psdu)
    _all_ok(fetch(run_a()), B, "mixed-rate path")
    ms_a, _ = median_ms(run_a)
    log(f"  auto (mixed-rate) path: {ms_a:.3f} ms/batch, "
        f"{B * xa.shape[1] / ms_a / 1e3:.1f} Msamples/s")

    arr = np.repeat(np.frombuffer(psdu, np.uint8)[None, :], B, axis=0)
    ad = upload(arr, dev)
    wlen = atx.waveform_len(rate, psdu_len)
    ms_t, _ = median_ms(lambda: atx.modulate(ad, rate, psdu_len))
    res["tx_msps"] = B * wlen / ms_t / 1e3
    log(f"  11a 54 Mbps TX modulate: {ms_t:.3f} ms for {B} frames -> "
        f"{res['tx_msps']:.1f} Msamples/s")
    return res


def bench_viterbi(dev) -> float:
    from sora_tpu_torch.ops import viterbi_cuda as vc

    B, T = 128, 56 * 216             # the 54 Mbps chain's trellis
    soft, bits = viterbi_soft(B, T, dev)
    run = lambda: vc.decode_blocks(soft, 1024, 64, False)
    ber = float((run().cpu().numpy() != bits).mean())
    ms = graph_ms(run, 50)
    mbit = B * T / ms / 1e3
    log(f"  viterbi kernel ({B}, {T}) block 1024 overlap 64 unterminated: "
        f"{ms:.4f} ms (graph replay of 50) -> {mbit:.1f} Mbit/s, "
        f"ber {ber:.1e}")
    return mbit


def bench_11b(dev) -> float:
    from sora_tpu_torch.phy.dot11b import rx as brx
    from sora_tpu_torch.util.xfer import device_complex, fetch

    x, _ = b11_batch(dev)
    xd = device_complex(x, dev)
    B, N = x.shape
    run = lambda: brx.rx_pipeline_auto(xd, max_psdu=1024)
    _all_ok(fetch(run()), B, "11b batch")
    ms, _ = median_ms(run)
    msps = B * N / ms / 1e3
    log(f"  11b CCK-11 auto path {B}x{N}: {ms:.3f} ms/batch -> {msps:.1f} "
        f"Msamples/s@11Msps ({msps / 11.0:.1f}x real time), "
        f"{B * 1000 * 8 / ms / 1e3:.1f} Mbps decoded")
    return msps


def bench_11n(dev) -> float:
    from sora_tpu_torch.phy.dot11n import rx as nrx
    from sora_tpu_torch.util.xfer import device_complex, fetch

    (x15, _), (x7, _) = n11_batches(dev)
    msps = {}
    for mcs, x, pipe in ((15, x15, nrx.rx_pipeline),
                         (7, x7, nrx.rx_pipeline_1ss)):
        xd = device_complex(x, dev)
        B, _, N = x.shape
        run = lambda: pipe(xd, mcs, max_psdu=1504)
        _all_ok(fetch(run()), B, f"11n MCS {mcs} batch")
        ms, _ = median_ms(run)
        msps[mcs] = B * N / ms / 1e3
        log(f"  11n MCS {mcs} {B}x2x{N}: {ms:.3f} ms/batch -> "
            f"{msps[mcs]:.1f} Msamples/s@20Msps per antenna, "
            f"{B * 1500 * 8 / ms / 1e3:.1f} Mbps decoded")
    return msps[15]


def bench_node(dev):
    """bench.py's node row (bench.py:339-440): 5 s of paced looped 24 Mbps
    traffic, the device-only ratio and the sparse-air compaction pair.
    Returns (frames/s, stopwatch ratio, device ratio, compacted sparse
    device ratio, compaction speedup)."""
    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink
    from sora_tpu_torch.util.xfer import device_complex16, fetch

    cfg = NodeConfig(max_psdu=256, min_rate_mbps=24, window=32768, batch=64,
                     max_frames_per_window=11, addr=ADDR, rate_mbps=None,
                     wire="i8")
    src = synthetic_traffic(400, ADDR, mixed=False, rate=24, gap=900,
                            device=dev)
    ring = RxRing(capacity=1 << 25)
    try:
        node = StreamingNode(ring, cfg, tx_sink=TxSink(), device=dev)
        node.warm_up()
        ring.start_replay(src, rate_sps=20e6, loop=True)
        secs = 5.0
        t_end = time.perf_counter() + secs
        try:
            while time.perf_counter() < t_end:
                if not node.step():
                    time.sleep(0.001)
        finally:
            ring.stop()
        node.flush()
    finally:
        ring.close()
    rep = node.sw.report()
    fps = node.stats.frame_ok / secs
    log(f"  node: {node.stats.frame_ok} frames in {secs:.0f} s ({fps:.0f} "
        f"frames/s), avg stopwatch ratio {rep.avg_ratio:.3f}, dup "
        f"{node.stats.dup}, crc_fail {node.stats.crc_fail}")
    if node.stats.frame_ok == 0:
        raise AssertionError("the node decoded nothing")

    hop = cfg.window - cfg.overlap
    air = (cfg.window + hop * (cfg.batch - 1)) / cfg.sample_rate_sps
    xb = src[: cfg.window]
    xd = device_complex16(np.stack([np.roll(xb, -37 * i)[: cfg.window]
                                    for i in range(cfg.batch)]), dev)
    issue = lambda: (node._detect(xd), node._decode(xd))
    issue()
    dev_ratio = cuda_ms(issue, 20) / 1e3 / air
    log(f"  node device-only: ratio {dev_ratio:.4f} (20 detect+decode "
        f"calls over {air * 1e3:.2f} ms of air)")

    src_sp = synthetic_traffic(80, ADDR, mixed=False, rate=24, gap=30000,
                               device=dev)
    xd_sp = device_complex16(np.stack(
        [src_sp[(i * hop) % max(1, len(src_sp) - cfg.window):][: cfg.window]
         for i in range(cfg.batch)]), dev)
    K = cfg.max_frames_per_window
    full = lambda: arx.rx_pipeline_auto(xd_sp, max_psdu=cfg.max_psdu,
                                        n_frames=K)
    comp = lambda: arx.rx_pipeline_auto(xd_sp, max_psdu=cfg.max_psdu,
                                        n_frames=K, n_decode=2 * cfg.batch)
    n_full, n_comp = (int(fetch(f()["ok"]).sum()) for f in (full, comp))
    if n_full != n_comp:
        raise AssertionError(f"compaction: {n_comp} ok rows against {n_full}")
    fdt, _ = median_ms(full, 5, 10)
    cdt, _ = median_ms(comp, 5, 10)
    log(f"  sparse-air compaction: {n_full} frames/batch; full "
        f"{fdt:.3f} ms -> top-{2 * cfg.batch} {cdt:.3f} ms, "
        f"{fdt / cdt:.2f}x")
    return fps, rep.avg_ratio, dev_ratio, cdt / 1e3 / air, fdt / cdt


def bench_realtime() -> float:
    from sora_tpu_torch.tools import realtime_soak as soak

    res = soak.run_rx_soak(8.0, 6, lambda *a: log("  soak:", *a),
                           strict=False)
    log(f"  device-air real time: ratio {res['ratio']} "
        f"({res['frames_delivered']}/{res['frames_scheduled']} frames)")
    return res["ratio"]


def main() -> int:
    if not torch.cuda.is_available():
        log("sora_tpu_torch.tools.bench: CUDA is not available")
        return 1
    dev = torch.device("cuda")
    card = card_line()
    log(card, "|", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    a = bench_11a(dev)
    vit = bench_viterbi(dev)
    b_msps = bench_11b(dev)
    n_msps = bench_11n(dev)
    fps, rt, dev_ratio, sparse, compact = bench_node(dev)
    rt_ratio = bench_realtime()
    print(json.dumps({
        "metric": "dot11a54_rx_throughput",
        "value": round(a["msps"], 2),
        "unit": "Msamples/s@20Msps",
        "vs_baseline": round(a["msps"] / 20.0, 2),
        "decoded_mbps": round(a["decoded_mbps"], 1),
        "viterbi_mbit_s": round(vit, 1),
        "b11_msps": round(b_msps, 2),
        "n11_msps": round(n_msps, 2),
        "node_frames_s": round(fps, 1),
        "node_rt_ratio": round(rt, 3),
        "node_device_ratio": round(dev_ratio, 3),
        "node_sparse_device_ratio": round(sparse, 3),
        "node_compaction_speedup": round(compact, 2),
        "realtime_ratio": round(rt_ratio, 3),
        "tx_msps": round(a["tx_msps"], 1),
        "compile_first_s": round(a["compile_first_s"], 1),
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
