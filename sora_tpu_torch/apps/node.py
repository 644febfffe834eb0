"""Live SDR node CLI — the umxsdrbrick analogue over replay/synthetic air
(port of ``sora_tpu.apps.node``, phy "a", "b" and "n").

Boots the native RX ring, starts a paced producer (dump replay or
synthetic multi-frame traffic), runs the StreamingNode poll loop (batched
device decode + soft MAC + pre-staged ACKs), and prints the err_stat
status page and the MACStopwatch real-time report
(kernel/bb/umxsdrbrick/dot11main.cpp:365-457, mgmt.h:81,
demod11/MACStopwatch.h:37-60).

Examples
--------
Synthetic 24 Mbps traffic, paced at 20 Msps, on the card::

    python -m sora_tpu_torch.apps.node --synthetic 400 --rate 24 --pace 20e6

Synthetic mixed-rate DSSS traffic at 11 Msps chips (11b mode)::

    python -m sora_tpu_torch.apps.node --phy b --synthetic 400 --mixed \
        --batch 64

Synthetic mixed-MCS 2x2 HT traffic on two rings (11n mode), with the
inter-frame gap at the node's hop::

    python -m sora_tpu_torch.apps.node --phy n --synthetic 400 --mixed \
        --batch 64 --gap hop

Replay a 40 Msps dump, looped::

    python -m sora_tpu_torch.apps.node --dump tests/data/fsample54.dmp \\
        --loop --seconds 3

``--device cpu`` runs the node on the CPU (the default is cuda).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

_A_RATES = [6, 9, 12, 18, 24, 36, 48, 54]
_B_RATES = [1, 2, 5.5, 11]
_N_MCS = list(range(8, 16))


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def synthetic_traffic(n_frames: int, addr: bytes, mixed: bool,
                      rate: float, gap: int = 900, seed: int = 7,
                      phy: str = "a", device=None) -> np.ndarray:
    """A stream of n_frames data frames addressed to `addr`, separated by
    idle gaps, plus noise at 0.01.  phy "a": (N,) at 20 Msps, 148-byte
    frames, rate-mixed over the 8 OFDM rates if requested; phy "b": (N,)
    at 11 Msps chips, 88-byte frames, mixed over 1/2/5.5/11 Mbps if
    requested, with the gap at least 2400; phy "n": (nss, N) at 20 Msps,
    one row per TX chain (2 for MCS 8-15, mixed over them if requested),
    148-byte frames, with the gap at least 3200.  The payloads and the
    noise are drawn from one numpy generator as in the JAX package; the
    frames are modulated by the port's TX on ``device`` (default cuda),
    one batched call per rate."""
    from sora_tpu_torch.mac.frame import MacHeader, append_fcs
    from sora_tpu_torch.phy.dot11a import tx as atx
    from sora_tpu_torch.phy.dot11b import tx as btx
    from sora_tpu_torch.phy.dot11n import tx as ntx
    from sora_tpu_torch.util.xfer import fetch, resolve_device, upload

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    nbytes = 120
    if phy == "b":
        rates = _B_RATES if mixed else [rate]
        gap = max(gap, 2400)
        modulate = btx.modulate
        nbytes = 60
    elif phy == "n":
        rates = _N_MCS if mixed else [int(rate)]
        gap = max(gap, 3200)
        modulate = ntx.modulate
    else:
        rates = _A_RATES if mixed else [int(rate)]
        modulate = atx.modulate
    psdus = []
    for i in range(n_frames):
        hdr = MacHeader(addr1=addr, addr2=b"\x02PEER0", addr3=addr,
                        seq_ctrl=(i & 0xFFF) << 4)
        payload = bytes(rng.integers(0, 256, nbytes, dtype=np.uint8))
        psdus.append(np.frombuffer(append_fcs(hdr.pack() + payload),
                                   np.uint8))
    waves = [None] * n_frames
    for r in sorted(set(rates)):
        idx = [i for i in range(n_frames) if rates[i % len(rates)] == r]
        if not idx:
            continue
        arr = np.stack([psdus[i] for i in idx])
        w = fetch(modulate(upload(arr, dev), r, arr.shape[1]))
        for k, i in enumerate(idx):
            waves[i] = w[k]
    pieces = []
    for w in waves:
        pieces.append(np.zeros(w.shape[:-1] + (gap,), np.complex64))
        pieces.append(w)
    pieces.append(np.zeros(pieces[0].shape[:-1] + (gap,), np.complex64))
    x = np.concatenate(pieces, axis=-1)
    x += (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
          ).astype(np.complex64) * 0.01
    return x


def _process_kb(node, phy: str = "a") -> bool:
    """Non-blocking stdin control — the reference UI loop's live
    reconfiguration (process_kb, dot11main.cpp:148-204).  Keys:
    1-8 fixed rate/MCS, 0 auto dispatch, t/T detect threshold down/up,
    p promiscuous toggle, s status page, q quit.  Returns False on q."""
    import select

    while True:
        ready, _, _ = select.select([sys.stdin], [], [], 0)
        if not ready:
            return True
        ch = sys.stdin.read(1)
        if not ch:
            return True
        if ch == "q":
            return False
        if ch == "s":
            _log(node.report())
        elif ch == "p":
            node.reconfigure(promiscuous=not node.cfg.promiscuous)
            _log(f"promiscuous={node.cfg.promiscuous}")
        elif ch in "tT":
            thr = node.cfg.detect_threshold * (1.25 if ch == "T" else 0.8)
            node.reconfigure(detect_threshold=thr)
            _log(f"detect_threshold={thr:.3f}")
        elif ch == "0":
            node.reconfigure(rate_mbps=None, mcs=None, warm=True)
            _log("rate=auto")
        elif ch.isdigit():
            i = int(ch) - 1
            rates = _B_RATES if phy == "b" else _A_RATES
            if phy == "n":
                node.reconfigure(mcs=8 + i, warm=True)
                _log(f"mcs={8 + i}")
            elif i < len(rates):
                node.reconfigure(rate_mbps=rates[i], warm=True)
                _log(f"rate={rates[i]} Mbps")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.node",
                                description=__doc__.split("\n")[0])
    p.add_argument("--phy", default="a", choices=("a", "b", "n"),
                   help="PHY mode (umxsdrbrick -b / -n flags)")
    p.add_argument("--dump", help="replay a Sora dump file into the ring")
    p.add_argument("--loop", action="store_true",
                   help="loop the replay source")
    p.add_argument("--synthetic", type=int, metavar="N", default=0,
                   help="generate N synthetic data frames instead")
    p.add_argument("--mixed", action="store_true",
                   help="synthetic traffic cycles all rates (the 4 DSSS "
                        "rates with --phy b, MCS 8-15 with --phy n)")
    p.add_argument("--rate", type=float, default=0.0,
                   help="synthetic traffic rate: Mbps (11a/11b) or MCS "
                        "index (11n); 0 = per-phy default")
    p.add_argument("--gap", default="900", metavar="N|hop",
                   help="synthetic inter-frame gap in samples (floored at "
                        "2400 for --phy b and 3200 for --phy n, as the JAX "
                        "app does), or 'hop' for the node's hop")
    p.add_argument("--pace", type=float, default=0.0,
                   help="producer pacing in samples/s (0 = unpaced); "
                        "dump replay defaults to its design rate")
    p.add_argument("--msps", type=int, default=40, choices=(20, 40),
                   help="dump sample rate (chooses the device front end)")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="how long to run the node loop")
    p.add_argument("--batch", type=int, default=0,
                   help="windows per device batch (0 = auto)")
    p.add_argument("--window", type=int, default=0,
                   help="samples per window (0 = auto)")
    p.add_argument("--status-every", type=float, default=0.0,
                   help="print the status page every S seconds")
    p.add_argument("--keys", action="store_true",
                   help="interactive stdin control: 1-8 rate/MCS, 0 auto, "
                        "t/T threshold, p promiscuous, s status, q quit "
                        "(process_kb, dot11main.cpp:148-204)")
    p.add_argument("--config", default=None,
                   help="NodeConfig JSON file (layered under env "
                        "SORA_* and explicit flags; util/config.py)")
    p.add_argument("--rx-gain", type=float, default=None, metavar="DB",
                   help="radio RX gain in dB (SoraURadioSetRxGain over "
                        "the software front end, runtime/radio.py)")
    p.add_argument("--freq-offset", type=float, default=0.0, metavar="HZ",
                   help="radio fine frequency offset "
                        "(SoraURadioSetFreqOffset)")
    p.add_argument("--tune-error", type=float, default=0.0, metavar="HZ",
                   help="simulated central-frequency mismatch vs the "
                        "air (SetCentralFreq delta)")
    p.add_argument("--wire", default="i16", choices=("i16", "i8"),
                   help="host->device sample wire format")
    p.add_argument("--device", default="cuda",
                   help="torch device of the node (default cuda)")
    args = p.parse_args(argv)

    from sora_tpu_torch.runtime.native import RxRing, replay_samples
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink
    from sora_tpu_torch.util.config import load_config

    addr = b"\x02SORA1"
    rate = args.rate or {"a": 6, "b": 2, "n": 8}[args.phy]
    if args.gap != "hop" and not args.gap.isdigit():
        p.error(f"--gap must be a sample count or 'hop', got {args.gap!r}")
    if args.dump:
        if args.phy != "a":
            p.error("--dump replay is the 11a capture path; use "
                    "--synthetic with --phy b/n")
        src = replay_samples(args.dump)      # in the wire's units
        input_rate = "40m" if args.msps == 40 else "20m"
        rate_sps = args.pace or float(args.msps) * 1e6
        batch = args.batch or 4
        max_psdu = 1600
        min_rate = 6.0
    else:
        if not args.synthetic:
            p.error("need --dump or --synthetic N")
        input_rate = "11m" if args.phy == "b" else "20m"
        rate_sps = args.pace
        batch = args.batch or 8
        max_psdu = 256
        if args.mixed:
            min_rate = {"a": 6.0, "b": 1.0, "n": 8.0}[args.phy]
        else:
            min_rate = rate

    # window/overlap auto-size from (max_psdu, min_rate) inside
    # NodeConfig.__post_init__
    default_sps = 11e6 if args.phy == "b" else 20e6
    cfg = load_config(NodeConfig, path=args.config, overrides=dict(
        phy=args.phy, window=args.window, batch=batch, overlap=0,
        input_rate=input_rate, max_psdu=max_psdu, addr=addr,
        min_rate_mbps=min_rate, wire=args.wire,
        mcs=(None if args.mixed or args.phy != "n" else int(rate)),
        sample_rate_sps=rate_sps or default_sps))
    if not args.dump:
        # the DSSS and HT nodes lock one onset per window: a frame decodes
        # when some window starts in the gap before it, which a gap of at
        # least the hop guarantees (--gap hop)
        gap = (cfg.window - cfg.overlap if args.gap == "hop"
               else int(args.gap))
        src = synthetic_traffic(args.synthetic, addr, args.mixed, rate,
                                gap=gap, phy=args.phy, device=args.device)
    if (args.rx_gain is not None or args.freq_offset
            or args.tune_error) and src.ndim == 1:
        # run the source through the radio front end (gain, tuning) —
        # the SoraURadioSetRxGain/SetCentralFreq path over software
        from sora_tpu_torch.runtime.radio import SoftRadio
        radio = SoftRadio(device=args.device)
        radio.attach_air(src, freq_hz=2.422e9,
                         rate_sps=rate_sps or default_sps)
        if args.rx_gain is not None:
            radio.set_rx_gain(args.rx_gain)
        radio.set_central_freq(2.422e9 + args.tune_error)
        radio.set_freq_offset(args.freq_offset)
        src = radio.capture()
        _log(f"radio: rx_gain={radio.state.rx_gain_db} dB "
             f"tune_error={args.tune_error:+.0f} Hz "
             f"freq_offset={args.freq_offset:+.0f} Hz")
    # 11n reads two rings, one per antenna; a single-chain (MCS 0-7)
    # source feeds both
    rings = [RxRing(capacity=1 << 22)
             for _ in range(2 if args.phy == "n" else 1)]
    try:
        node = StreamingNode(rings if args.phy == "n" else rings[0], cfg,
                             tx_sink=TxSink(), device=args.device)
        _log(f"node: phy={args.phy} window={cfg.window} batch={cfg.batch} "
             f"overlap={cfg.overlap} front_end={input_rate} "
             f"pace={(rate_sps or default_sps) / 1e6:.1f} Msps "
             f"src={src.shape[-1]} samples loop={bool(args.loop or args.dump)}"
             f" device={node.device}")
        t0 = time.perf_counter()
        node.warm_up()
        _log(f"warm-up (kernel build, tables) in "
             f"{time.perf_counter() - t0:.1f}s")
        for a, r in enumerate(rings):
            r.start_replay(src[min(a, len(src) - 1)] if src.ndim == 2
                           else src, rate_sps=rate_sps,
                           loop=bool(args.loop) or bool(args.dump))
        t_end = time.perf_counter() + args.seconds
        t_status = time.perf_counter() + (args.status_every or 1e9)
        try:
            while time.perf_counter() < t_end:
                if not node.step():
                    time.sleep(0.001)
                if time.perf_counter() >= t_status:
                    _log(node.stats.status_page())
                    t_status = time.perf_counter() + args.status_every
                if args.keys and not _process_kb(node, args.phy):
                    break
        finally:
            for r in rings:
                r.stop()
        node.flush()
    finally:
        for r in rings:
            r.close()
    print(node.report())
    rep = node.sw.report()
    ok = node.stats.frame_ok > 0 and rep.avg_ratio < 1.0
    print(f"node {'OK' if ok else 'NOT-REALTIME-OR-IDLE'}: "
          f"{node.stats.frame_ok} frames, {node.stats.acks_tx} acks, "
          f"avg ratio {rep.avg_ratio:.3f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
