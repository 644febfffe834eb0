"""Node soak: sustained looped traffic through the live node, with its
invariant and leak checks (port of the JAX package's ``tools/soak.py``).

Loops mixed-rate traffic (phy "a": the 8 OFDM rates at 20 Msps; phy "b":
the 4 DSSS/CCK rates at 11 Msps chips) through the StreamingNode for
``--seconds`` and checks the long-run invariants:

* decode keeps up (frame_ok strictly increasing between checkpoints),
* bounded state: dedup table, ACK-latency deque, pending queues,
* RSS stable (no growth trend beyond the first warm-up checkpoint),
* crc_fail at most 2% of frame_ok on clean looped air.

Run from the repository root (on the card by default)::

    python -m sora_tpu_torch.tools.node_soak --seconds 30
    python -m sora_tpu_torch.tools.node_soak --phy b --seconds 30
"""

from __future__ import annotations

import argparse
import resource
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.tools.node_soak",
                                description=__doc__.split("\n")[0])
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--phy", default="a", choices=("a", "b"))
    p.add_argument("--wire", default="i8", choices=("i16", "i8"))
    p.add_argument("--channel", action="store_true",
                   help="run the air through the radio's ChannelModel "
                        "(4-tap in-CP multipath + 55 kHz Doppler + "
                        "20 ppm SFO + antenna noise)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the node (default cuda)")
    args = p.parse_args(argv)

    from sora_tpu_torch.apps.node import synthetic_traffic
    from sora_tpu_torch.runtime.native import RxRing
    from sora_tpu_torch.runtime.node import NodeConfig, StreamingNode, TxSink

    addr = b"\x02SORA1"
    cfg = NodeConfig(phy=args.phy, max_psdu=256, min_rate_mbps=6,
                     addr=addr, rate_mbps=None, wire=args.wire,
                     input_rate="11m" if args.phy == "b" else "20m",
                     sample_rate_sps=11e6 if args.phy == "b" else 20e6)
    ring = RxRing(capacity=1 << 24)
    node = StreamingNode(ring, cfg, tx_sink=TxSink(), device=args.device)
    print(f"soak: phy={args.phy} wire={args.wire} window={cfg.window} "
          f"batch={cfg.batch} device={node.device}", flush=True)
    node.warm_up()
    src = synthetic_traffic(64, addr, mixed=True, rate=6, phy=args.phy,
                            device=args.device)
    if args.channel:
        from sora_tpu_torch.runtime.radio import (REF_TAPS, ChannelModel,
                                                  SoftRadio)
        radio = SoftRadio(device=args.device)
        radio.attach_air(src, rate_sps=cfg.sample_rate_sps)
        radio.set_channel(ChannelModel(
            taps=REF_TAPS, doppler_hz=55e3, sfo_ppm=20.0,
            noise_rms=0.01, seed=9))
        src = radio.capture()
        print("channel: 4-tap multipath + 55 kHz doppler + 20 ppm sfo "
              "+ antenna noise", flush=True)
    # paced loop at the air rate; the watchdog handles any backlog — a
    # soak exercises exactly that steady state
    ring.start_replay(src, rate_sps=cfg.sample_rate_sps, loop=True)

    t_end = time.perf_counter() + args.seconds
    checkpoints = []
    next_ck = time.perf_counter() + 5.0
    try:
        while time.perf_counter() < t_end:
            if not node.step():
                time.sleep(0.001)
            if time.perf_counter() >= next_ck:
                rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                checkpoints.append((node.stats.frame_ok, rss,
                                    len(node._seen), len(node._pend),
                                    len(node._det_pend)))
                next_ck += 5.0
    finally:
        ring.stop()
    node.flush()
    ring.close()

    print(node.report(), flush=True)
    ok = True
    if len(checkpoints) >= 2:
        frames = [c[0] for c in checkpoints]
        if not all(b > a for a, b in zip(frames, frames[1:])):
            print("FAIL: frame_ok stalled between checkpoints", frames)
            ok = False
        # RSS after the first checkpoint (warm) must not keep climbing
        rss = [c[1] for c in checkpoints[1:]]
        if len(rss) >= 2 and rss[-1] > rss[0] * 1.15:
            print(f"FAIL: RSS grew {rss[0]} -> {rss[-1]} KB")
            ok = False
    # truncated = frames straddling the window end (decoded from the
    # next overlap; boundary accounting) — only genuine crc_fail counts
    if node.stats.crc_fail > 0.02 * max(1, node.stats.frame_ok):
        print(f"FAIL: crc_fail {node.stats.crc_fail} vs "
              f"frame_ok {node.stats.frame_ok} "
              f"(truncated {node.stats.truncated})")
        ok = False
    if len(node._seen) > 4096 or node.stats.ack_latency_s.maxlen != 4096:
        print("FAIL: unbounded state")
        ok = False
    print("soak", "OK" if ok else "FAILED",
          f"({node.stats.frame_ok} frames, "
          f"{len(checkpoints)} checkpoints)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
