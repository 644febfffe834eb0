"""srview — dump-file viewer/cutter (the bintools srview analogue,
bintools/Readme.txt:1-25): inspect a Sora RX dump and cut a sample range
into a new dump file (port of ``sora_tpu.apps.srview``; numpy only).

Examples::

    python -m sora_tpu_torch.apps.srview info  capture.dmp
    python -m sora_tpu_torch.apps.srview cut   capture.dmp out.dmp 1000 50000
    python -m sora_tpu_torch.apps.srview ascii capture.dmp --bins 64
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.srview",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info", help="print dump statistics")
    pi.add_argument("dump")
    pc = sub.add_parser("cut", help="cut [start, end) samples to a new dump")
    pc.add_argument("dump")
    pc.add_argument("out")
    pc.add_argument("start", type=int)
    pc.add_argument("end", type=int)
    pc.add_argument("--bits", type=int, default=16, choices=(14, 16))
    pa = sub.add_parser("ascii", help="coarse |x| envelope in the terminal")
    pa.add_argument("dump")
    pa.add_argument("--bins", type=int, default=72)
    args = p.parse_args(argv)

    from sora_tpu_torch.io.dumpfile import load_dump, save_dump

    x = load_dump(args.dump)
    if args.cmd == "info":
        p2 = np.abs(x) ** 2
        peak = float(np.max(np.abs(x)))
        print(f"{args.dump}: {len(x)} samples")
        print(f"  mean power {10*np.log10(np.mean(p2)+1e-30):7.1f} dB  "
              f"peak |x| {peak:.0f}")
        dc = complex(np.mean(x))
        print(f"  DC offset  {dc.real:8.1f} {dc.imag:+8.1f}j")
        act = np.flatnonzero(p2 > 0.05 * np.max(p2))
        if len(act):
            print(f"  active region [{act[0]}, {act[-1]}] "
                  f"({act[-1]-act[0]+1} samples)")
        return 0
    if args.cmd == "cut":
        seg = x[args.start: args.end]
        n = save_dump(args.out, seg, bits=args.bits)
        print(f"wrote {n} samples -> {args.out}")
        return 0
    # ascii envelope
    nb = args.bins
    edges = np.linspace(0, len(x), nb + 1).astype(int)
    env = np.array([np.sqrt(np.mean(np.abs(x[a:b]) ** 2) + 1e-30)
                    for a, b in zip(edges[:-1], edges[1:])])
    env = env / (env.max() or 1.0)
    glyphs = " .:-=+*#%@"
    print("".join(glyphs[min(int(v * (len(glyphs) - 1) + 0.5),
                             len(glyphs) - 1)] for v in env))
    return 0


if __name__ == "__main__":
    sys.exit(main())
