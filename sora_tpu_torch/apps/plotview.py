"""Trace viewer CLI — the DebugPlotViewer analogue, terminal-rendered
(port of ``sora_tpu.apps.plotview``; numpy only).

Attaches a TraceReader to a trace file written by either package (the
format is shared), possibly still live, and renders its channels:
line/spectrum charts, constellation density grids, text logs.
``--follow`` polls like the reference's out-of-process GUI
(DebugTool/source/DebugPlotViewer/).

    python -m sora_tpu_torch.apps.plotview /tmp/node.trace
    python -m sora_tpu_torch.apps.plotview /tmp/node.trace --follow 0.5
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from sora_tpu_torch.util.render import chart, constellation, sparkline
from sora_tpu_torch.util.trace import TraceReader


def render_channel(rd: TraceReader, name: str, width: int,
                   history: int) -> str:
    kind = rd.kind(name)
    data = rd.read(name)
    head = f"== {name} [{kind}] =="
    if kind == "text":
        return head + "\n" + "\n".join(f"  {s}" for s in data[-history:])
    if len(data) == 0:
        return head + "\n  (empty)"
    if kind == "dots":
        pts = np.asarray(data[-history:]).reshape(-1)
        return head + "\n" + constellation(pts, width=min(width, 64))
    last = np.asarray(data[-1])
    body = chart(last, width=width,
                 label=f"record {len(data) - 1}, width {last.shape[-1]}")
    if len(data) > 1:
        hist = [sparkline(r, width=width) for r in data[-min(history, 4):-1]]
        body += "\n" + "\n".join("  prev: " + h for h in hist)
    return head + "\n" + body


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.plotview",
                                description=__doc__.split("\n")[0])
    p.add_argument("trace", help="trace file path")
    p.add_argument("--channel", action="append", default=None,
                   help="channel name(s) to show (default: all)")
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--history", type=int, default=8,
                   help="records of text/dots history to fold in")
    p.add_argument("--follow", type=float, default=0.0, metavar="SECS",
                   help="re-render every SECS seconds")
    p.add_argument("--once-if-empty", action="store_true")
    args = p.parse_args(argv)

    rd = TraceReader(args.trace)
    names = args.channel or list(rd.channels)
    for n in names:
        if n not in rd.channels:
            print(f"no channel {n!r}; have {list(rd.channels)}",
                  file=sys.stderr)
            return 2
    while True:
        blocks = [render_channel(rd, n, args.width, args.history)
                  for n in names]
        if args.follow:
            print("\x1b[2J\x1b[H", end="")
        print("\n\n".join(blocks), flush=True)
        if not args.follow:
            break
        time.sleep(args.follow)
    rd.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
