"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
run of receiver calls in the middle of the window, read back from its
Chrome trace into device intervals, kernel times and host activity.

The stretch starts and ends with the card drained, so every device
operation in it belongs to its calls (and their fetches); the window
read is the benchmark's own ``bench.window`` span around it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "bench.window"
NAME = 160            # characters of a kernel's name kept in the breakdown


@dataclass
class Stretch:
    """What the traced stretch saw; times in seconds."""

    calls: int                       # receiver calls issued in it
    steps: int                       # trellis steps their frames need
    window: tuple                    # (start, end) of the bench.window span
    device: list                     # (name, start, dur, cat) device ops
    host: list                       # (name, start, dur) host events
    issue_ms: list = field(default_factory=list)   # untraced calls
    # every rank's own() on a mesh (this rank's first); None on one chip
    ranks: list | None = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, needle: str = ""):
        return [d for d in self.device
                if d[3] == "kernel" and needle in d[0]]

    def busy_intervals(self):
        """Merged device-busy intervals clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d, _ in self.device
                       if s + d > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def own(self) -> dict:
        """This rank's device numbers, as ranks post them to rank 0."""
        coll = sum(d for n, _, d, _ in self.kernels() if "nccl" in
                   n.lower())
        return {"busy_s": self.busy_s(), "window_s": self.window_s,
                "collective_s": coll, "calls": self.calls}

    def mean(self, key: str) -> float:
        """Mean over the ranks of one of own()'s numbers."""
        rows = self.ranks or [self.own()]
        return sum(r[key] for r in rows) / len(rows)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between them by what the host was doing at each gap's middle."""
        ops = {}
        for name, _, dur, _ in self.device:
            ops[name[:NAME]] = ops.get(name[:NAME], 0.0) + dur
        gaps = {}
        self._index_host()
        busy = self.busy_intervals()
        edges = ([self.window[0]] + [v for s, e in busy for v in (s, e)]
                 + [self.window[1]])
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                label = self.host_at((s + e) / 2)
                gaps[label] = gaps.get(label, 0.0) + (e - s)
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in rank(ops)],
                "idle_gaps": [[k, v] for k, v in rank(gaps)]}

    def _index_host(self):
        self._short = sorted((s, d, n) for n, s, d in self.host
                             if not n.startswith("bench."))
        self._starts = [e[0] for e in self._short]
        self._spans = [(s, d, n) for n, s, d in self.host
                       if n.startswith("bench.") and n != WINDOW]

    def host_at(self, t: float, scan: int = 64) -> str:
        """The innermost host event running at time t: among the ``scan``
        latest-starting operations before t, else the benchmark's own
        spans (``bench.rx_call``, ``bench.fetch``)."""
        best = None
        i = bisect.bisect_right(self._starts, t)
        for s, d, n in reversed(self._short[max(0, i - scan): i]):
            if t <= s + d and (best is None or d < best[1]):
                best = (n, d)
        if best is None:
            for s, d, n in self._spans:
                if s <= t <= s + d:
                    best = (n, d)
        return best[0] if best else "host (no traced op)"


def read_chrome_trace(path: str):
    """(device ops, host events, bench.window span) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, s, d, cat))
        elif cat in HOST_CATS:
            host.append((name, s, d))
            if name == WINDOW:
                window = (s, s + d)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    return device, host, window


def profile(run_calls, calls: int):
    """Run ``run_calls(calls)`` (which drains the card at both ends) under
    torch.profiler inside a bench.window span; returns its device ops,
    host events and window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run_calls(calls)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)
    finally:
        os.unlink(path)
