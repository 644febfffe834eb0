"""Real-time-ratio profiler — the MACStopwatch analogue.
(The port's own copy of ``sora_tpu.util.stopwatch``.)

The reference's pass bar for "software radio keeps up with the air" is
per-segment processing cost / signal duration < 1.0 at the design sample
rate (kernel/bb/demod11/MACStopwatch.h:37-60,128: dReq = nSamples/40.0 us,
report average/max/SD and the fraction of segments above real time).
Same statistics here, parameterized on sample rate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class RealtimeReport:
    segments: int
    avg_ratio: float
    max_ratio: float
    sd_ratio: float
    frac_over: float          # fraction of segments with ratio > 1.0
    total_samples: int
    total_cost_s: float

    @property
    def realtime(self) -> bool:
        return self.avg_ratio < 1.0

    def __str__(self) -> str:
        return (f"ratio avg {self.avg_ratio:.3f} max {self.max_ratio:.3f} "
                f"sd {self.sd_ratio:.3f}; {self.frac_over*100:.1f}% "
                f"segments over real time "
                f"({self.segments} segments, "
                f"{self.total_samples/1e6:.2f} Msamples in "
                f"{self.total_cost_s*1e3:.1f} ms)")


class MacStopwatch:
    """Measure cost vs. required time per processed signal segment.

    >>> sw = MacStopwatch(sample_rate=20e6)
    >>> with sw.segment(n_samples=8192): process(block)
    >>> sw.report().avg_ratio
    """

    def __init__(self, sample_rate: float = 20e6):
        self.sample_rate = sample_rate
        self._ratios: list[float] = []
        self._samples = 0
        self._cost = 0.0

    class _Seg:
        def __init__(self, outer, n):
            self.outer, self.n = outer, n

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            cost = time.perf_counter() - self.t0
            req = self.n / self.outer.sample_rate
            self.outer._ratios.append(cost / req if req > 0 else 0.0)
            self.outer._samples += self.n
            self.outer._cost += cost
            return False

    def segment(self, n_samples: int) -> "_Seg":
        return self._Seg(self, n_samples)

    def add(self, n_samples: int, cost_s: float) -> None:
        req = n_samples / self.sample_rate
        self._ratios.append(cost_s / req if req > 0 else 0.0)
        self._samples += n_samples
        self._cost += cost_s

    def reset(self) -> None:
        self._ratios.clear()
        self._samples = 0
        self._cost = 0.0

    def report(self) -> RealtimeReport:
        r = self._ratios
        n = len(r)
        if n == 0:
            return RealtimeReport(0, 0.0, 0.0, 0.0, 0.0, 0, 0.0)
        avg = sum(r) / n
        var = sum((x - avg) ** 2 for x in r) / n
        return RealtimeReport(
            segments=n, avg_ratio=avg, max_ratio=max(r),
            sd_ratio=var ** 0.5,
            frac_over=sum(1 for x in r if x > 1.0) / n,
            total_samples=self._samples, total_cost_s=self._cost)
