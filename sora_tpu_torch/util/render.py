"""Terminal rendering for trace channels: sparklines, charts,
constellation density grids.
(The port's own copy of ``sora_tpu.util.render``.)

The reference ships a 34.7 kLoC MFC GUI (DebugPlotViewer) for its shared
memory channels; this framework's viewer is terminal-first — the same
oscilloscope/constellation/spectrum panes as unicode block graphics, so a
trace is inspectable over ssh next to the running node.
"""

from __future__ import annotations

import numpy as np

_BLOCKS = " ▁▂▃▄▅▆▇█"
_SHADES = " .:-=+*#%@"


def _resample_max(v: np.ndarray, width: int) -> np.ndarray:
    """Downsample to `width` columns keeping per-bucket maxima (peaks must
    survive, e.g. spectrum spurs)."""
    v = np.asarray(v, dtype=np.float64).reshape(-1)
    if len(v) <= width:
        return v
    edges = np.linspace(0, len(v), width + 1).astype(int)
    return np.array([v[a:b].max() if b > a else v[min(a, len(v) - 1)]
                     for a, b in zip(edges[:-1], edges[1:])])


def sparkline(values, width: int = 80, lo: float | None = None,
              hi: float | None = None) -> str:
    """One-line block-character chart."""
    v = _resample_max(values, width)
    lo = float(np.min(v)) if lo is None else lo
    hi = float(np.max(v)) if hi is None else hi
    rng = hi - lo if hi > lo else 1.0
    idx = np.clip(((v - lo) / rng) * (len(_BLOCKS) - 1), 0,
                  len(_BLOCKS) - 1).astype(int)
    return "".join(_BLOCKS[i] for i in idx)


def chart(values, width: int = 80, height: int = 12,
          lo: float | None = None, hi: float | None = None,
          label: str = "") -> str:
    """Multi-row column chart with a numeric axis."""
    v = _resample_max(values, width)
    lo = float(np.min(v)) if lo is None else lo
    hi = float(np.max(v)) if hi is None else hi
    rng = hi - lo if hi > lo else 1.0
    levels = np.clip((v - lo) / rng * height, 0, height)
    lines = []
    for row in range(height, 0, -1):
        cells = []
        for lv in levels:
            if lv >= row:
                cells.append("█")
            elif lv > row - 1:
                frac = lv - (row - 1)
                cells.append(_BLOCKS[int(frac * (len(_BLOCKS) - 1))])
            else:
                cells.append(" ")
        prefix = f"{hi:9.1f} |" if row == height else (
            f"{lo:9.1f} |" if row == 1 else " " * 9 + " |")
        lines.append(prefix + "".join(cells))
    if label:
        lines.append(" " * 10 + label)
    return "\n".join(lines)


def constellation(points, width: int = 48, height: int = 24,
                  span: float | None = None) -> str:
    """ASCII density grid of complex points (PlotDots pane)."""
    p = np.asarray(points, dtype=np.complex64).reshape(-1)
    p = p[np.abs(p) > 0]
    if len(p) == 0:
        return "(no points)"
    if span is None:
        span = float(np.percentile(np.abs(np.concatenate(
            [p.real, p.imag])), 99)) * 1.3 + 1e-9
    xi = np.clip(((p.real / span) + 1) / 2 * (width - 1), 0,
                 width - 1).astype(int)
    yi = np.clip(((-p.imag / span) + 1) / 2 * (height - 1), 0,
                 height - 1).astype(int)
    grid = np.zeros((height, width), np.int64)
    np.add.at(grid, (yi, xi), 1)
    mx = grid.max()
    lines = []
    for r in range(height):
        line = "".join(
            _SHADES[min(int(np.ceil(g / mx * (len(_SHADES) - 1))),
                        len(_SHADES) - 1)] if g else
            ("+" if (r == height // 2) else
             ("|" if False else " "))
            for g in grid[r])
        if r == height // 2:
            line = "".join(ch if ch != " " else "-" for ch in line)
        lines.append(line)
    # vertical axis
    mid = width // 2
    lines = [ln[:mid] + ("|" if ln[mid] in " -" else ln[mid]) + ln[mid + 1:]
             for ln in lines]
    return "\n".join(lines) + f"\n(span ±{span:.2f}, {len(p)} pts)"
