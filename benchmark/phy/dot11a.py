"""802.11a OFDM, 20 MHz, one antenna (IEEE Std 802.11-2020 cl. 17)."""

from __future__ import annotations

import numpy as np

from benchmark.golden import common as C
from benchmark.golden import dot11a_np as golden

ANTENNAS = 1
# detection: onset within [0, N - BACK), first sample at or over the
# plateau share (single frame), the LTS searched over WIDTH positions
SYNC = {"back": 480, "plus": 0, "width": 512}
CS_THRESHOLD = 0.6
RATE_FIELD = "rate_mbps"


def modulate(psdu: bytes, rate_mbps: int) -> np.ndarray:
    return golden.modulate(psdu, rate_mbps)[None, :]


def steps(rate_mbps: int, nbytes: int) -> int:
    """Trellis steps the frame's data field needs: its symbols' bits."""
    ndbps = C.RATES[rate_mbps].ndbps
    return -(-(16 + 8 * nbytes + 6) // ndbps) * ndbps


def entry_input(x):
    """The receiver takes (B, N) streams."""
    return x[:, 0]


def demodulate(x: np.ndarray):
    """The frozen golden receiver on one (1, N) stream."""
    return golden.demodulate(x[0])
