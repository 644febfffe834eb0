"""802.11n HT-mixed, 20 MHz, 2 RX antennas, 2 spatial streams (IEEE Std
802.11-2020 cl. 19, MCS 8-15)."""

from __future__ import annotations

from benchmark.golden import dot11n_np as golden
from benchmark.golden import n_common as N

ANTENNAS = 2
# detection: onset within [0, N - BACK), first sample over the plateau
# share, PLUS samples into the STS; the LTS searched over WIDTH positions
SYNC = {"back": 900, "plus": 16, "width": 321}
CS_THRESHOLD = 0.6
RATE_FIELD = "mcs"


def modulate(psdu: bytes, mcs: int):
    return golden.modulate(psdu, mcs)


def steps(mcs: int, nbytes: int) -> int:
    """Trellis steps the frame needs: HT-SIG's 48 and the data field's."""
    ndbps = N.mcs_param(mcs).ndbps
    return 48 + -(-(16 + 8 * nbytes + 6) // ndbps) * ndbps


def entry_input(x):
    """The receiver takes (B, 2, N) streams."""
    return x


def demodulate(x):
    """The frozen golden receiver on one (2, N) stream."""
    return golden.demodulate(x)
