"""802.11 scrambler (x^7+x^4+1) — torch, vectorized (port of
``sora_tpu.dsp.scramble``).

The reference drives a byte-LUT scrambler brick through the stream
(kernel/bb/Brick11/src/scramble.hpp:9-355).  The sequence is 127-periodic,
so all 127 cyclic phases are tabulated once (a (127, 127) uint8 constant),
the row for the seed's phase is gathered and tiled.  Seed -> phase is a
127-entry table built at import from the port's own
``phy.common.scrambler_sequence``.
"""

from __future__ import annotations

import numpy as np
import torch

from sora_tpu_torch.phy import common as C

# The scrambler state cycles through all 127 nonzero seeds; the output
# sequence for any seed is a rotation of the canonical (all-ones) period.
_PERIOD = C.scrambler_sequence(127, 0x7F).astype(np.uint8)

# phase[seed] = offset o such that scrambler_sequence(n, seed) ==
# roll(period, -o)[:n]
_PHASE = np.zeros(128, dtype=np.int64)
for _seed in range(1, 128):
    first7 = C.scrambler_sequence(7, _seed)
    for _o in range(127):
        if np.array_equal(np.roll(_PERIOD, -_o)[:7], first7):
            _PHASE[_seed] = _o
            break

_PHASES_TABLE = np.stack([np.roll(_PERIOD, -o) for o in range(127)])

# seed_of_phase[o]: the inverse of _PHASE over the 127 nonzero seeds
_SEED_OF_PHASE = np.zeros(127, dtype=np.int64)
_SEED_OF_PHASE[_PHASE[1:]] = np.arange(1, 128)


def sequence(n: int, seed, device=None) -> torch.Tensor:
    """First n scrambler output bits (uint8) for a 7-bit seed (an int or a
    0-dim tensor; a tensor's device wins over ``device``)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
    phase = torch.as_tensor(_PHASE, device=device)[seed]
    row = torch.as_tensor(_PHASES_TABLE, device=device)[phase]
    reps = -(-n // 127)
    return row.repeat(reps)[:n]


def seed_from_prefix(prefix7: torch.Tensor) -> torch.Tensor:
    """Recover the seed whose first 7 outputs are prefix7 (uint8[7]).

    Used by the RX frame sink: the SERVICE field starts with 7 zero bits,
    so the first 7 descrambler inputs are the raw sequence.  Matches the
    canonical period against all 127 phases (first match wins) and maps
    phase -> seed.
    """
    tab = torch.as_tensor(_PHASES_TABLE[:, :7], device=prefix7.device)
    match = torch.all(tab == prefix7.to(torch.uint8)[None, :], dim=1)
    phase = torch.argmax(match.to(torch.uint8))
    return torch.as_tensor(_SEED_OF_PHASE, device=prefix7.device)[phase]
