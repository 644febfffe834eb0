"""802.11n HT transmitter — torch, batched (port of
``sora_tpu.phy.dot11n.tx``: 2x2 MCS 8-15 and single-stream MCS 0-7,
long or short guard interval).

Mirror of the reference 11n mod graph (fb11nmod_config.hpp; bricks
TBB11nSrc -> scramble -> encode -> TStreamParser -> T11nInterleave*_S0/S1
-> TSigMap11n/T11nAddPilot -> TCSD -> IFFT, preambles LSrc/HTSrc,
preamble11n.hpp) as one tensor program over a batch of PSDUs: the stream
parser and each stream's interleaver fold into one gather per stream
(the JAX package's ``.at[].set`` scatters become that gather), the cyclic
shift is a frequency-domain phasor, and both streams IFFT together as one
fp32 DFT matmul.

The preamble depends only on (mcs, psdu_len, short_gi), so it is computed
once in float64 (``phy.dot11n.preamble``) and kept as a complex64
constant on the PSDU tensor's device, with the other per-class tables.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sora_tpu_torch.dsp import fft as dfft
from sora_tpu_torch.dsp import mapping as dmap
from sora_tpu_torch.dsp import scramble as dscr
from sora_tpu_torch.dsp import viterbi as dvit
from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy import dot11n_common as N
from sora_tpu_torch.phy.dot11n import preamble as P

_SCALE_2SS = float(np.float32(64.0 / np.sqrt(56.0) / np.sqrt(2.0)))
_SCALE_1SS = float(np.float32(64.0 / np.sqrt(56.0)))


def num_symbols(mcs: int, psdu_len: int) -> int:
    return -(-(16 + 8 * psdu_len + 6) // N.mcs_param(mcs).ndbps)


def waveform_len(mcs: int, psdu_len: int, short_gi: bool = False) -> int:
    """Samples @20 Msps: preamble(+SIGs) + (64+gi) per data symbol (720
    preamble for single-stream MCS 0-7 — one HT-LTF; 800 for 2-stream
    MCS 8-15; gi = 8 with ``short_gi``)."""
    pre = 720 if mcs in N.MCS1 else 800
    return pre + (72 if short_gi else 80) * num_symbols(mcs, psdu_len)


@lru_cache(maxsize=None)
def _preamble_const(mcs: int, psdu_len: int,
                    short_gi: bool = False) -> np.ndarray:
    """(2, 800) complex64: everything before the first data symbol."""
    return P.preamble_2ss(mcs, psdu_len, num_symbols(mcs, psdu_len),
                          short_gi).astype(np.complex64)


def _puncture_gather(m: N.McsParam, ncoded: int) -> np.ndarray:
    pa, pb = N.puncture_pattern(m.num, m.den)
    keep = np.stack([pa, pb], -1).reshape(-1)
    reps = -(-ncoded // len(keep))
    return np.flatnonzero(np.tile(keep, reps)[:ncoded])


@lru_cache(maxsize=None)
def _pilot_table(nsym: int) -> np.ndarray:
    """(nsym, 2, 4) float32 pilot values per data symbol and stream."""
    k = np.arange(nsym)
    pol = C.PILOT_POLARITY[(3 + k) % 127]                    # (nsym,)
    psi = N.PSI2[:, ((np.arange(4)[None, :] + k[:, None]) % 4)]
    # psi: (2, nsym, 4) -> (nsym, 2, 4)
    return (np.transpose(psi, (1, 0, 2))
            * pol[:, None, None]).astype(np.float32)


@lru_cache(maxsize=None)
def _csd_phasor() -> np.ndarray:
    """(2, 64) frequency-domain HT cyclic-shift phasor per stream."""
    f = np.ones((2, 64), np.complex64)
    for i in range(2):
        f[i, N.HT_OCC_BINS] = np.exp(
            -2j * np.pi * N.HT_SC_IDX * N.CSD_HT[i] / N.NFFT)
    return f


@lru_cache(maxsize=None)
def _preamble_const_1ss(mcs: int, psdu_len: int,
                        short_gi: bool = False) -> np.ndarray:
    """(720,) complex64 single-chain preamble."""
    return P._preamble_1ss(mcs, psdu_len, num_symbols(mcs, psdu_len),
                           short_gi).astype(np.complex64)


@lru_cache(maxsize=None)
def _pilot_table_1ss(nsym: int) -> np.ndarray:
    """(nsym, 4) float32 pilot values per data symbol, Nsts = 1
    (PSI1 rotation x polarity, eq 20-59)."""
    k = np.arange(nsym)
    return (N.PSI1[(np.arange(4)[None, :] + k[:, None]) % 4]
            * C.PILOT_POLARITY[(3 + k) % 127][:, None]).astype(np.float32)


@lru_cache(maxsize=None)
def _tables(mcs: int, psdu_len: int, scrambler_seed: int, short_gi: bool,
            device: torch.device) -> dict:
    """The constants of one (mcs, length, seed, guard) class on
    ``device``.  ``gather`` row i holds, for stream i's interleaved bit k,
    the position in the symbol's coded block it carries: the stream
    parser's index composed with the inverse of the stream's HT
    interleaver (the JAX package scatters inter[perm[k]] = sbits[k])."""
    m = N.mcs_param(mcs)
    nsym = num_symbols(mcs, psdu_len)
    nbits = nsym * m.ndbps
    if m.nss == 1:
        sp = np.arange(m.ncbpss)[None]
        pil = _pilot_table_1ss(nsym)[:, None, :]             # (nsym, 1, 4)
        pre = _preamble_const_1ss(mcs, psdu_len, short_gi)[None]
        csd = None                                 # one chain: no CSD
    else:
        sp = N.stream_parse_indices(2 * m.ncbpss, m.nbpsc)   # (2, ncbpss)
        pil = _pilot_table(nsym)
        pre = _preamble_const(mcs, psdu_len, short_gi)
        csd = _csd_phasor()
    gather = np.stack([sp[i][np.argsort(N.ht_interleaver_permutation(
        m.nbpsc, i))] for i in range(m.nss)])
    t = lambda a, **kw: torch.as_tensor(np.asarray(a, **kw), device=device)
    return {
        "scr": t(dscr.sequence(nbits, scrambler_seed).numpy()),
        "punct": t(_puncture_gather(m, 2 * nbits), dtype=np.int64),
        "gather": t(gather, dtype=np.int64),
        "data_bins": t(N.HT_DATA_BINS, dtype=np.int64),
        "pilot_bins": t(N.HT_PILOT_BINS, dtype=np.int64),
        "pilots": t(pil.astype(np.complex64)),
        "csd": None if csd is None else t(csd),
        "preamble": t(pre),
        "shifts": t(np.arange(8), dtype=np.uint8),
    }


def modulate(psdu: torch.Tensor, mcs: int, psdu_len: int,
             scrambler_seed: int = 0x5D,
             short_gi: bool = False) -> torch.Tensor:
    """(B, psdu_len) uint8 -> (B, nss_tx, nsamp) complex64: one 20 Msps
    waveform per TX chain ((B, 2, n) for MCS 8-15, (B, 1, n) for the
    single-stream MCS 0-7), on the PSDU tensor's device.  ``short_gi`` =
    400 ns data-symbol guard.  All rows share one length class."""
    m = N.mcs_param(mcs)
    B = psdu.shape[0]
    nsym = num_symbols(mcs, psdu_len)
    nbits = nsym * m.ndbps
    k = _tables(mcs, psdu_len, scrambler_seed, bool(short_gi), psdu.device)

    pb = (psdu.to(torch.uint8)[:, :, None] >> k["shifts"]) & 1
    bits = psdu.new_zeros(B, nbits, dtype=torch.uint8)
    bits[:, 16: 16 + 8 * psdu_len] = pb.reshape(B, 8 * psdu_len)
    scrambled = bits ^ k["scr"][None, :]
    tail0 = 16 + 8 * psdu_len
    scrambled[:, tail0: tail0 + 6] = 0
    coded = dvit.encode(scrambled)
    blocks = coded[:, k["punct"]].reshape(B, nsym, m.nss * m.ncbpss)
    inter = blocks[:, :, k["gather"]]                  # (B, nsym, nss, ncbpss)
    data = dmap.map_bits(inter.reshape(B, nsym, m.nss, -1), m.modulation)

    X = torch.zeros(B, nsym, m.nss, 64, dtype=torch.complex64,
                    device=psdu.device)
    X[..., k["data_bins"]] = data
    X[..., k["pilot_bins"]] = k["pilots"]
    if k["csd"] is not None:
        X = X * k["csd"]
    gi = 8 if short_gi else 16
    t = dfft.ifft64(X) * (_SCALE_1SS if m.nss == 1 else _SCALE_2SS)
    syms = torch.cat([t[..., -gi:], t], dim=-1)       # GI
    body = syms.transpose(1, 2).reshape(B, m.nss, nsym * (64 + gi))
    pre = k["preamble"].expand(B, -1, -1)
    return torch.cat([pre, body], dim=-1)
