"""802.11a OFDM transmitter — torch, batched (port of
``sora_tpu.phy.dot11a.tx``).

Mirror of the reference mod graph (kernel/bb/demod11/fb11amod_config.hpp:
75-112: TBB11aSrc -> T11aSc -> TConvEncode -> T11aInterleave -> TMap11a ->
T11aAddPilot -> TIFFTx -> ...) as one tensor program over a batch of
PSDUs: scrambling is an XOR with the tiled periodic sequence, encoding 7
shifted XORs, puncturing and interleaving gathers, mapping a table
lookup, and the IFFT an fp32 DFT matmul.  Everything runs on the PSDU
tensor's device; the per-(rate, length) constants are made once per
device, so a call on the card copies nothing from the host.
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

_PREAMBLE = np.asarray(C.PREAMBLE_TIME, dtype=np.complex64)
_IFFT_SCALE = float(np.float32(64.0 / np.sqrt(52.0)))


def _puncture_gather(rate: C.RateParam, ncoded: int) -> np.ndarray:
    pa, pb = C.PUNCTURE[(rate.num, rate.den)]
    keep = np.stack([pa, pb], -1).reshape(-1)
    reps = -(-ncoded // len(keep))
    return np.flatnonzero(np.tile(keep, reps)[:ncoded])


def num_symbols(rate_mbps: int, psdu_len: int) -> int:
    r = C.RATES[rate_mbps]
    return -(-(16 + 8 * psdu_len + 6) // r.ndbps)


def waveform_len(rate_mbps: int, psdu_len: int) -> int:
    """Samples @20 Msps: 320 preamble + 80 SIGNAL + 80 per data symbol."""
    return 320 + 80 * (1 + num_symbols(rate_mbps, psdu_len))


def _signal_freq(rate: C.RateParam, psdu_len: int) -> np.ndarray:
    """The SIGNAL symbol's 64 frequency bins (numpy; 24 static bits,
    rate-1/2 encoded, interleaved, BPSK, pilots of polarity 0)."""
    sig = np.zeros(24, dtype=np.uint8)
    for i in range(4):
        sig[i] = (rate.rate_bits >> (3 - i)) & 1
    for i in range(12):
        sig[5 + i] = (psdu_len >> i) & 1
    sig[17] = sig[:17].sum() & 1
    sig_coded = np.zeros(48, np.uint8)
    s = 0
    for i, bit in enumerate(sig):
        sig_coded[2 * i] = C.CONV_OUT_A[s, bit]
        sig_coded[2 * i + 1] = C.CONV_OUT_B[s, bit]
        s = C.CONV_NEXT[s, bit]
    sig_inter = np.zeros(48, np.uint8)
    sig_inter[C.interleaver_permutation(48, 1)] = sig_coded
    sig_freq = np.zeros(64, np.complex64)
    sig_freq[C.DATA_BINS] = np.asarray(
        C.map_bits(sig_inter, "bpsk"), np.complex64)
    sig_freq[C.PILOT_BINS] = (C.PILOT_VAL * C.PILOT_POLARITY[0]).astype(
        np.complex64)
    return sig_freq


@lru_cache(maxsize=None)
def _tables(rate_mbps: int, psdu_len: int, scrambler_seed: int,
            device: torch.device) -> dict:
    """The constants of one (rate, length, seed) class on ``device``."""
    rate = C.RATES[rate_mbps]
    nsym = num_symbols(rate_mbps, psdu_len)
    nbits = nsym * rate.ndbps
    perm = C.interleaver_permutation(rate.ncbps, rate.nbpsc)
    pol = C.PILOT_POLARITY.astype(np.float32)[(1 + np.arange(nsym)) % 127]
    pilots = (C.PILOT_VAL.astype(np.float32)[None, :] * pol[:, None])
    t = lambda a, **kw: torch.as_tensor(np.asarray(a, **kw), device=device)
    return {
        "scr": t(dscr.sequence(nbits, scrambler_seed).numpy()),
        "punct": t(_puncture_gather(rate, 2 * nbits), dtype=np.int64),
        # the interleaver's scatter inter[perm[i]] = x[i] as a gather
        "inv_perm": t(np.argsort(perm), dtype=np.int64),
        "data_bins": t(C.DATA_BINS, dtype=np.int64),
        "pilot_bins": t(C.PILOT_BINS, dtype=np.int64),
        "pilots": t(pilots.astype(np.complex64)),
        "sig_freq": t(_signal_freq(rate, psdu_len)),
        "preamble": t(_PREAMBLE),
        "shifts": t(np.arange(8), dtype=np.uint8),
    }


def modulate(psdu: torch.Tensor, rate_mbps: int, psdu_len: int,
             scrambler_seed: int = 0x5D) -> torch.Tensor:
    """(B, psdu_len) uint8 -> (B, nsamp) complex64 @ 20 Msps, unit power,
    on the PSDU tensor's device.  All rows share one length class."""
    rate = C.RATES[rate_mbps]
    B = psdu.shape[0]
    nsym = num_symbols(rate_mbps, psdu_len)
    nbits = nsym * rate.ndbps
    k = _tables(rate_mbps, psdu_len, scrambler_seed, psdu.device)

    # --- DATA bits: SERVICE (16 zeros), PSDU bits LSB first, tail, pad -----
    pb = (psdu.to(torch.uint8)[:, :, None] >> k["shifts"]) & 1
    bits = psdu.new_zeros(B, nbits, dtype=torch.uint8)
    bits[:, 16: 16 + 8 * psdu_len] = pb.reshape(B, 8 * psdu_len)
    scrambled = bits ^ k["scr"][None, :]
    tail0 = 16 + 8 * psdu_len
    scrambled[:, tail0: tail0 + 6] = 0
    coded = dvit.encode(scrambled)                    # (B, 2*nbits)
    tx = coded[:, k["punct"]]
    inter = tx.reshape(B, nsym, rate.ncbps)[:, :, k["inv_perm"]]
    data = dmap.map_bits(inter.reshape(B, -1), rate.modulation)
    data = data.reshape(B, nsym, 48)

    # --- OFDM symbols -------------------------------------------------------
    X = torch.zeros(B, nsym + 1, 64, dtype=torch.complex64,
                    device=psdu.device)
    X[:, 0, :] = k["sig_freq"]
    X[:, 1:, k["data_bins"]] = data
    X[:, 1:, k["pilot_bins"]] = k["pilots"]
    t = dfft.ifft64(X) * _IFFT_SCALE
    syms = torch.cat([t[:, :, -16:], t], dim=-1)      # add GI
    return torch.cat([k["preamble"].expand(B, 320), syms.reshape(B, -1)],
                     dim=-1)
