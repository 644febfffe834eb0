"""Sensitivity waterfall: FER/BER vs SNR for every PHY, emitted as
markdown (port of the repository's ``tools/sensitivity_sweep.py``).

The reference's test strategy is loopback sweeps across the operating
region (SURVEY §4.2: mod -> impairment -> demod BER/CRC); this tool is
that sweep: for each 11a rate, each 11b rate (long + short preamble at
2/5.5/11), and a spread of 11n MCS, modulate a batch of frames with the
port's golden models, add calibrated AWGN from numpy (the same seeds and
draws as the reference tool, so the same noisy input), decode with the
port's receivers on ``--device`` (default cuda), and tabulate frame-error
rate and payload BER per SNR point.  Each 11a receiver call launches the
Viterbi kernel once, each 11n call twice (HT-SIG and data); 11b reaches
no Viterbi.

    python3 -m sora_tpu_torch.tools.sensitivity_sweep > sweep.md
    python3 -m sora_tpu_torch.tools.sensitivity_sweep --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sora_tpu_torch.golden import dot11a_np as ga
from sora_tpu_torch.golden import dot11b_np as gb
from sora_tpu_torch.golden import dot11n_np as gn
from sora_tpu_torch.mac import frame as fr
from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy.dot11a import rx as arx
from sora_tpu_torch.phy.dot11b import rx as brx
from sora_tpu_torch.phy.dot11n import rx as nrx
from sora_tpu_torch.runtime.radio import REF_TAPS
from sora_tpu_torch.util.xfer import fetch, resolve_device

A_RATES = tuple(sorted(C.RATES))
B_SPECS = ((1, "long"), (2, "long"), (5.5, "long"), (11, "long"),
           (2, "short"), (5.5, "short"), (11, "short"))
# the default grid (the reference tool's main)
SNRS_A = [0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30]
SNRS_B = [-2, 0, 2, 4, 6, 8, 10, 12]
SNRS_N = [6, 9, 12, 15, 18, 21, 24, 27, 30, 33]
SNRS_AM = [12, 15, 18, 21, 24, 27, 30, 33]
SNRS_NM = [12, 15, 18, 21, 24, 27, 30, 33, 36, 39]


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _ber(psdus, out, n_frames):
    errs = bits = 0
    got = out["psdu"]
    for i, p in enumerate(psdus):
        ref = np.frombuffer(p, np.uint8)
        dec = got[i][: len(ref)]
        errs += int(np.unpackbits(dec ^ ref).sum())
        bits += 8 * len(ref)
    return errs / max(1, bits)


def _frames(rng, n, payload, seq0=0):
    return [fr.build_data_frame(bytes(rng.integers(0, 256, payload,
                                                   dtype=np.uint8)),
                                seq=seq0 + i) for i in range(n)]


def _noisy(x, sig_p, snr_db, rng):
    sigma = np.sqrt(sig_p / (2.0 * 10 ** (snr_db / 10.0)))
    return (x + sigma * (rng.normal(size=x.shape)
                         + 1j * rng.normal(size=x.shape))
            ).astype(np.complex64)


def _point(snr, out, psdus, n):
    out = fetch(out)
    return snr, 1.0 - float(out["ok"].sum()) / n, _ber(psdus, out, n)


def sweep_11a(snrs, n=16, payload=72, seed=11, rates=A_RATES, device=None):
    dev = resolve_device(device)
    rows = {}
    for rate in rates:
        rng = np.random.default_rng(seed + rate)
        psdus = _frames(rng, n, payload)
        waves = [ga.modulate(p, rate).astype(np.complex64) for p in psdus]
        N = max(len(w) for w in waves) + 300
        x = np.zeros((n, N), np.complex64)
        for i, w in enumerate(waves):
            x[i, 40: 40 + len(w)] = w
        sig_p = float(np.mean([np.mean(np.abs(w) ** 2) for w in waves]))
        pts = []
        for snr in snrs:
            xd = torch.as_tensor(_noisy(x, sig_p, snr, rng), device=dev)
            pts.append(_point(snr, arx.rx_pipeline(xd, rate, max_psdu=128),
                              psdus, n))
        rows[f"{rate} Mbps"] = pts
        _log(f"11a {rate:>4} Mbps done")
    return rows


def sweep_11b(snrs, n=12, payload=48, seed=23, device=None):
    dev = resolve_device(device)
    rows = {}
    for rate, pre in B_SPECS:
        rng = np.random.default_rng(seed + int(2 * rate)
                                    + (100 if pre == "short" else 0))
        psdus = _frames(rng, n, payload)
        waves = [gb.modulate(p, rate, preamble=pre).astype(np.complex64)
                 for p in psdus]
        N = max(len(w) for w in waves) + 400
        x = np.zeros((n, N), np.complex64)
        for i, w in enumerate(waves):
            x[i, 50: 50 + len(w)] = w
        sig_p = float(np.mean([np.mean(np.abs(w) ** 2) for w in waves]))
        pts = []
        for snr in snrs:
            xd = torch.as_tensor(_noisy(x, sig_p, snr, rng), device=dev)
            pts.append(_point(snr, brx.rx_pipeline_auto(
                xd, max_psdu=len(psdus[0])), psdus, n))
        rows[f"{rate} Mbps {pre}"] = pts
        _log(f"11b {rate} {pre} done")
    return rows


def sweep_11n(snrs, mcs_list=(0, 4, 7, 8, 11, 15), n=10, payload=72,
              seed=31, device=None):
    dev = resolve_device(device)
    rows = {}
    for mcs in mcs_list:
        rng = np.random.default_rng(seed + mcs)
        psdus = _frames(rng, n, payload)
        waves = [np.asarray(gn.modulate(p, mcs)) for p in psdus]
        one_ss = waves[0].shape[0] == 1
        N = max(w.shape[1] for w in waves) + 300
        x = np.zeros((n, 2, N), np.complex64)
        for i, w in enumerate(waves):
            # 1-stream TX reaches both RX antennas (unit SIMO channel)
            x[i, :, 40: 40 + w.shape[1]] = w if not one_ss else w[0]
        sig_p = float(np.mean([np.mean(np.abs(w) ** 2) for w in waves]))
        pipe = nrx.rx_pipeline_1ss if one_ss else nrx.rx_pipeline
        pts = []
        for snr in snrs:
            xd = torch.as_tensor(_noisy(x, sig_p, snr, rng), device=dev)
            pts.append(_point(snr, pipe(xd, mcs, max_psdu=128), psdus, n))
        rows[f"MCS {mcs}" + (" (1ss)" if one_ss else "")] = pts
        _log(f"11n MCS {mcs} done")
    return rows


def _multipath_2x2(v, ch):
    """4-tap in-CP frequency-selective 2x2 channel: per-tap random
    complex mixing (the test_channel model, exercised chain-level)."""
    out = np.zeros((2, v.shape[1] + 12), np.complex64)
    for delay, p in zip((0, 3, 7, 12), (1.0, 0.5, 0.25, 0.12)):
        H = (ch.normal(size=(2, 2)) + 1j * ch.normal(size=(2, 2))
             ).astype(np.complex64) * np.sqrt(p / 2.0)
        out[:, delay: delay + v.shape[1]] += H @ v
    return out


def sweep_11n_mixed(snrs, mcs_list=(12, 15), n=16, payload=72, seed=47,
                    device=None):
    """High-MCS 2x2 rows under per-frame frequency-selective Rayleigh
    multipath — the regime where the MMSE + per-subcarrier LLR-weighted
    receiver beats the reference's equal-weight ZF
    (channel_11n.hpp:426-445 + dsp_demap.h).  Same channels and noise for
    both receivers."""
    dev = resolve_device(device)
    rows = {}
    for mcs in mcs_list:
        rng = np.random.default_rng(seed + mcs)
        psdus = _frames(rng, n, payload)
        waves = [np.asarray(gn.modulate(p, mcs)) for p in psdus]
        N = max(w.shape[1] for w in waves) + 320
        x = np.zeros((n, 2, N), np.complex64)
        ch = np.random.default_rng(seed * 7 + mcs)
        for i, w in enumerate(waves):
            m = _multipath_2x2(w, ch)
            x[i, :, 40: 40 + m.shape[1]] = m
        sig_p = float(np.mean(np.abs(x) ** 2) * N / (N - 320))
        for name, kw in ((f"MCS {mcs} MMSE+wgt", {}),
                         (f"MCS {mcs} plain ZF (ref)",
                          {"mmse": False, "weighted": False})):
            pts = []
            for snr in snrs:
                rng_n = np.random.default_rng(1000 + mcs + int(snr))
                xd = torch.as_tensor(_noisy(x, sig_p, snr, rng_n),
                                     device=dev)
                pts.append(_point(snr, nrx.rx_pipeline(
                    xd, mcs, max_psdu=128, **kw), psdus, n))
            rows[name] = pts
        _log(f"11n mixed MCS {mcs} done")
    return rows


def sweep_11a_multipath(snrs, rates=(24, 54), n=16, payload=72, seed=61,
                        device=None):
    """11a rows under a fixed 4-tap in-CP channel: the per-subcarrier
    |H|^2 LLR weighting vs the reference-parity equal-weight demap
    (dsp_demap.h).  Same channel and noise for both receivers; each SNR
    point is two ``decode_data`` calls (two Viterbi launches)."""
    dev = resolve_device(device)
    rows = {}
    for rate in rates:
        rng = np.random.default_rng(seed + rate)
        psdus = _frames(rng, n, payload)
        waves = [ga.modulate(p, rate).astype(np.complex64) for p in psdus]
        N = max(len(w) for w in waves) + 320
        x = np.zeros((n, N), np.complex64)
        for i, w in enumerate(waves):
            y = np.zeros(len(w) + 12, np.complex128)
            for d, c in REF_TAPS:
                y[d: d + len(w)] += c * w
            x[i, 40: 40 + len(y)] = y
        sig_p = float(np.mean(np.abs(x) ** 2) * N / (N - 320))
        nsym = arx.max_symbols(C.RATES[rate], 128)
        L = torch.full((n,), len(psdus[0]), dtype=torch.int32, device=dev)
        pts_w, pts_u = [], []
        for snr in snrs:
            rng_n = np.random.default_rng(3000 + rate + int(snr))
            xn = torch.as_tensor(_noisy(x, sig_p, snr, rng_n), device=dev)
            lts1, cfo, _ = arx.synchronize(xn)
            eq, _, wgt = arx.extract_symbols(xn, lts1, cfo, nsym,
                                             return_weights=True)
            _, fw, _ = arx.decode_data(eq[:, 1:, :], L, rate, wgt)
            _, fu, _ = arx.decode_data(eq[:, 1:, :], L, rate)
            pts_w.append((snr, 1.0 - float(fetch(fw).sum()) / n, 0))
            pts_u.append((snr, 1.0 - float(fetch(fu).sum()) / n, 0))
        rows[f"{rate} Mbps Hsq-weighted"] = pts_w
        rows[f"{rate} Mbps equal-weight (ref)"] = pts_u
        _log(f"11a multipath {rate} done")
    return rows


def _table(title, rows, snrs):
    out = [f"\n## {title}\n"]
    out.append("| mode | " + " | ".join(f"{s:g} dB" for s in snrs) + " |")
    out.append("|---|" + "---|" * len(snrs))
    for name, pts in rows.items():
        cells = []
        for snr, fer, ber in pts:
            if fer == 0.0:
                cells.append("ok" if ber == 0 else f"ber {ber:.0e}")
            elif fer == 1.0:
                cells.append("fail")
            else:
                cells.append(f"fer {fer:.2f}")
        out.append(f"| {name} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.tools.sensitivity_sweep",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device of the receivers (default cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    print("# Sensitivity waterfall (loopback, AWGN)\n")
    print("Generated by `python3 -m sora_tpu_torch.tools.sensitivity_sweep`")
    print(f"on {dev} — FER/BER vs SNR for the port's RX chains; `ok` = every")
    print("frame FCS-clean at that point, `ber` = residual payload bit")
    print("errors, `fail` = no frame survived.  Reference test model: the")
    print("mod->AWGN->demod loopback sweeps of SURVEY §4.2.")
    a = sweep_11a(SNRS_A, device=dev)
    print(_table("802.11a (20 Msps OFDM)", a, SNRS_A))
    b = sweep_11b(SNRS_B, device=dev)
    print(_table("802.11b (11 Msps DSSS/CCK, long + short preamble)",
                 b, SNRS_B))
    nn = sweep_11n(SNRS_N, device=dev)
    print(_table("802.11n (2x2 MIMO, MMSE detection)", nn, SNRS_N))
    am = sweep_11a_multipath(SNRS_AM, device=dev)
    print(_table("802.11a under a fixed 4-tap in-CP channel "
                 "(per-subcarrier LLR weighting vs the reference's "
                 "equal-weight demap)", am, SNRS_AM))
    nm = sweep_11n_mixed(SNRS_NM, device=dev)
    print(_table("802.11n 2x2 under frequency-selective Rayleigh "
                 "multipath (MMSE+LLR-weight vs the reference's "
                 "equal-weight ZF)", nm, SNRS_NM))
    print("\nExpected structure: waterfall position ordered by modulation")
    print("order and code rate within each PHY; the short-preamble rows")
    print("match their long-preamble siblings (the data section is")
    print("identical, only the PLCP differs).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
