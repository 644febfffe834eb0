"""Offline mod/demod harness — the demod11 analogue (port of
``sora_tpu.apps.demod11``).

The reference's one-exe test harness (kernel/bb/demod11/main.cpp:27-57)
exposes ``-11a/-11b/-11nbrick x -mod/-demod/-ack`` over Sora dump files;
this is the same tool over the port's chains::

  python -m sora_tpu_torch.apps.demod11 --std 11a --mode demod \\
      --chain torch --infile tests/data/fsample54.dmp
  python -m sora_tpu_torch.apps.demod11 --std 11a --mode mod --rate 54 \\
      --payload hello --outfile w.dmp
  python -m sora_tpu_torch.apps.demod11 --std 11a --mode ack

demod prints the frame's result and the MACStopwatch real-time report
(MACStopwatch.h:37-60); mod writes a dump the demod path (the port's or
the reference's) can replay (ConvertModFile2DumpFile analogue,
main.cpp:13); ack golden-compares the ACK waveform of the port's TX with
the numpy model (Test11AACK/CompareACK analogue, main.cpp:16-17).
``--chain torch`` and ``ack`` run on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

_CAPTURE = Path(__file__).resolve().parents[2] / "tests" / "data" / \
    "fsample54.dmp"


def _chains(std: str, chain: str, device=None):
    """(golden model, demodulate) of a standard on the chosen chain."""
    if std == "11a":
        from sora_tpu_torch.golden import dot11a_np as g
        from sora_tpu_torch.phy.dot11a import rx as tr
    elif std == "11b":
        from sora_tpu_torch.golden import dot11b_np as g
        from sora_tpu_torch.phy.dot11b import rx as tr
    else:
        from sora_tpu_torch.golden import dot11n_np as g
        from sora_tpu_torch.phy.dot11n import rx as tr
    if chain == "torch":
        return g, lambda x, **kw: tr.demodulate(x, device=device, **kw)
    return g, g.demodulate


def _load(path: str, msps: int, device=None) -> np.ndarray:
    from sora_tpu_torch.io.dumpfile import load_dump
    x = np.asarray(load_dump(path), dtype=np.complex128)
    x -= x.mean()
    if msps == 44:
        # 44 Msps NIC-interop capture: 10/11 resample + halfband (the
        # torch 11a chain instead takes the raw dump via input_rate="44m"
        # — the CreateDemodGraph11a_44M path)
        from sora_tpu_torch.phy import frontend as fe
        from sora_tpu_torch.util.xfer import device_complex
        return fe.ofdm_frontend_44m(device_complex(
            x[None].astype(np.complex64), device))[0].cpu().numpy()
    return x[:: msps // 20]


def run_demod(args) -> int:
    from sora_tpu_torch.util.stopwatch import MacStopwatch

    g, demod = _chains(args.std, args.chain, args.device)
    raw40 = (args.chain == "torch" and args.std == "11a"
             and args.msps in (40, 44) and not args.host_frontend)
    if args.std == "11n":
        if len(args.infile) != 2:
            print("11n demod needs two --infile dumps (one per antenna)")
            return 2
        x = np.stack([_load(f, args.msps, args.device) for f in args.infile])
    elif raw40:
        # raw dump straight to the chain: DC removal + decimation run
        # on the device (phy.frontend), like the live node's feed
        from sora_tpu_torch.io.dumpfile import load_dump
        x = load_dump(args.infile[0])
    else:
        x = _load(args.infile[0], args.msps, args.device)
    sw = MacStopwatch(sample_rate=20e6)
    n = int(x.shape[-1] // (args.msps / 20.0)) if raw40 else x.shape[-1]
    with sw.segment(n):
        res = (demod(x, input_rate=f"{args.msps}m") if raw40
               else demod(x))
    rate = getattr(res, "rate_mbps", getattr(res, "mcs", "?"))
    # the 11b result carries no byte length (the JAX harness reads one
    # and raises there): print the PSDU's
    length = getattr(res, "length", len(res.psdu))
    print(f"frame: {res.reason} rate={rate} len={length} "
          f"fcs_ok={res.fcs_ok}")
    print(sw.report())
    return 0 if res.ok else 1


def run_mod(args) -> int:
    from sora_tpu_torch.io.dumpfile import save_dump
    from sora_tpu_torch.mac.frame import build_data_frame

    g, _ = _chains(args.std, "golden")
    psdu = build_data_frame(args.payload.encode(), seq=1)
    if args.std == "11n":
        wave = g.modulate(psdu, int(args.rate))
        for i in range(2):
            save_dump(f"{args.outfile}.s{i}", np.concatenate(
                [np.zeros(64), wave[i] * args.scale]), bits=14)
        print(f"wrote {args.outfile}.s0/.s1 ({wave.shape[1]} samples/chain,"
              f" mcs {int(args.rate)})")
        return 0
    rate = float(args.rate) if args.std == "11b" else int(args.rate)
    wave = g.modulate(psdu, rate)
    n = save_dump(args.outfile,
                  np.concatenate([np.zeros(64), wave * args.scale]),
                  bits=14)
    print(f"wrote {args.outfile} ({n} samples, rate {rate})")
    return 0


def run_ack(args) -> int:
    """Golden-compare ACK waveforms: the port's TX against the numpy
    model."""
    from sora_tpu_torch.golden import dot11a_np as g
    from sora_tpu_torch.mac.frame import build_ack_frame
    from sora_tpu_torch.phy.dot11a import tx as atx
    from sora_tpu_torch.util.xfer import fetch, resolve_device, upload

    dev = resolve_device(args.device)
    ack = build_ack_frame(b"\x02\x00\x00\x00\x00\x07")
    rate = int(args.rate)
    ref = g.modulate(ack, rate)
    wav = fetch(atx.modulate(upload(np.frombuffer(ack, np.uint8)[None], dev),
                             rate, len(ack)))[0]
    err = float(np.max(np.abs(wav - ref)))
    print(f"ACK rate {rate}: {len(ref)} samples, max |torch-golden| = "
          f"{err:.2e} -> {'MATCH' if err < 2e-3 else 'MISMATCH'}")
    return 0 if err < 2e-3 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="demod11",
                                description=__doc__.splitlines()[0])
    p.add_argument("--std", choices=["11a", "11b", "11n"], default="11a")
    p.add_argument("--mode", choices=["mod", "demod", "ack"],
                   default="demod")
    p.add_argument("--chain", choices=["golden", "torch"], default="golden")
    p.add_argument("--rate", default="6",
                   help="Mbps (11a/b) or MCS index (11n)")
    p.add_argument("--infile", action="append", default=None,
                   help="input dump (twice for 11n; default the 40 Msps "
                        "54 Mbps capture tests/data/fsample54.dmp)")
    p.add_argument("--outfile", default=os.path.join(tempfile.gettempdir(),
                                                     "sora_tpu_mod.dmp"))
    p.add_argument("--payload", default="sora-tpu offline harness")
    p.add_argument("--msps", type=int, default=40, choices=[20, 40, 44],
                   help="dump sample rate (demod resamples to 20; 44 = "
                        "the commercial-NIC interop capture rate)")
    p.add_argument("--scale", type=float, default=2000.0,
                   help="TX amplitude in 14-bit dump units")
    p.add_argument("--host-frontend", action="store_true",
                   help="decimate/DC-remove on the host instead of the "
                        "on-device front end (torch 11a 40 Msps only)")
    p.add_argument("--device", default=None,
                   help="torch device of the torch chain (default cuda)")
    args = p.parse_args(argv)

    if args.mode == "demod":
        if not args.infile:
            args.infile = [str(_CAPTURE)]
        return run_demod(args)
    if args.mode == "mod":
        return run_mod(args)
    return run_ack(args)


if __name__ == "__main__":
    sys.exit(main())
