"""Spectrum analyzer CLI — the speanalyzer sample's analogue
(kernel/samples/: FFT spectrum display over a live sample source; port of
``sora_tpu.apps.speanalyzer``).

Sources: a Sora dump file (raw 40 Msps, 14-bit), a saved 16-bit dump, or
a synthetic tone for self-test.  The spectrum is a Welch-averaged
periodogram computed on the device (one batched FFT over the segments),
then rendered in the terminal and optionally appended to a trace file
that ``plotview --follow`` can watch: the same producer/viewer split as
the reference's shared-memory channels.

    python -m sora_tpu_torch.apps.speanalyzer --dump tests/data/fsample54.dmp
    python -m sora_tpu_torch.apps.speanalyzer --tone 3.2e6 --msps 20

``--device cpu`` computes the spectrum on the CPU (the default is cuda).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sora_tpu_torch.util.render import chart
from sora_tpu_torch.util.xfer import resolve_device


def welch_spectrum(x: np.ndarray, nfft: int, sample_rate: float,
                   device=None):
    """Averaged Hann-windowed periodogram on ``device`` (default cuda).
    Returns (freqs_hz, power_db) as numpy arrays with DC centered."""
    dev = resolve_device(device)
    x = np.asarray(x)
    n = (len(x) // nfft) * nfft
    if n == 0:
        raise ValueError(f"need at least {nfft} samples, got {len(x)}")
    seg = torch.as_tensor(x[:n].reshape(-1, nfft).astype(np.complex64),
                          device=dev)
    hann = np.hanning(nfft)
    win = torch.as_tensor(hann.astype(np.float32), device=dev)
    p = torch.mean(torch.abs(torch.fft.fft(seg * win, dim=-1)) ** 2, dim=0)
    p = torch.fft.fftshift(p) / float(np.sum(hann ** 2) * nfft)
    pdb = 10.0 * torch.log10(p + 1e-20)
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, d=1.0 / sample_rate))
    return freqs, pdb.cpu().numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.speanalyzer",
                                description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dump", help="Sora dump file")
    src.add_argument("--tone", type=float, metavar="HZ",
                     help="synthetic tone self-test")
    p.add_argument("--msps", type=float, default=40.0)
    p.add_argument("--bits", type=int, default=14, choices=(14, 16),
                   help="dump sample format")
    p.add_argument("--nfft", type=int, default=1024)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--height", type=int, default=14)
    p.add_argument("--trace", help="append the spectrum to this trace file")
    p.add_argument("--device", default=None,
                   help="torch device of the FFT (default cuda)")
    args = p.parse_args(argv)

    fs = args.msps * 1e6
    if args.dump:
        from sora_tpu_torch.io.dumpfile import load_dump
        x = load_dump(args.dump, sign_extend_14bit=(args.bits == 14))
        x = x - x.mean()
    else:
        t = np.arange(262144)
        x = np.exp(2j * np.pi * args.tone / fs * t).astype(np.complex64)
        x += (np.random.default_rng(0).normal(size=len(t))
              + 1j * np.random.default_rng(1).normal(size=len(t))
              ).astype(np.complex64) * 0.01

    freqs, pdb = welch_spectrum(x, args.nfft, fs, device=args.device)
    pk = int(np.argmax(pdb))
    occ = freqs[pdb > pdb.max() - 6.0]
    print(chart(pdb, width=args.width, height=args.height,
                label=f"{freqs[0]/1e6:+.1f} MHz ... {freqs[-1]/1e6:+.1f} "
                      f"MHz   ({args.nfft}-pt Welch, "
                      f"{len(x)//args.nfft} segs)"))
    print(f"peak {pdb[pk]:.1f} dB @ {freqs[pk]/1e6:+.3f} MHz; "
          f"-6 dB occupancy {occ[0]/1e6:+.2f}..{occ[-1]/1e6:+.2f} MHz"
          if len(occ) else "")

    if args.trace:
        from sora_tpu_torch.util.trace import TraceWriter
        tw = TraceWriter(args.trace,
                         {"spectrum": ("spectrum", args.nfft, 64)})
        tw.plot_spectrum("spectrum", pdb)
        tw.close()
        print(f"spectrum written to {args.trace} "
              f"(view: python -m sora_tpu_torch.apps.plotview {args.trace})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
