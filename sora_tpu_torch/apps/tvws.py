"""TV-whitespace multi-channel node — the umxistanbul analogue (port of
``sora_tpu.apps.tvws``).

The reference's TVWS variant (kernel/bb/umxistanbul/, tvws11a.hpp)
inserts a channelized front end — frequency shift + channel filter —
ahead of the standard 802.11a graph so narrow channels inside a wide
captured band can be received.  Here the channelizer is a batched device
stage (``phy.frontend.channelize``: complex mix, halfband lowpass,
decimate) and every requested channel decodes in one batch through the
mixed-rate receiver: channels become rows of the batch, so a
multi-channel band costs one Viterbi launch.

Usage::

    python -m sora_tpu_torch.apps.tvws --synthetic 8 --channels=-10e6,10e6

``--device cpu`` runs on the CPU (the default is cuda).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_band(n_frames: int, chan_offsets_hz: list[float],
               band_sps: float, seed: int = 11,
               device=None) -> tuple[np.ndarray, int]:
    """Wideband stream carrying 802.11a frames round-robin across the
    given channel offsets (each channel at 20 Msps inside the band).  The
    frames come from the golden model; the 20 Msps -> band-rate
    interpolation runs on ``device`` (default cuda)."""
    from sora_tpu_torch.golden import dot11a_np as g
    from sora_tpu_torch.mac import frame as fr
    from sora_tpu_torch.phy import frontend as fe
    from sora_tpu_torch.util.xfer import device_complex

    rng = np.random.default_rng(seed)
    up = int(round(band_sps / 20e6))
    rates = [6, 12, 24, 54]
    frames = []
    for i in range(n_frames):
        psdu = fr.build_data_frame(
            bytes(rng.integers(0, 256, 80, dtype=np.uint8)), seq=i)
        w = g.modulate(psdu, rates[i % len(rates)]).astype(np.complex64)
        frames.append(w)
    span = max(len(w) for w in frames) * up + 4000
    n = span * ((n_frames + len(chan_offsets_hz) - 1)
                // len(chan_offsets_hz) + 1)
    x = np.zeros(n, np.complex64)
    for i, w in enumerate(frames):
        ch = i % len(chan_offsets_hz)
        # upsample the 20 Msps frame to the band rate
        wb = device_complex(w[None], device)
        for _ in range(max(0, up.bit_length() - 1)):
            wb = fe.upsample2(wb)
        wb = wb[0].cpu().numpy()
        off = (i // len(chan_offsets_hz)) * span + 200 * (ch + 1)
        osc = np.exp(2j * np.pi * (chan_offsets_hz[ch] / band_sps)
                     * np.arange(len(wb))).astype(np.complex64)
        x[off: off + len(wb)] += wb * osc
    x += (rng.normal(size=n) + 1j * rng.normal(size=n)
          ).astype(np.complex64) * 0.01
    return x, n_frames


def decode_band(x: np.ndarray, chan_offsets_hz: list[float],
                band_sps: float, max_psdu: int = 256,
                n_frames_per_ch: int = 4, device=None) -> list[dict]:
    """Channelize and decode every channel of a wideband capture in one
    batched device program on ``device`` (default cuda): one
    ``rx_pipeline_auto`` call, one Viterbi launch.  Returns a list of
    per-frame dicts."""
    import torch

    from sora_tpu_torch.phy import frontend as fe
    from sora_tpu_torch.phy.dot11a import rx as arx
    from sora_tpu_torch.util.xfer import device_complex, fetch

    decim = int(round(band_sps / 20e6))
    xd = device_complex(x[None, :].astype(np.complex64), device)
    chans = [fe.channelize(xd, f / band_sps, decim=decim)
             for f in chan_offsets_hz]
    xb = torch.cat(chans, dim=0)                 # (n_chan, N/decim)
    out = fetch(arx.rx_pipeline_auto(xb, max_psdu=max_psdu,
                                     n_frames=n_frames_per_ch))
    frames = []
    K = n_frames_per_ch
    for i in np.flatnonzero(out["ok"]):
        n = int(out["length"][i])
        frames.append({
            "channel_hz": chan_offsets_hz[i // K],
            "rate_mbps": int(out["rate_mbps"][i]),
            "length": n,
            "psdu": bytes(out["psdu"][i][:n]),
            "snr_db": float(out["snr_db"][i]),
        })
    return frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.tvws",
                                description=__doc__.split("\n")[0])
    p.add_argument("--channels", default="-10e6,10e6",
                   help="comma-separated channel center offsets in Hz "
                        "(20 MHz 802.11 channels must not overlap: a "
                        "40 Msps band fits two, at +-10 MHz)")
    p.add_argument("--band-sps", type=float, default=40e6,
                   help="wideband capture sample rate")
    p.add_argument("--synthetic", type=int, default=8, metavar="N",
                   help="generate N synthetic frames across the channels")
    p.add_argument("--chunk", type=int, default=1 << 22,
                   help="band samples per decode chunk")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    offs = [float(v) for v in args.channels.split(",")]
    x, n_tx = synth_band(args.synthetic, offs, args.band_sps,
                         device=args.device)
    _log(f"band: {len(x)} samples @ {args.band_sps/1e6:.0f} Msps, "
         f"{len(offs)} channels, {n_tx} frames")
    got = 0
    for s in range(0, len(x), args.chunk):
        chunk = x[s: s + args.chunk]
        if len(chunk) < 8192:
            break
        for fme in decode_band(chunk, offs, args.band_sps,
                               device=args.device):
            got += 1
            print(f"ch {fme['channel_hz']/1e6:+6.1f} MHz  "
                  f"{fme['rate_mbps']:2d} Mbps  len {fme['length']:4d}  "
                  f"snr {fme['snr_db']:5.1f} dB")
    print(f"decoded {got}/{n_tx} frames across {len(offs)} channels")
    return 0 if got == n_tx else 1


if __name__ == "__main__":
    sys.exit(main())
