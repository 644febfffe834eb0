"""802.11b DSSS transmitter (port of ``sora_tpu.phy.dot11b.tx``).

So far only the frame-length arithmetic is ported: the streaming node
sizes its windows for all three PHYs (``runtime.node.frame_span_samples``).
The modulator itself is ROADMAP queue 1 item 9.
"""

from __future__ import annotations

from sora_tpu_torch.phy import dot11b_common as B


def waveform_len(rate_mbps: float, psdu_len: int,
                 preamble: str = "long") -> int:
    """Chips @ 11 Mcps of one frame: PLCP preamble + header, then the
    PSDU at 1 / 2 Mbps (Barker, 11 chips per symbol) or 5.5 / 11 Mbps
    (CCK, 8 chips per symbol)."""
    nbits = psdu_len * 8
    if preamble == "short":
        plcp = (B.SYNC_BITS_SHORT + 16 + 24) * 11
    else:
        plcp = (B.SYNC_BITS + 16 + 48) * 11
    if rate_mbps == 1:
        return plcp + nbits * 11
    if rate_mbps == 2:
        return plcp + (nbits // 2) * 11
    nbps = 4 if rate_mbps == 5.5 else 8
    return plcp + (nbits // nbps) * 8
