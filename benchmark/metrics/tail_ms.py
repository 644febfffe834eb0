"""Device milliseconds per receiver call of the program's ``rx.tail`` span,
the frame tail (descramble, pack, CRC-32) and the ok and truncated
flags: its CUDA events' times summed over the traced stretch
(``sora_tpu_torch.util.spans``; on a mesh, rank 0's) over the stretch's
calls.  Nothing when the program has no such span or its ``rx.call``
spans number other than the stretch's calls."""

SPAN = "rx.tail"


def read(st):
    try:
        from sora_tpu_torch.util import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    root, stage = t.get("rx.call"), t.get(SPAN)
    if (not root or root["calls"] != st.calls or not stage
            or stage["device_ms"] is None):
        return None
    return stage["device_ms"] / st.calls
