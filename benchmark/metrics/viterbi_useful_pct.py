"""Share of the trellis steps the Viterbi windows compute that the traced
frames need: 100 x the stretch's needed steps (as ``viterbi_roofline_pct``
counts them) over the program's ``viterbi.steps_run`` counter (rows x
windows x (block + 2 x overlap), ``sora_tpu_torch.util.spans``; on a mesh,
rank 0's rows and counter).  Nothing when the program has no such counter
or its ``rx.call`` spans number other than the stretch's calls."""


def read(st):
    try:
        from sora_tpu_torch.util import spans
    except ImportError:
        return None
    t = spans.totals()
    root = t["spans"].get("rx.call")
    run = t["counters"].get("viterbi.steps_run")
    if not root or root["calls"] != st.calls or not run or not st.steps:
        return None
    return 100.0 * st.steps / run
