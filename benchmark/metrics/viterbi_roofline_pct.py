"""The Viterbi kernel's share of its roofline: the least time for the
trellis steps the traced calls' frames need (``benchmark.roofline``) over
the kernel's measured time."""

from benchmark import roofline

KERNEL = "viterbi_r4_kernel"


def read(st):
    t = sum(d for _, _, d, _ in st.kernels(KERNEL))
    if not t or not st.steps:
        return None
    return 100.0 * roofline.viterbi_least_time(st.steps) / t
