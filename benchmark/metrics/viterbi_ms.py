"""Device milliseconds of the Viterbi kernel per receiver call, by its
name (``viterbi_r4_kernel``), over the traced stretch."""

KERNEL = "viterbi_r4_kernel"


def read(st):
    k = st.kernels(KERNEL)
    return sum(d for _, _, d, _ in k) * 1e3 / st.calls if k else None
