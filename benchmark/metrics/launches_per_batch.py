"""Device kernels per receiver call, its fetch included: every kernel of
the traced stretch (which starts and ends drained) over its calls."""


def read(st):
    return len(st.kernels()) / st.calls if st.calls else None
