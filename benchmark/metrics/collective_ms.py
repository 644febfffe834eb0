"""Device milliseconds of the NCCL kernels per receiver call, averaged
over the cards of a mesh (the sharded cells' gathers)."""


def read(st):
    if not st.ranks or not st.mean("collective_s"):
        return None
    return 1e3 * st.mean("collective_s") / st.calls
