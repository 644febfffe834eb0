"""Share of the traced window in which no operation ran on the device,
averaged over the cards of a mesh."""


def read(st):
    w = st.mean("window_s")
    return 100.0 * (1.0 - st.mean("busy_s") / w) if w > 0 else None
