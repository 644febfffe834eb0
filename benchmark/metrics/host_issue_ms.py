"""Host milliseconds from calling the receiver until it returns, without
a sync, averaged over the window's untraced calls."""


def read(st):
    return sum(st.issue_ms) / len(st.issue_ms) if st.issue_ms else None
