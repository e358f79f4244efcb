"""Device milliseconds a frame busy with operations launched inside the
program's ``temporal`` stage (the union of their intervals)."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.kernels("temporal"):
        return None
    return st.busy_s("temporal") * 1e3 / st.frames
