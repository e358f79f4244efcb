"""Device kernels a frame launched inside the program's ``temporal`` stage
(a captured graph's kernels each count)."""


def read(ctx):
    st = ctx.stretch
    if st is None:
        return None
    n = len(st.kernels("temporal"))
    return n / st.frames if n else None
