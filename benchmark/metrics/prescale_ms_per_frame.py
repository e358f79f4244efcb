"""Host milliseconds a frame in the program's ``prescale`` stage (its
``stage:prescale`` ranges in the traced stretch): the upload of the frames
the prefetch worker prescaled."""


def read(ctx):
    st = ctx.stretch
    if st is None or "prescale" not in st.ranges:
        return None
    return st.host_s("prescale") * 1e3 / st.frames
