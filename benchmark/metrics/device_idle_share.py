"""Share (%) of the traced stretch in which no operation ran on the card."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.ops:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s)
