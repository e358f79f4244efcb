"""The hand-written flow kernel's share (%) of its roofline: its launches'
least time at the published peaks (``benchmark.work.lk_flow``, the still
camera's visible landmarks, no Newton step counted) over their traced
device time."""

import re

KERNEL = re.compile(r"lk_flow")


def read(ctx):
    st = ctx.stretch
    ks = [k for k in st.kernels() if KERNEL.search(k["name"])] if st is not None else []
    if not ks:
        return None
    return 100.0 * len(ks) * ctx.flow_least_s / (sum(k["end"] - k["start"] for k in ks) / 1e6)
