"""Crops the appearance network embedded a frame in the traced stretch:
the program's ``reid:crops`` counts (one an ``embed`` call: its frames
times the slots it embeds) made inside the stretch, placed on the trace's
clock, over the stretch's frames.  ``mfu`` and ``reid_mfu`` count
``reid_slots`` crops a frame; a change that embeds fewer shows here.  None
where the stretch holds no such count (a program that does not log its
crops)."""

from benchmark import spans


def read(ctx):
    st = getattr(ctx, "stretch", None)
    recs = spans.records()
    fit = spans.align(recs, st)
    if fit is None:
        return None
    lo, hi = round(st.t0 * 1e3) + fit[0], round(st.t1 * 1e3) + fit[0]
    got = [r.value for r in recs if r.kind == "count" and r.name == "reid:crops" and lo <= r.start <= hi]
    return sum(got) / st.frames if got else None
