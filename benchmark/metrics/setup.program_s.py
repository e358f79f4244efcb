"""Seconds of the run's set-up inside the program: its ``setup:*`` spans
in the program's span log that lie in no other ``setup:*`` span (the
checkpoints read, converted on the host and uploaded, the kernels built or
loaded, the temporal step captured).  None when the log pushed out
records, which may have held some."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    if not recs or spans.dropped():
        return None
    by_id = {r.id: r for r in recs if r.kind == "span"}

    def nested(r):
        p = by_id.get(r.parent)
        while p is not None:
            if p.name.startswith("setup:"):
                return True
            p = by_id.get(p.parent)
        return False

    got = [spans.seconds(r) for r in by_id.values() if r.name.startswith("setup:") and not nested(r)]
    return sum(got) if got else None
