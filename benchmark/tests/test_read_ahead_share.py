"""The reader of ``live.read_ahead_share`` (``benchmark/metrics/
live.read_ahead_share.py``): on a hand-built log, the ``serve:read_ahead``
counts of the last ``serve_clips`` call over its ``serve:perceive``
spans, and None for a call without the count (a program whose
``serve_clips`` does not log its order); on a real call's log, 100 over a
list and 0 over a generator.  Run from the repository's root::

    python -m pytest -q benchmark/tests/test_read_ahead_share.py
"""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark import spans
from eagle_tpu_torch.utils.profiling import Record


def share(monkeypatch, records):
    monkeypatch.setattr(spans, "records", lambda: records)
    return bench_run.reader("live.read_ahead_share")(None)


@pytest.mark.parametrize("ahead,want", [((0, 1, 0, 0, 0, 1, 0, 0), 25.0), ((0,) * 8, 0.0), (None, None)])
def test_the_share_of_the_last_call(monkeypatch, ahead, want):
    """A warm-up call read ahead over each of its 4 segments, then the
    window's call of 8 segments, as ``ahead`` says: 2 of 8 read 25.0, none
    0.0 (not the warm-up's 100); a call without the count, None."""
    recs = []
    for call, orders in ((1, (1,) * 4), (2, ahead or (None,) * 8)):
        recs.append(Record("call", "serve_clips", 0, 0, 1, call, None, call, None))
        for k, order in enumerate(orders):
            recs.append(Record("span", "serve:perceive", k, k + 1, 1, len(recs) + 10, None, call, k))
            if order is not None:
                recs.append(Record("count", "serve:read_ahead", k + 1, k + 1, 1, len(recs) + 10, None, call, k, order))
    assert share(monkeypatch, recs) == want


class _Model:
    def __init__(self):
        from eagle_tpu_torch.utils.profiling import StageTimer

        self.timer, self.device = StageTimer(), "cpu"

    def prescale_clip(self, clip):
        return clip

    def get_coordinates(self, clip, fps, prescaled=None, **kw):
        return {0: clip}


class _Processor:
    def __init__(self, coords, clip, fps, **kw):
        self.clip = clip

    def process_data(self, smooth=False):
        return self.clip, {}

    def format_data(self, table):
        return [table]


@pytest.mark.parametrize("source,want", [(list, 100.0), (iter, 0.0)])
def test_the_share_of_a_served_call(monkeypatch, source, want):
    """``serve_clips(overlap=True)`` over four clips, as a list (read
    ahead) or from an iterator (the reference's order), then the reader on
    the span log."""
    from eagle_tpu_torch.pipeline import serve as serve_mod
    from eagle_tpu_torch.utils.profiling import LOG

    monkeypatch.setattr(serve_mod, "Processor", _Processor)
    assert len(list(serve_mod.serve_clips(_Model(), source(range(4)), 10, overlap=True))) == 4
    assert share(monkeypatch, LOG.records()) == want
