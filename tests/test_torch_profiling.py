"""PyTorch port, the span log (``eagle_tpu_torch/utils/profiling.py``): a
span's thread, parent, call and request ids and its profiler range on the
main thread and on a worker thread, and the log's bound.  The serving
spans and the log against the profiler's trace: ``tests/test_torch_serve.py``."""

import threading

import pytest
import torch

from eagle_tpu_torch.utils import profiling
from eagle_tpu_torch.utils.profiling import LOG, SpanLog, StageTimer, new_call, scope


def _run(on_worker: bool, fn):
    if not on_worker:
        return fn()
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return out[0]


@pytest.mark.parametrize("on_worker", [False, True])
def test_span_carries_its_thread_parent_call_and_request(on_worker):
    """A stage with a wait span and a count inside it, in a call's scope:
    each record names the thread that made it, the span around it, the
    call and the request; only the main thread's outermost stage is a
    profiler range, and only stages add to the timer's seconds."""
    timer = StageTimer(torch.device("cpu"))
    call = new_call("probe")

    def work():
        with scope(call, 7):
            with timer("outer") as outer:
                with timer("inner"):
                    with timer.span("wait") as wait:
                        timer.count("items", 3)
            timer.record("after", outer.start, outer.end)
        with timer("loose"):
            pass
        return threading.get_ident(), outer.id, wait.id

    ident, outer_id, wait_id = _run(on_worker, work)
    recs = {r.name: r for r in LOG.records() if r.call == call or r.name == "loose" and r.thread == ident}
    assert recs["probe"].kind == "call" and recs["probe"].id == call
    assert all(r.thread == ident for r in recs.values() if r.name != "probe")
    assert (recs["outer"].parent, recs["inner"].parent, recs["wait"].parent) == (None, outer_id, recs["inner"].id)
    assert recs["items"].parent == wait_id and (recs["items"].kind, recs["items"].value) == ("count", 3)
    assert recs["after"].parent is None and (recs["after"].start, recs["after"].end) == (recs["outer"].start,
                                                                                       recs["outer"].end)
    assert {(recs[n].call, recs[n].request) for n in ("outer", "inner", "wait", "items", "after")} == {(call, 7)}
    assert (recs["loose"].call, recs["loose"].request) == (None, None)
    ranged = {n for n, r in recs.items() if r.ranged}
    assert ranged == (set() if on_worker else {"outer", "loose"})
    assert set(timer.seconds) == {"outer", "inner", "loose"} and timer.counts == {"outer": 1, "inner": 1, "loose": 1}
    assert recs["outer"].start <= recs["inner"].start <= recs["wait"].start <= recs["wait"].end <= recs["outer"].end


def test_log_keeps_the_newest_records_within_its_bound():
    """A full log pushes out its oldest record for each new one and counts
    those pushed out."""
    log = SpanLog(4)
    for i in range(6):
        log.append(profiling.Record("count", f"c{i}", i, i, 0, i, None, None, None, value=i))
    assert [r.name for r in log.records()] == ["c2", "c3", "c4", "c5"] and log.dropped == 2
    log.clear()
    assert log.records() == [] and log.dropped == 0
