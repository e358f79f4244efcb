"""Clip-pipelined serving (counterpart of ``eagle_tpu/pipeline/serve.py``):
over a backlog of clips, the Processor of clip k runs while clip k+1's
perception runs; over clips that come as they come, each clip's result is
out as soon as its Processor job ends.

The reference runs its stages strictly in sequence per video:
``get_coordinates``, then ``Processor.process_data``, then
``format_data``.  Perception keeps the card busy and the host mostly
waits on it; the Processor is mostly host work.  Running clip k's
Processor on a worker thread while the main thread runs clip k+1's
perception, and prescaling clip k+1 on a second worker during clip k's,
lets a backlog of clips approach max(device time, host time) a clip
instead of their sum.  That order asks for clip k+1 before perceiving
clip k and yields clip k only after perceiving clip k+1, so from a live
feed every result would wait for the next clip to arrive and be
perceived.  :func:`serve_clips` therefore reads ahead only over clips
that are all there already, which it sees in their having a length.  The
results equal the sequential ones exactly.
"""

from __future__ import annotations

import time
from collections.abc import Sized
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

from eagle_tpu_torch.pipeline.processor import Processor, Table
from eagle_tpu_torch.utils.profiling import new_call, scope


class ClipResult(NamedTuple):
    """What the reference CLI derives from one clip."""

    coordinates: dict  # get_coordinates' output ({frame: {...}})
    table: Table  # the wide per-frame table (process_data)
    team_mapping: dict  # player id -> team
    formatted: list  # the long-format records (format_data)


def serve_clips(
    model,
    clips,
    fps: int,
    num_homography: int = 1,
    num_keypoint_detection: int = 1,
    calibration: bool = False,
    smooth: bool = False,
    filter_ball_detections: bool = False,
    processor_config=None,
    overlap: bool | str = "auto",
):
    """Run an iterable of clips end to end, yielding one :class:`ClipResult`
    a clip, in order.  The Processor runs on ``model.device``.

    Clips with a length (a list, a tuple, a dataset: ``len(clips)`` works)
    are a backlog, and with ``overlap`` the loop reads ahead: it asks for
    clip k+1 before perceiving clip k, prescales clip k+1
    (:meth:`CoordinateModel.prescale_clip`) on a second worker during clip
    k's perception, runs clip k's Processor on a worker thread while the
    main thread perceives clip k+1, and yields clip k after that
    perception.  The Processor's team votes enqueue their device work on
    the same stream as the perception's.  At most one Processor job is in
    flight, at most three clips are alive at once (one post-processed, one
    perceived, one prescaled), and results come out in order.

    Clips without a length (a generator, a live feed) run in the
    reference's order, whatever ``overlap`` says: each clip is perceived as
    soon as it comes, its result is yielded as soon as its Processor job
    ends, and only then is the next clip asked for.  Asking for the next
    clip earlier would hold this clip's result until the next had come and
    been perceived.  How long asking took cannot tell a backlog from a live
    feed either: a clip handed 10 ms after the loop asked may come from a
    decoder 10 ms a clip behind, or from a feed whose next clip fell due 10
    ms later.  A source that is a backlog says so with ``__len__``.

    ``overlap=False`` runs the reference's order for any clips; the results
    are the same either way.  ``overlap="auto"`` reads ahead only when a
    spare CPU core exists.  ``clips`` is iterated on the calling thread
    only, in both orders (a source may hold thread-local state, such as a
    profiler it started).

    Tracing: the call is one call in the span log
    (:mod:`eagle_tpu_torch.utils.profiling`, unix-ns clock), clip k its
    request k, and each clip has four spans: ``serve:queued`` on the
    thread that iterates, from the clip leaving ``clips`` to the start of
    its perception; ``serve:perceive``, its ``get_coordinates`` there (the
    model's stages inside); ``serve:post``, its Processor job, on the
    worker when reading ahead (the Processor's stages inside, on the
    model's :class:`StageTimer`), with ``serve:frames`` counting its
    frames; and ``serve:held``, from the end of that job to the moment the
    result is yielded (0 long in the reference's order).  The count
    ``serve:read_ahead`` gives each clip's order: 1 when the loop read
    ahead over it, 0 in the reference's order."""
    timer = model.timer
    call = new_call("serve_clips")

    def post(k, coords, clip):
        """Clip k's Processor job -> (its result, when the job ended)."""
        with scope(call, k), timer.span("serve:post") as span:
            proc = Processor(
                coords,
                clip,
                fps,
                filter_ball_detections=filter_ball_detections,
                config=processor_config,
                device=model.device,
                timer=timer,
            )
            table, team_mapping = proc.process_data(smooth=smooth)
            res = ClipResult(coords, table, team_mapping, proc.format_data(table))
            timer.count("serve:frames", len(coords))
        return res, span.end

    def perceive(k, clip, pulled, prescaled=None, ahead=0):
        with scope(call, k):
            timer.count("serve:read_ahead", ahead)
            timer.record("serve:queued", pulled, time.time_ns())
            with timer.span("serve:perceive"):
                return model.get_coordinates(
                    clip,
                    fps,
                    num_homography=num_homography,
                    num_keypoint_detection=num_keypoint_detection,
                    calibration=calibration,
                    prescaled=prescaled,
                )

    def held(k, done, until=None):
        """Clip k's result, its ``serve:held`` span ended at ``until``
        (now by default)."""
        res, ended = done
        with scope(call, k):
            timer.record("serve:held", ended, until or time.time_ns())
        return res

    if overlap == "auto":
        from eagle_tpu_torch.utils import available_cpus

        overlap = available_cpus() > 1
    if not overlap or not isinstance(clips, Sized):
        for k, clip in enumerate(clips):
            done = post(k, perceive(k, clip, time.time_ns()), clip)
            yield held(k, done, until=done[1])
        return

    it = iter(clips)
    with ThreadPoolExecutor(max_workers=1) as ex, ThreadPoolExecutor(max_workers=1) as pre_ex:
        pending = None
        cur = next(it, None)
        pulled = time.time_ns()
        k = 0
        pre = None  # the prescale future of `cur` (none for the first clip)
        while cur is not None:
            nxt = next(it, None)
            pulled_next = time.time_ns()
            pre_next = pre_ex.submit(model.prescale_clip, nxt) if nxt is not None else None
            coords = perceive(k, cur, pulled, pre.result() if pre is not None else None, ahead=1)
            if pending is not None:
                yield held(k - 1, pending.result())
            # submitted after the previous result is out: yields stay in
            # order, and one Processor job at most is in flight
            pending = ex.submit(post, k, coords, cur)
            cur, pre, pulled, k = nxt, pre_next, pulled_next, k + 1
        if pending is not None:
            yield held(k - 1, pending.result())
