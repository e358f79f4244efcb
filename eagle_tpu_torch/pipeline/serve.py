"""Clip-pipelined serving (counterpart of ``eagle_tpu/pipeline/serve.py``):
the Processor of clip k runs while clip k+1's perception runs.

The reference runs its stages strictly in sequence per video:
``get_coordinates``, then ``Processor.process_data``, then
``format_data``.  Perception keeps the card busy and the host mostly
waits on it; the Processor is mostly host work.  Running clip k's
Processor on a worker thread while the main thread runs clip k+1's
perception, and prescaling clip k+2 on a second worker, lets a stream of
clips approach max(device time, host time) a clip instead of their sum.
The results equal the sequential ones exactly.
"""

from __future__ import annotations

import time
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

    ``overlap=True``: after clip k's perception returns, its Processor runs
    on a worker thread while the main thread starts clip k+1's; clip k+1's
    host prescale (:meth:`CoordinateModel.prescale_clip`) runs on a second
    worker during clip k's perception.  The Processor's team votes enqueue
    their device work on the same stream as the perception's.  At most one
    Processor job is in flight, and results come out in order.
    ``overlap=False`` runs the reference's order; the results are the same
    either way.  ``overlap="auto"`` starts the workers only when a spare
    CPU core exists.

    ``clips`` may be a generator (e.g. decoding on demand): at most three
    clips are alive at once (one post-processed, one perceived, one
    prescaled).

    Tracing: the call is one call in the span log
    (:mod:`eagle_tpu_torch.utils.profiling`, unix-ns clock), clip k its
    request k, and each clip has four spans: ``serve:queued`` on the
    thread that iterates, from the clip leaving ``clips`` to the start of
    its perception; ``serve:perceive``, its ``get_coordinates`` there (the
    model's stages inside); ``serve:post``, its Processor job, on the
    worker with ``overlap`` (the Processor's stages inside, on the model's
    :class:`StageTimer`), with ``serve:frames`` counting its frames; and
    ``serve:held``, from the end of that job to the moment the result is
    yielded (0 long in the reference's order)."""
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

    def perceive(k, clip, pulled, prescaled=None):
        with scope(call, k):
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
    if not overlap:
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
            coords = perceive(k, cur, pulled, pre.result() if pre is not None else None)
            if pending is not None:
                yield held(k - 1, pending.result())
            # submitted after the previous result is out: yields stay in
            # order, and one Processor job at most is in flight
            pending = ex.submit(post, k, coords, cur)
            cur, pre, pulled, k = nxt, pre_next, pulled_next, k + 1
        if pending is not None:
            yield held(k - 1, pending.result())
