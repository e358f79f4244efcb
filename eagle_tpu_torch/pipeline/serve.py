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

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

from eagle_tpu_torch.pipeline.processor import Processor, Table


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
    prescaled)."""

    def post(coords, clip):
        proc = Processor(
            coords,
            clip,
            fps,
            filter_ball_detections=filter_ball_detections,
            config=processor_config,
            device=model.device,
        )
        table, team_mapping = proc.process_data(smooth=smooth)
        return ClipResult(coords, table, team_mapping, proc.format_data(table))

    def perceive(clip, prescaled=None):
        return model.get_coordinates(
            clip,
            fps,
            num_homography=num_homography,
            num_keypoint_detection=num_keypoint_detection,
            calibration=calibration,
            prescaled=prescaled,
        )

    if overlap == "auto":
        from eagle_tpu_torch.utils import available_cpus

        overlap = available_cpus() > 1
    if not overlap:
        for clip in clips:
            yield post(perceive(clip), clip)
        return

    it = iter(clips)
    with ThreadPoolExecutor(max_workers=1) as ex, ThreadPoolExecutor(max_workers=1) as pre_ex:
        pending = None
        cur = next(it, None)
        pre = None  # the prescale future of `cur` (none for the first clip)
        while cur is not None:
            nxt = next(it, None)
            pre_next = pre_ex.submit(model.prescale_clip, nxt) if nxt is not None else None
            coords = perceive(cur, pre.result() if pre is not None else None)
            if pending is not None:
                yield pending.result()
            # submitted after the previous result is out: yields stay in
            # order, and one Processor job at most is in flight
            pending = ex.submit(post, coords, cur)
            cur, pre = nxt, pre_next
        if pending is not None:
            yield pending.result()
