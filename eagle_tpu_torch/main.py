"""The port's CLI: broadcast clip -> tracking data + annotated video, with
the reference CLI's flags and outputs.

    python -m eagle_tpu_torch.main --video_path clip.mp4 --fps 24 [--device cpu]

writes output/<video_name>/{raw_coordinates.json, raw_data.json,
metadata.json, processed_data.json, annotated.mp4}.  Decoding the .mp4 and
writing annotated.mp4 need OpenCV; the rest runs from frames in memory
through :func:`run`, which is what tests and ``chip_smoke.py`` call.  The
models run on the card unless ``--device cpu``; the detector and keypoint
model are seeded random inits (their checkpoints are not loadable yet).
``--reid_weights osnet.pt`` (a torchreid OSNet-x0.25 state dict, ``.pt`` or
``.pth``) turns on appearance association in the tracker, as the
reference's BoTSORT runs it.
"""

from __future__ import annotations

import itertools
import os
import sys
from argparse import ArgumentParser

import numpy as np

from eagle_tpu_torch.io.output import write_outputs
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel, StageTimer
from eagle_tpu_torch.pipeline.processor import Processor


def run(
    frames,
    fps: int,
    out_dir: str,
    model: CoordinateModel,
    *,
    num_homography: int = 1,
    num_keypoint_detection: int = 3,
    calibration: bool = False,
    smooth: bool = False,
    annotated: bool = True,
    timer: StageTimer | None = None,
) -> dict:
    """Frames -> the output files in ``out_dir``: ``get_coordinates``, the
    :class:`Processor` (its team votes on the model's device), the four
    JSON files and, with ``annotated``, annotated.mp4 (OpenCV).  ``frames``
    is (N, H, W, 3) uint8 BGR; everything runs on ``model.device``.
    Returns {"coordinates", "table", "team_mapping", "processed",
    "processor", "timer"}; the timer holds the perception stages, the
    Processor's (crops, votes, table, merge, format) and json; the
    processor holds the crops' votes (``crop_entries``, ``crop_votes``)."""
    frames = np.asarray(frames)
    timer = timer or StageTimer(model.device)
    coordinates = model.get_coordinates(
        frames,
        fps,
        num_homography=num_homography,
        num_keypoint_detection=num_keypoint_detection,
        calibration=calibration,
        timer=timer,
    )
    processor = Processor(coordinates, frames, fps, filter_ball_detections=False, device=model.device, timer=timer)
    table, team_mapping = processor.process_data(smooth=smooth)
    processed = processor.format_data(table)
    with timer("json"):
        write_outputs(out_dir, fps, coordinates, table, team_mapping, processed)
    if annotated:
        from eagle_tpu_torch.io.video import write_video
        from eagle_tpu_torch.utils.render import render_annotated_frames

        rendered = iter(render_annotated_frames(table, frames, coordinates, team_mapping))
        first = next(rendered, None)
        if first is None:
            print("No annotated frames to render (no detections); skipping annotated.mp4")
        else:
            write_video(itertools.chain([first], rendered), os.path.join(out_dir, "annotated.mp4"), fps)
    return {
        "coordinates": coordinates,
        "table": table,
        "team_mapping": team_mapping,
        "processed": processed,
        "processor": processor,
        "timer": timer,
    }


def main(argv=None) -> None:
    parser = ArgumentParser(description="Broadcast clip -> tracking data (PyTorch port)")
    parser.add_argument("--video_path", type=str, required=True)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--keypoint_weights", type=str, default=None, help=".pth HRNet checkpoint (not ported)")
    parser.add_argument("--detector_weights", type=str, default=None, help="YOLOv8 state_dict (not ported)")
    parser.add_argument(
        "--reid_weights",
        type=str,
        default=None,
        help="OSNet-x0.25 ReID checkpoint, a torchreid state dict (.pt / .pth); turns on appearance "
        "association in the tracker (the reference's BoTSORT configuration)",
    )
    parser.add_argument("--num_homography", type=int, default=1)
    parser.add_argument("--num_keypoint_detection", type=int, default=3)
    parser.add_argument("--calibration", action="store_true")
    parser.add_argument("--smooth", action="store_true")
    parser.add_argument(
        "--profile", action="store_true", help="print the per-stage wall-clock milliseconds to stderr"
    )
    parser.add_argument(
        "--segment_frames", type=int, default=0, help="stream in blocks of this many frames (not ported)"
    )
    parser.add_argument("--device", type=str, default=None, help='"cpu" for the plain CPU path; default the card')
    args = parser.parse_args(argv)

    if args.keypoint_weights is not None or args.detector_weights is not None:
        raise NotImplementedError(
            "--keypoint_weights / --detector_weights: checkpoint loaders are not ported yet "
            "(ROADMAP.md Queue 1, item 3)"
        )
    if args.segment_frames > 0:
        raise NotImplementedError("--segment_frames: streaming is not ported yet (ROADMAP.md Queue 1, item 4)")

    from eagle_tpu_torch.io.video import read_video_array

    video_name = args.video_path.split("/")[-1].split(".")[0]
    root = f"output/{video_name}"
    print("WARNING: running without trained weights (seeded random models)")
    # --reid_weights alone turns ReID on: use_appearance=None follows the weights
    model = CoordinateModel(reid_checkpoint=args.reid_weights, device=args.device)
    frames, fps = read_video_array(args.video_path, args.fps)
    out = run(
        frames,
        fps,
        root,
        model,
        num_homography=args.num_homography,
        num_keypoint_detection=args.num_keypoint_detection,
        calibration=args.calibration,
        smooth=args.smooth,
    )
    if args.profile:
        print(out["timer"].report(), file=sys.stderr)
    print("Data saved to", root)


if __name__ == "__main__":
    main()
