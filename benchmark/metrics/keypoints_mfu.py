"""The keypoint network's share (%) of the card's bf16 peak: the FLOPs of
the HRNet calls the cadence requires in the stretch (its sampled frames),
over the keypoints stage's device time (as in ``detector_mfu``)."""

from benchmark.work import peaks


def read(ctx):
    span = ctx.stretch.stage_span("keypoints") if ctx.stretch is not None else None
    if not span or not ctx.keypoint_frames:
        return None
    return 100.0 * ctx.keypoint_flops * ctx.keypoint_frames / (span[0] * peaks.BF16_FLOPS)
