"""The whole step's share (%) of the card's bf16 peak: the network FLOPs
the stretch's frames need (the detector on every frame, HRNet on the
cadence's frames) over the stretch's wall time."""

from benchmark.work import peaks


def read(ctx):
    st = ctx.stretch
    if st is None:
        return None
    work = ctx.detector_flops * st.frames + ctx.keypoint_flops * ctx.keypoint_frames
    return 100.0 * work / (st.window_s * peaks.BF16_FLOPS)
