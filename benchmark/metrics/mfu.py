"""The whole step's share (%) of the card's bf16 peak: the network FLOPs
the stretch's frames need (the detector on every frame, HRNet on the
cadence's frames, and where the configuration has an appearance network
its crops on every frame) over the stretch's wall time."""

from benchmark.work import peaks


def read(ctx):
    st = ctx.stretch
    if st is None:
        return None
    work = ctx.detector_flops * st.frames + ctx.keypoint_flops * ctx.keypoint_frames
    if hasattr(ctx, "reid_flops"):
        work += ctx.reid_flops * st.frames
    return 100.0 * work / (st.window_s * peaks.BF16_FLOPS)
