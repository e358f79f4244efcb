"""Host milliseconds a frame in the Processor (``process_data`` and
``format_data``, timed around the calls on its worker thread), over the
frames it processed."""


def read(ctx):
    if not ctx.processor_frames:
        return None
    return ctx.processor_s * 1e3 / ctx.processor_frames
