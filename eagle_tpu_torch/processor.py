"""Reference-shaped import path (`eagle.processor` -> `eagle_tpu_torch.processor`)."""

from eagle_tpu_torch.pipeline.processor import Processor, interpolate_df, smooth_df  # noqa: F401
