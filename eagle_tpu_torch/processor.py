"""Reference-shaped import path (`eagle.processor` -> `eagle_tpu_torch.processor`)."""

from eagle_tpu_torch.pipeline.processor import (  # noqa: F401
    KalmanFilter,
    Processor,
    calculate_distance,
    color_ranges,
    interpolate_df,
    smooth_df,
)
