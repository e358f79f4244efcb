"""PyTorch port, appearance association with the HSV-histogram embedder
end to end: ``get_coordinates`` of both packages on the panning oracle clip
of tests/test_torch_reid_pipeline.py, at its tolerances."""

import torch

from .test_torch_reid_pipeline import SETTINGS, check_pipeline, scene  # noqa: F401  (the clip fixture)

torch.set_num_threads(2)


def test_histogram_appearance_matches_jax(scene):  # noqa: F811
    check_pipeline(scene, SETTINGS["histogram"])
