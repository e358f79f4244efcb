"""PyTorch port, the reference's tracker end to end with its camera-motion
estimate: ``get_coordinates`` of both packages with the features GMC (grid
corners of the previous frame tracked by the LK flow at K = 240, the
robust 4-DOF fit) and appearance association (the HSV histogram), on the
panning oracle clip of tests/test_torch_reid_pipeline.py, at its
tolerances."""

import torch

from .test_torch_reid_pipeline import check_pipeline, scene  # noqa: F401  (the clip fixture)

torch.set_num_threads(2)


def test_features_gmc_with_appearance_matches_jax(scene):  # noqa: F811
    check_pipeline(scene, dict(use_appearance=True, embedder="histogram", embed_dim=64, gmc="features"))
