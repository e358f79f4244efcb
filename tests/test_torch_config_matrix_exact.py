"""PyTorch port, the two cases of ``tests/test_config_matrix.py`` with the
exact assignment solver (``osnet+exact+calibration`` and
``gmc-translation+smoothless``, the port's first test of
``gmc="translation"``) held against the JAX package, as
tests/test_torch_config_matrix.py holds the other three.  On 8 frames of
that file's scene: on the CPU the port's JV is its plain Python loop
(``solve_lap_plain``, ~1 s a frame at these slots).

Tolerances as in tests/test_torch_config_matrix.py."""

import pytest
import torch

from .test_torch_config_matrix import EXACT, check_case

torch.set_num_threads(2)

FRAMES = 8


@pytest.mark.parametrize("name", EXACT)
def test_exact_config_combination_matches_jax(name):
    check_case(name, FRAMES)
