"""The control on the card: the reference computed in float8 (and the
projection in bfloat16) in the program's place must fail the cell's
limits, where the program's own bfloat16 run lies below them.  At a small
size of each cell, a few seeds.  Needs a card (marker ``cuda``)::

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_control.py
"""

from __future__ import annotations

import gc

import pytest
import torch

from benchmark.control import control_gaps
from benchmark.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is read on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 2**31 + 7, 2**33 + 1])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_fails_where_the_program_passes(card, cell, seed):
    r, driver = tiny.tiny(cell, seed, 2.0, card)
    result = driver.run(r)
    r.free_program()
    gc.collect()
    program = {k: c["value"] for k, c in r.judge(result).items()}
    control = control_gaps(r, result)
    assert program["detector_gap"] < control["detector_gap"]
    assert program["keypoint_gap"] < control["keypoint_gap"]
    assert any(v > r.limits[k] for k, v in control.items()), (program, control, r.limits)
