"""The judge against faults planted in the program (:mod:`benchmark.faults`):
a run of each cell's driver at a small size on the CPU (the harness's
look for a card skipped), with the timed path broken underneath, must come
out not correct under the cell's own limits, through the number the fault
breaks (a fault that only a configuration with an appearance network can
have, on ``tiny.REID_CELLS``).  Run from the repository's root::

    python -m pytest -q benchmark/tests/test_faults.py
"""

from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.tests import tiny

CASES = [(cell, fault) for cell in sorted(tiny.CELLS) for fault in sorted(faults.FAULTS)
         if faults.applies(fault, tiny.driver_of(cell), tiny.load("configs", tiny.CELLS[cell][0]))]
# the faults that only a configuration with an appearance network can have
CASES += [(cell, fault) for cell in sorted(tiny.REID_CELLS) for fault in faults.REID_ONLY]


@pytest.mark.parametrize(("cell", "fault"), CASES)
def test_a_planted_fault_makes_the_run_not_correct(cell, fault):
    with getattr(faults, fault)():
        _, checks = tiny.run_and_judge(cell, 2**31 + 3, 1.5)
    number = faults.FAULTS[fault]
    assert not tiny.correct(checks)
    assert checks[number]["value"] > checks[number]["limit"], checks
