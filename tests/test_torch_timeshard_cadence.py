"""PyTorch port, time-sharded processing with segment boundaries off the
keypoint (2) and homography (4) cadences: ``tests/test_timeshard.py``'s
segments of 5, 6 and 7 frames, on 2 and 4 gloo ranks, against the JAX
package's ``timesharded_keypoint_scan`` on as many devices and against the
port's ``scan_chunk``.  Every segment holds a full refresh (a model
keypoint frame, then a homography frame), so the two-pass warm start is
exact.  Tolerances as in ``tests/test_torch_timeshard.py``."""

import pytest
import torch

from .test_torch_timeshard import RANKS, assert_bit_equal, assert_scans_match, run_cases

torch.set_num_threads(2)

SEGMENTS = (5, 6, 7)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases({f"seg{s}": (s, 2, 4, (2,), 4) for s in SEGMENTS}, tmp_path_factory)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("seg_len", SEGMENTS)
def test_timesharded_scan_off_cadence_matches_jax_and_scan_chunk(results, seg_len, ranks):
    port, jax_out = results[f"seg{seg_len}", ranks]
    seq = port[0][1]
    for outs, _ in port:
        assert_scans_match(outs[2], jax_out[2])
        assert_bit_equal(outs[2], seq)
