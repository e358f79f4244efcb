"""PyTorch port, time-sharded processing of one clip
(``eagle_tpu_torch/parallel/timeshard.py``) on 2 and 4 gloo ranks
(``tests/torch_parity.py::RankPool``, no JAX in the ranks), against the JAX
package's ``timesharded_keypoint_scan`` on a mesh of as many of the 8
virtual CPU devices and against the port's ``scan_chunk``: the cases of
``tests/test_timeshard.py`` -- segment boundaries on the keypoint and
homography cadences (this file) and the envelope of segments shorter than
the cadence, with 2 and 3 passes; the off-cadence segments are in
``tests/test_torch_timeshard_cadence.py``.

The JAX package compiles each case's program (~15 s); the module fixture
compiles them in threads while the ranks run.

Tolerances (as the port's temporal tests): ``kp_valid`` and ``H_ok``
bit-equal to the JAX package's, ``kp_xy`` equal on the valid points, and
the homographies project the valid on-plane keypoints within 5 mm of each
other; against ``scan_chunk`` (exact cases, and the exact segments of the
envelope) bit-equal."""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from eagle_tpu import pitch
from eagle_tpu.config import DEFAULT_CONFIG, MeshConfig
from eagle_tpu.parallel.mesh import make_mesh, shard_batch
from eagle_tpu.parallel.timeshard import halo_exchange_prev, timesharded_keypoint_scan
from eagle_tpu.utils.synthetic import make_scene

from . import torch_parity as tp
from .oracles import oracle_keypoint_fn
from .test_timeshard import _build_xs

torch.set_num_threads(2)

RANKS = (2, 4)


def clip(seg_len: int, ranks: int, kp_interval: int, h_interval: int, seed: int):
    """``tests/test_timeshard.py``'s clip for ``ranks`` segments of
    ``seg_len`` frames: (frames, mem_kp, mem_valid)."""
    n = ranks * seg_len
    scene = make_scene(num_frames=n, width=640, height=360, num_players=0, fps=8, seed=seed)
    mem_kp = np.zeros((n, 57, 3), np.float32)
    mem_valid = np.zeros((n, 57), bool)
    sampled = list(range(0, n, kp_interval))
    kp, valid = oracle_keypoint_fn(scene)(scene.frames[sampled])
    mem_kp[sampled] = kp
    mem_valid[sampled] = valid
    return scene.frames, mem_kp, mem_valid


def jax_timeshard(ranks: int, frames, mem_kp, mem_valid, kp_interval: int, h_interval: int, passes: tuple) -> dict:
    """The JAX package's ``timesharded_keypoint_scan`` on ``ranks`` devices:
    {passes: (kp_xy, kp_valid, H, H_ok)}."""
    n = len(frames)
    cfg = DEFAULT_CONFIG.replace(chunk_frames=n)
    xs = _build_xs(SimpleNamespace(frames=frames), n, kp_interval, h_interval, mem_kp, mem_valid)
    mesh = make_mesh(MeshConfig(data_parallel=ranks), devices=jax.devices()[:ranks])
    f = shard_batch(np.asarray(xs.frame_bgr), mesh)
    xs = xs._replace(frame_bgr=f, prev_frame_bgr=halo_exchange_prev(f, mesh))
    return {p: tuple(np.asarray(a) for a in timesharded_keypoint_scan(mesh, cfg, jax.random.key(0), xs, passes=p))
            for p in passes}


def run_cases(cases: dict, tmp_path_factory) -> dict:
    """``cases``: name -> (seg_len, kp_interval, h_interval, passes, seed).
    Every case at every rank count through the port's ranks and the JAX
    package (in threads meanwhile): {(name, ranks): (port ranks' results,
    JAX's)}."""
    inputs = {(name, r): clip(seg, r, ki, hi, seed) + (ki, hi, passes)
              for name, (seg, ki, hi, passes, seed) in cases.items() for r in RANKS}
    pools = {r: tp.RankPool(r, str(tmp_path_factory.mktemp("store") / "rendezvous")) for r in RANKS}
    try:
        for r, pool in pools.items():
            pool.submit(tp.job_timeshard, [args for (name, rr), args in inputs.items() if rr == r])
        with ThreadPoolExecutor(4) as ex:
            jax_out = {k: ex.submit(jax_timeshard, k[1], *args) for k, args in inputs.items()}
            jax_out = {k: f.result() for k, f in jax_out.items()}
        port = {r: pool.collect() for r, pool in pools.items()}
    finally:
        for pool in pools.values():
            pool.close()
    out = {}
    for r in RANKS:
        keys = [k for k in inputs if k[1] == r]
        for i, k in enumerate(keys):
            out[k] = ([rank_res[i] for rank_res in port[r]], jax_out[k])
    return out


def project(H, xy):
    p = np.concatenate([xy, np.ones((len(xy), 1))], -1) @ H.astype(np.float64).T
    return p[:, :2] / p[:, 2:]


def assert_scans_match(got, want, upto=None):
    """The tolerances of the module docstring, on frames [:upto]."""
    kp_xy, kp_valid, H, H_ok = (a[:upto] for a in got)
    wkp, wvalid, wH, wok = (a[:upto] for a in want)
    np.testing.assert_array_equal(kp_valid, wvalid)
    np.testing.assert_array_equal(H_ok, wok)
    np.testing.assert_array_equal(kp_xy[wvalid], wkp[wvalid])
    for f in np.flatnonzero(wok):
        on = pitch.ON_PLANE_MASK & wvalid[f]
        np.testing.assert_allclose(project(H[f], wkp[f][on]), project(wH[f], wkp[f][on]), atol=5e-3)
    assert wok.any()


def assert_bit_equal(got, want, upto=None):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[:upto], b[:upto])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases({"aligned": (16, 2, 4, (2,), 4), "envelope": (5, 16, 16, (2, 3), 6)}, tmp_path_factory)


@pytest.mark.parametrize("ranks", RANKS)
def test_timesharded_scan_on_cadence_matches_jax_and_scan_chunk(results, ranks):
    """Segments of 32 / ranks frames, boundaries on the keypoint (2) and
    homography (4) cadences: exact."""
    port, jax_out = results["aligned", ranks]
    seq = port[0][1]
    for outs, _ in port:
        assert_scans_match(outs[2], jax_out[2])
        assert_bit_equal(outs[2], seq)


@pytest.mark.parametrize("ranks", RANKS)
def test_timesharded_scan_envelope_without_refresh_matches_jax(results, ranks):
    """Segments of 5 frames under a cadence of 16: the warm start is exact
    only for the first ``passes`` segments, and equals the JAX package's
    everywhere."""
    port, jax_out = results["envelope", ranks]
    seq = port[0][1]
    for outs, _ in port:
        for passes in (2, 3):
            assert_scans_match(outs[passes], jax_out[passes])
            assert_bit_equal(outs[passes], seq, upto=passes * 5)
