"""PyTorch port, ``MultiClipRunner`` over a mesh of 2 and 4 gloo ranks
(``tests/torch_parity.py::RankPool``; the ranks import no JAX): the cases
of ``tests/test_torch_multiclip.py`` -- four make_scene clips of 8, 8, 5
and 3 frames at 320x192 with oracle models, clip 1 flagged for an on-demand
keypoint round (on rank 1 at 4 ranks), clips 2 and 3 seeding backward or
not at all -- against the JAX package's runner on a mesh of as many of the
8 virtual CPU devices (compiled in threads while the ranks run) and against
each clip's own single-device run in the port.

Every rank calls ``run`` with all clips and returns all of them.  The
oracles are numpy tables built here (``TableDetector``,
``MarkedKeypoints``), so the ranks need no scene.

Tolerances: against the JAX package ``assert_coords_match`` (boundaries
within 5 mm); against the port's single runs, equal dicts."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from eagle_tpu.config import MeshConfig
from eagle_tpu.parallel.mesh import make_mesh
from eagle_tpu.pipeline.coordinate_model import CoordinateModel as JModel
from eagle_tpu.pipeline.multiclip import MultiClipRunner as JRunner
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as TModel

from . import torch_parity as tp
from .oracles import oracle_detections_at, oracle_detector_fn, oracle_keypoint_fn
from .test_multiclip import _MultiSceneOracles
from .test_torch_coordinate_model import assert_coords_match
from .test_torch_multiclip import FPS, KW, LENS, MARK

torch.set_num_threads(2)

RANKS = (2, 4)
L = max(LENS)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    scenes = [make_scene(num_frames=n, width=320, height=192, num_players=4, fps=FPS, seed=40 + i)
              for i, n in enumerate(LENS)]
    clips = [s.frames.copy() for s in scenes]
    clips[1][4:] = 127  # the flow collapses: an on-demand round
    for c in (2, 3):
        clips[c][:2, 0, 0] = MARK
    kp, valid = oracle_keypoint_fn(scenes[0])(scenes[0].frames[:1])
    kp_fn = tp.MarkedKeypoints(kp[0], valid[0], MARK)
    tables = [tuple(np.stack(a) for a in zip(*(oracle_detections_at(s, t) for t in range(len(s.frames)))))
              for s in scenes]
    pools = {r: tp.RankPool(r, str(tmp_path_factory.mktemp("store") / "rendezvous")) for r in RANKS}
    try:
        for pool in pools.values():
            pool.submit(tp.job_multiclip, clips, tables, kp[0], valid[0], MARK, FPS, KW)

        def jax_run(r):
            mesh = make_mesh(MeshConfig(data_parallel=r), devices=jax.devices()[:r])
            model = JModel(keypoint_fn=kp_fn, detector_fn=_MultiSceneOracles(scenes, L), verbose_init=False)
            return JRunner(model, mesh=mesh).run(clips, FPS, **KW)

        with ThreadPoolExecutor(2) as ex:
            want = dict(zip(RANKS, ex.map(jax_run, RANKS)))
        singles = [TModel(keypoint_fn=kp_fn, detector_fn=oracle_detector_fn(s), device="cpu")
                   .get_coordinates(clips[ci], FPS, **KW) for ci, s in enumerate(scenes)]
        got = {r: pool.collect() for r, pool in pools.items()}
    finally:
        for pool in pools.values():
            pool.close()
    return dict(want=want, got=got, singles=singles)


@pytest.mark.parametrize("ranks", RANKS)
def test_runner_over_ranks_matches_jax(case, ranks):
    for res, _rounds in case["got"][ranks]:
        assert [len(r) for r in res] == LENS
        for ci in range(len(LENS)):
            assert_coords_match(res[ci], case["want"][ranks][ci], boundary_atol=5e-3)


@pytest.mark.parametrize("ranks", RANKS)
def test_runner_over_ranks_equals_single_runs_on_every_rank(case, ranks):
    for res, _rounds in case["got"][ranks]:
        for ci in range(len(LENS)):
            assert res[ci] == case["singles"][ci], f"clip {ci}"
    assert all(len(case["singles"][1][t]["Keypoints"]) >= 4 for t in range(4, L)), "the flagged frames get keypoints"


@pytest.mark.parametrize("ranks", RANKS)
def test_the_flagged_clip_runs_its_round_on_its_own_rank(case, ranks):
    rounds = [r for _res, r in case["got"][ranks]]
    owner = 1 if ranks == 4 else 0  # clip 1's rank: blocks of 1 clip at 4 ranks, of 2 at 2
    assert rounds[owner] >= 1
