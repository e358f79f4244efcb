"""PyTorch port, the multi-device layer over torch.distributed
(``eagle_tpu_torch/parallel``): the rank mesh, its shard and gather, the
halo exchange, the frame-sharded keypoint and detector steps and the
clip-parallel scan, on 2 and 4 gloo ranks spawned once for the file
(``tests/torch_parity.py::RankPool``; the ranks import no JAX), against the
JAX package on a mesh of as many of the 8 virtual CPU devices and against
the port's one-process results.

Tolerances: layouts, shards, gathers and the halo bit-equal (the halo to
the JAX package's too); the sharded steps against the same functions on
all frames in one call: keypoints within 1e-5 px and boxes within 1e-4 px,
masks, scores' ranks and classes equal; the clip scan on a (dcn, data)
mesh equal to the flat mesh's and to one process's, with pad ranks that
hold no clip.  The same steps and scan against the JAX package's:
``tests/test_torch_parallel_steps.py``."""

import jax
import numpy as np
import pytest
import torch

from eagle_tpu.config import MeshConfig as JMeshConfig
from eagle_tpu.parallel.mesh import make_mesh as jmake_mesh
from eagle_tpu.parallel.mesh import pad_to_multiple as jpad
from eagle_tpu.parallel.mesh import shard_batch as jshard
from eagle_tpu.parallel.timeshard import halo_exchange_prev as jhalo
from eagle_tpu.pipeline import temporal as jt
from eagle_tpu_torch import DEFAULT_CONFIG
from eagle_tpu_torch.config import MeshConfig
from eagle_tpu_torch.parallel import mesh as tmesh
from eagle_tpu_torch.parallel.pipeline import multi_clip_scan
from eagle_tpu_torch.pipeline import temporal

from . import torch_parity as tp

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def pool(request, tmp_path_factory):
    p = tp.RankPool(request.param, str(tmp_path_factory.mktemp("store") / "rendezvous"))
    yield p
    p.close()


def test_ranks_import_no_jax(pool):
    assert all(pool.run(tp.job_no_jax))


@pytest.mark.parametrize("hosts", [1, 2])
def test_mesh_layout_shard_and_gather(pool, hosts):
    size = pool.size
    x = np.arange(size * 3 * 5, dtype=np.float32).reshape(size * 3, 5)
    res = pool.run(tp.job_mesh, hosts, x)
    for r, got in enumerate(res):
        assert got["index"] == r and got["size"] == size and got["order"] == tuple(range(size))
        assert got["shape"] == ((size,) if hosts == 1 else (2, size // 2))
        assert got["axes"] == (("data",) if hosts == 1 else ("dcn", "data"))
        np.testing.assert_array_equal(got["local"], x[3 * r : 3 * r + 3])  # host-major blocks
        np.testing.assert_array_equal(got["back"], x)
        np.testing.assert_array_equal(got["back_t"], x)
    padded, n = tmesh.pad_to_multiple(x[:7], size)
    want, wn = jpad(x[:7], size)
    assert n == wn and padded.tobytes() == want.tobytes()


def test_halo_exchange_matches_jax(pool):
    size = pool.size
    frames = np.arange(16, dtype=np.uint8)[:, None, None, None] * np.ones((16, 4, 4, 3), np.uint8)
    got = pool.run(tp.job_halo, frames)
    jm = jmake_mesh(JMeshConfig(data_parallel=size), devices=jax.devices()[:size])
    want = np.asarray(jhalo(jshard(frames, jm), jm))
    for g in got:
        np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(want[1:], frames[:-1])
    np.testing.assert_array_equal(want[0], frames[0])


def test_timeshard_refuses_a_two_dimensional_mesh(pool):
    for errors in pool.run(tp.job_timeshard_on, 2):
        assert len(errors) == 2 and all("1-D" in e for e in errors)


def test_sharded_steps_equal_one_call(pool):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (8, 64, 96, 3), dtype=np.uint8)
    for res in pool.run(tp.job_sharded_steps, frames, (64, 96), 64):
        kp, valid, boxes, scores, cls, dvalid = res["sharded"]
        wkp, wvalid, wboxes, wscores, wcls, wdvalid = res["single"]
        np.testing.assert_array_equal(valid, wvalid)
        np.testing.assert_allclose(kp, wkp, atol=1e-5)
        np.testing.assert_array_equal(dvalid, wdvalid)
        np.testing.assert_array_equal(cls[dvalid], wcls[wdvalid])
        np.testing.assert_allclose(boxes[dvalid], wboxes[wdvalid], atol=1e-4)
        np.testing.assert_allclose(scores[dvalid], wscores[wdvalid], atol=1e-5)
        assert valid.sum() > 0 and dvalid.sum() > 0, "the spread weights find keypoints and boxes"


def _clip_inputs(c: int, L: int = 2, hw=(32, 48)) -> dict:
    """``tests/test_parallel.py::test_hierarchical_mesh_clip_scan``'s inputs
    for ``c`` clips, as numpy."""
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 255, (c, L, *hw, 3), dtype=np.uint8)
    return dict(
        frame_bgr=clips,
        prev_frame_bgr=clips,
        model_kp=rng.uniform(0, 32, (c, L, 57, 3)).astype(np.float32),
        model_kp_valid=rng.random((c, L, 57)) > 0.3,
        is_kp_frame=np.ones((c, L), bool),
        is_h_frame=np.ones((c, L), bool),
        det_boxes=rng.uniform(0, 30, (c, L, 8, 4)).astype(np.float32),
        det_conf=rng.random((c, L, 8)).astype(np.float32),
        det_cls=np.zeros((c, L, 8), np.int64),
        det_valid=rng.random((c, L, 8)) > 0.5,
        t=np.tile(np.arange(L), (c, 1)),
    )


@pytest.mark.parametrize("packed", [False, True])
def test_clip_scan_on_a_host_mesh_equals_the_flat_mesh_and_one_process(pool, packed):
    c = pool.size - 1  # uneven: the last rank holds no clip
    xs = _clip_inputs(c)
    flat = pool.run(tp.job_clip_scan, 1, xs, 5, packed)
    hosts = pool.run(tp.job_clip_scan, 2, xs, 5, packed)
    cfg = tp.clip_scan_config(DEFAULT_CONFIG)
    one_mesh = tmesh.make_mesh(MeshConfig(), device="cpu")
    x = temporal.FrameInputs(**{k: torch.from_numpy(v) if k not in ("is_kp_frame", "is_h_frame", "t") else v
                                for k, v in xs.items()})
    carries = temporal.stack_clips([temporal.init_carry(cfg, "cpu") for _ in range(c)])
    want = multi_clip_scan(one_mesh, cfg, 5, derive_prev=True, packed=packed)(carries, x)[1]
    for got in flat + hosts:
        for a, b in zip(got if packed else tuple(got), want if packed else tuple(want)):
            np.testing.assert_array_equal(a, b)
    if packed:  # the JAX package's unpacking reads the port's rows field for field
        plain = multi_clip_scan(one_mesh, cfg, 5, derive_prev=True)(carries, x)[1]
        for ci in range(c):
            mine = temporal.unpack_outputs(want[ci], cfg.tracker.max_tracks)
            theirs = jt.unpack_outputs(want[ci], cfg.tracker.max_tracks)
            for name, a, b, p_ in zip(plain._fields, mine, theirs, plain):
                np.testing.assert_array_equal(a, b, err_msg=name)
                np.testing.assert_array_equal(a, p_[ci].astype(a.dtype), err_msg=name)


def test_make_mesh_without_a_process_group():
    m = tmesh.make_mesh(device="cpu")
    assert (m.size, m.index, m.axis_names, m.device) == (1, 0, ("data",), torch.device("cpu"))
    assert tmesh.make_mesh(devices=[torch.device("cpu")]).device == torch.device("cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        tmesh.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="no process group"):
        tmesh.make_mesh(MeshConfig(data_parallel=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()
    x = np.arange(12).reshape(6, 2)
    assert tmesh.shard_batch(x, m) is x or np.array_equal(tmesh.shard_batch(x, m), x)
    assert tmesh.gather_batch(x, m) is x and tmesh.gather_objects(7, m) == [7]
    assert tmesh.block(3, m) == (0, 3)
