"""PyTorch port, the team-vote ops (``eagle_tpu_torch/ops/kmeans.py``)
against the JAX package's (``eagle_tpu/ops/kmeans.py``) on the same
numpy crops, and the cv2-free crop resize against ``cv2.resize``.

Tolerances:
- the host crops (integer boxes: the C++ clone of cv2's INTER_LINEAR;
  fractional boxes: the numpy gather) are bit-equal to the JAX package's
  and, for integer boxes, to ``cv2.resize`` itself;
- ``gather_crops`` (float32 bilinear samples of uint8 pixels) within 1e-4;
- ``kmeans2`` labels are equal, or all swapped on a crop where the JAX
  package's LAPACK returned the principal axis with the other sign (the
  port makes the sign canonical so the CPU and the card agree);
- ``crop_color_votes`` counts are bit-equal, except on a crop whose labels
  are swapped AND whose four corners split 2-2 between the clusters: the
  tie makes cluster 0 background, so there the two packages count
  different clusters (ROADMAP.md Queue 3, pinned by
  ``test_votes_differ_only_on_swapped_corner_ties``).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops import kmeans as jk
from eagle_tpu.utils.synthetic import make_scene
from eagle_tpu_torch import native
from eagle_tpu_torch.ops import kmeans as tk

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene_crops():
    """(crops (B, 32, 16, 3) uint8, frames, frame index, integer boxes) of
    every player of a synthetic broadcast-like clip, cut as the Processor
    cuts them."""
    sc = make_scene(num_frames=12, width=960, height=540, num_players=6, fps=12, seed=11)
    boxes = sc.player_boxes.reshape(-1, 4)
    fidx = np.repeat(np.arange(len(sc.frames)), sc.player_boxes.shape[1])
    ib = np.clip(np.rint(boxes), 0, [959, 539, 960, 540]).astype(np.float32)
    return tk.gather_crops_host(sc.frames, fidx, ib, grid_hw=(32, 16)), sc.frames, fidx, ib


def _random_crops(seed: int, b: int = 300) -> np.ndarray:
    """Noise crops and blocky crops (8x4 cells): many of their corners split
    2-2 between the clusters."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (b // 2, 32, 16, 3)).astype(np.uint8)
    blocks = np.repeat(np.repeat(rng.integers(0, 256, (b - b // 2, 4, 4, 3)), 8, 1), 4, 2).astype(np.uint8)
    return np.concatenate([noise, blocks])


def _labels(crops: np.ndarray):
    px = crops.astype(np.float32)[..., ::-1].reshape(len(crops), -1, 3).copy()
    want = np.asarray(jk.kmeans2(jnp.asarray(px), jnp.ones(px.shape[:2], bool)))
    got = tk.kmeans2(torch.from_numpy(px), torch.ones(px.shape[:2], dtype=torch.bool)).numpy()
    return got, want


def test_host_crops_match_jax(scene_crops):
    crops, frames, fidx, ib = scene_crops
    np.testing.assert_array_equal(crops, jk.gather_crops_host(frames, fidx, ib, grid_hw=(32, 16)))
    # fractional and clipped boxes take the numpy gather in both packages
    frac = ib + np.float32(0.37)
    frac[:, 2:] = np.minimum(frac[:, 2:], [959.5, 539.5])
    np.testing.assert_array_equal(
        tk.gather_crops_host(list(frames), fidx, frac, grid_hw=(24, 16)),
        jk.gather_crops_host(frames, fidx, frac, grid_hw=(24, 16)),
    )


def test_gather_crops_matches_jax(scene_crops):
    _, frames, fidx, ib = scene_crops
    rng = np.random.default_rng(3)
    boxes = np.concatenate([ib[:20], ib[20:40] + rng.uniform(-4, 4, (20, 4)).astype(np.float32),
                            np.array([[-6.0, -3.0, 980.0, 560.0], [20.0, 30.0, 21.0, 31.0]], np.float32)])
    fi = fidx[: len(boxes)].copy()
    fi[-2:] = 0
    want = np.asarray(jk.gather_crops(jnp.asarray(frames), jnp.asarray(fi), jnp.asarray(boxes), grid_hw=(32, 16)))
    got = tk.gather_crops(torch.from_numpy(frames), torch.from_numpy(fi), torch.from_numpy(boxes), grid_hw=(32, 16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# (32, 16) is the Processor's grid; the others change the row tail
@pytest.mark.parametrize("grid_hw", [(32, 16), (64, 32), (24, 15), (17, 9), (3, 1)])
def test_crop_resize_matches_cv2(grid_hw):
    """The host C++ crop resize against cv2.resize INTER_LINEAR on fuzzed
    integer boxes: the same size (a copy), exact 2x downscales (cv2's
    INTER_AREA fast path), 3x, upscales and arbitrary sizes."""
    gh, gw = grid_hw
    rng = np.random.default_rng(gh * 100 + gw)
    h, w = 300, 260
    frames = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    sizes = [(gh, gw), (2 * gh, 2 * gw), (3 * gh, 3 * gw), (max(1, gh // 2), max(1, gw // 3)), (1, 1)]
    sizes += [tuple(int(v) for v in rng.integers(1, 150, 2)) for _ in range(200)]
    boxes = []
    for sh, sw in sizes:
        sh, sw = min(sh, h), min(sw, w)
        x1, y1 = int(rng.integers(0, w - sw + 1)), int(rng.integers(0, h - sh + 1))
        boxes.append([x1, y1, x1 + sw, y1 + sh])
    boxes = np.array(boxes)
    fidx = rng.integers(0, 3, len(boxes))
    got = native.crops_linear_u8c3(frames, fidx, boxes, grid_hw)
    for k, (x1, y1, x2, y2) in enumerate(boxes):
        want = cv2.resize(frames[fidx[k]][y1:y2, x1:x2], (gw, gh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got[k], want, err_msg=f"crop {y2 - y1}x{x2 - x1}")


def test_kmeans2_labels_match_jax_up_to_the_axis_sign(scene_crops):
    """Labels equal, or swapped where LAPACK's axis sign is not the port's
    canonical one: the same partition of every crop."""
    for crops in (scene_crops[0], _random_crops(0)):
        got, want = _labels(crops)
        same = (got == want).all(1)
        swapped = (got == 1 - want).all(1)
        assert (same | swapped).all(), np.flatnonzero(~(same | swapped))
        assert same.any() and swapped.any(), "both signs occur on these crops"


def test_crop_color_votes_match_jax_on_player_crops(scene_crops):
    crops = scene_crops[0]
    want = np.asarray(jk.crop_color_votes(jnp.asarray(crops)))
    got = tk.crop_color_votes(torch.from_numpy(crops)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) > 0).all()


def test_votes_differ_only_on_swapped_corner_ties():
    crops = _random_crops(1)
    want = np.asarray(jk.crop_color_votes(jnp.asarray(crops)))
    got = tk.crop_color_votes(torch.from_numpy(crops)).numpy()
    labels, jlabels = _labels(crops)
    lab = labels.reshape(len(crops), 32, 16)
    tie = (lab[:, 0, 0] + lab[:, 0, -1] + lab[:, -1, 0] + lab[:, -1, -1]) == 2
    swapped = (labels == 1 - jlabels).all(1)
    differ = (got != want).any(1)
    np.testing.assert_array_equal(differ, tie & swapped)
    assert differ.any()


def test_crop_votes_in_batches_of_64_equal_one_batch():
    """Each crop's 2-means and colour counts are its own problem: the 300
    noise and blocky crops voted 64 at a time give the one-batch votes bit
    for bit."""
    crops = torch.from_numpy(_random_crops(0))
    whole = tk.crop_color_votes(crops)
    parts = torch.cat([tk.crop_color_votes(crops[i : i + 64]) for i in range(0, len(crops), 64)])
    assert torch.equal(parts, whole)


def test_crops_read_frames_in_bounded_groups():
    """The host crops read their frames in ascending order, at most
    ``CROP_FRAME_GROUP`` alive at once (a lazy frame source over a whole
    match decodes forward and holds one group); the crops are bit-equal to
    those cut from the stacked frames."""
    import weakref

    rng = np.random.default_rng(5)
    stack = rng.integers(0, 256, (150, 40, 48, 3), dtype=np.uint8)

    class CountingSource:
        def __init__(self):
            self.alive = self.peak = 0
            self.order = []

        def __len__(self):
            return len(stack)

        def __getitem__(self, i):
            frame = stack[int(i)].copy()
            self.order.append(int(i))
            self.alive += 1
            self.peak = max(self.peak, self.alive)
            weakref.finalize(frame, self._dropped)
            return frame

        def _dropped(self):
            self.alive -= 1

    fidx = rng.permutation(np.repeat(np.arange(150), 2))[:260]
    x1 = rng.integers(0, 40, len(fidx))
    y1 = rng.integers(0, 30, len(fidx))
    boxes = np.stack([x1, y1, x1 + rng.integers(1, 9, len(fidx)), y1 + rng.integers(1, 11, len(fidx))], -1)
    src = CountingSource()
    got = native.crops_linear_u8c3(src, fidx, boxes, (32, 16))
    np.testing.assert_array_equal(got, native.crops_linear_u8c3(stack, fidx, boxes, (32, 16)))
    assert src.peak <= native.CROP_FRAME_GROUP < len(np.unique(fidx))
    read = src.order[1:]  # after the size probe of frame 0
    assert read == sorted(read) and set(read) == set(fidx.tolist())
