"""Sharded pipeline steps: frame-parallel perception and clip-parallel
temporal steps over the rank mesh (counterpart of
``eagle_tpu/parallel/pipeline.py``).

The stateless stages shard the *frame* axis: each rank runs its block of
frames through the model.  The sequential stage shards the *clip* axis:
each clip's steps stay on one rank, so a clip's tracker identities are
those of a run of that clip alone, and no message passes between clips.
Each step returns this rank's part; the mesh's gathers give the whole.
"""

from __future__ import annotations

import numpy as np
import torch

from eagle_tpu_torch.config import PipelineConfig
from eagle_tpu_torch.ops.heatmap import decode_heatmaps
from eagle_tpu_torch.ops.nms import batched_nms
from eagle_tpu_torch.ops.optical_flow import alloc_frames, upload_frames
from eagle_tpu_torch.ops.preprocess import letterbox, preprocess_keypoint
from eagle_tpu_torch.parallel.mesh import Mesh, block, gather_objects
from eagle_tpu_torch.pipeline import temporal


def _on_rank(frames, mesh: Mesh) -> torch.Tensor:
    return (torch.from_numpy(np.ascontiguousarray(frames)) if isinstance(frames, np.ndarray) else frames).to(mesh.device)


def sharded_keypoint_step(mesh: Mesh, model, cfg: PipelineConfig, image_hw, conf: float = 0.3):
    """A step: this rank's frames ((n, H, W, 3) uint8 BGR, a shard of the
    frame axis) -> (kp (n, 57, 3), valid (n, 57)) from ``model`` (the port's
    HRNet, on the rank's device) and :func:`decode_heatmaps`."""

    @torch.no_grad()
    def step(frames):
        pre = preprocess_keypoint(_on_rank(frames, mesh), out_hw=tuple(cfg.keypoint.input_hw))
        hm = model(pre.permute(0, 3, 1, 2).contiguous())
        return decode_heatmaps(hm, conf, image_hw, cfg.keypoint.score_floor)

    return step


def sharded_detector_step(mesh: Mesh, model, cfg: PipelineConfig, image_hw, variant: str = "l", conf: float = 0.15):
    """A step: this rank's frames -> (boxes (n, D, 4) in original pixels,
    scores, classes, valid) from ``model`` (the port's YOLOv8 of
    ``variant``) on the letterboxed frames and class-aware NMS."""
    if getattr(model, "variant", variant) != variant:
        raise ValueError(f"the model is YOLOv8-{model.variant}, the step was asked for YOLOv8-{variant}")
    h, w = image_hw

    @torch.no_grad()
    def step(frames):
        imgs, gain, pad = letterbox(_on_rank(frames, mesh), size=cfg.detector.image_size)
        boxes, scores = model(imgs.permute(0, 3, 1, 2).contiguous())
        b, s, c, v = batched_nms(
            boxes, scores, conf_threshold=conf, iou_threshold=cfg.detector.nms_iou, max_det=cfg.detector.max_detections
        )
        dev = b.device
        pad4 = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=torch.float32, device=dev)
        b = (b - pad4) / torch.tensor(gain, dtype=torch.float32, device=dev)
        hi = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32, device=dev)
        return torch.minimum(torch.clamp(b, min=0.0), hi), s, c, v

    return step


def multi_clip_scan(mesh: Mesh, cfg: PipelineConfig, base_key: int, derive_prev: bool = False, packed: bool = False):
    """A clip-parallel scan ``scan(carries, xs) -> (carries, outputs)``.
    ``carries`` and ``xs`` hold every clip (a leading clip axis; ``xs``
    time second, its ``is_kp_frame``, ``is_h_frame`` and ``t`` (C, L) host
    arrays); each rank steps its contiguous block of clips
    (:func:`~eagle_tpu_torch.parallel.mesh.block`) with
    :func:`~eagle_tpu_torch.pipeline.temporal.scan_clips`, the loop
    ``MultiClipRunner`` runs, moving only that block to its device (frames
    already there are read in place).  A rank with no clip runs no step but
    still joins the gather.  Returns this rank's final carries (None for no
    clip) and every clip's outputs as numpy on every rank: a
    :class:`~eagle_tpu_torch.pipeline.temporal.FrameOutputs` of (C, L, ...)
    leaves, or with ``packed`` one (C, L, F) float32 array
    (:func:`~eagle_tpu_torch.pipeline.temporal.pack_outputs`).

    ``derive_prev``: each clip's previous frames are its frames shifted by
    one, frame 0 repeating (the caller's ``prev_frame_bgr`` is ignored)."""
    dev = mesh.device

    def local(tree, lo, hi):
        if tree is None:
            return None
        if hasattr(tree, "_fields"):
            return type(tree)(*(local(v, lo, hi) for v in tree))
        return tree[lo:hi].to(dev) if isinstance(tree, torch.Tensor) else np.asarray(tree)[lo:hi]

    def frames_on_rank(frames, lo, hi):
        """Clips lo..hi of (C, L, H, W, 3) frames in a layout whose frame t
        of every clip is the view the clip-batched flow launch reads in
        place: a tensor already on the device in such a layout as it is,
        else one buffer of :func:`alloc_frames` (host frames uploaded once,
        device frames copied on the device)."""
        f = frames[lo:hi]
        c, length, h, w, _ = f.shape
        if not isinstance(f, torch.Tensor):
            return upload_frames(np.asarray(f).reshape(-1, h, w, 3), dev).unflatten(0, (c, length))
        if f.device == dev and (dev.type != "cuda" or (f.is_contiguous() and (3 * w) % 16 == 0)):
            return f
        out = alloc_frames(c * length, h, w, dev).unflatten(0, (c, length))
        out.copy_(f)
        return out

    def scan(carries, xs):
        lo, hi = block(len(xs.t), mesh)
        out = None
        if hi > lo:
            frames = frames_on_rank(xs.frame_bgr, lo, hi)
            prevs = None if derive_prev else frames_on_rank(xs.prev_frame_bgr, lo, hi)
            x = local(xs._replace(frame_bgr=None, prev_frame_bgr=None), lo, hi)
            x = x._replace(frame_bgr=frames, prev_frame_bgr=prevs)
            n_steps = frames.shape[1]
            log, steps = [local(carries, lo, hi)] + [None] * n_steps, [None] * n_steps
            temporal.scan_clips(log, steps, x, cfg, temporal.ransac_draws(base_key, cfg, dev))
            carries = log[-1]
            stacked = temporal.FrameOutputs(*(torch.stack(f, dim=1) for f in zip(*steps)))
            if packed:
                flat = temporal.FrameOutputs(*(f.flatten(0, 1) for f in stacked))
                out = temporal.pack_outputs(flat).reshape(hi - lo, n_steps, -1).cpu().numpy()
            else:
                out = temporal.FrameOutputs(*(f.cpu().numpy() for f in stacked))
        else:
            carries = None
        parts = [p for p in gather_objects(out, mesh) if p is not None]
        if packed:
            return carries, np.concatenate(parts)
        return carries, temporal.FrameOutputs(*(np.concatenate(f) for f in zip(*parts)))

    return scan
