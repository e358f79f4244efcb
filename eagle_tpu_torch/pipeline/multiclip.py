"""Multi-clip runs: several clips tracked in one run, each with its own
result (counterpart of ``eagle_tpu/pipeline/multiclip.py``).

Two strategies, chosen by the JAX package's rule:

- **Built-in models on the working geometry**: the clips run as ONE
  flattened stream through the single-clip machinery
  (``CoordinateModel.get_coordinates(_clip_lens=...)``): within-clip
  ``t``, the carry reset at every clip's first frame, pad frames never
  sampled -- every clip's result is its own run's.
- **Custom models** (or no working geometry): the clip-batched temporal
  step (:func:`~eagle_tpu_torch.pipeline.temporal.temporal_step_clips`)
  over the clips' frames, one step for all clips at a time: the flow of
  all clips is one launch of the flow kernel, RANSAC is gated once on any
  clip's need.  Shorter clips step through their pad frames (copies of
  their last frame), which are sliced off.

Both run the reference's on-demand keypoint rounds (flow collapse below 4
points on a non-cadence frame): the flagged frames get model keypoints
and the steps rerun from the first of them, at most 3 times.

Over a mesh of more than one rank (:func:`eagle_tpu_torch.parallel.mesh.make_mesh`,
one process a rank), every rank calls :meth:`MultiClipRunner.run` with the
same clips; rank r runs its contiguous block of them (split as
``pad_to_multiple`` pads them; pad clips are never run or returned)
through the machinery above, and every rank returns every clip's dict.
A clip's result depends only on its own frames and its own on-demand
rounds, so it is the same on any rank.
"""

from __future__ import annotations

import numpy as np
import torch

from eagle_tpu_torch.ops.optical_flow import upload_frames
from eagle_tpu_torch.parallel.mesh import Mesh, block, gather_objects, make_mesh, same_device
from eagle_tpu_torch.pipeline import temporal
from eagle_tpu_torch.pipeline.coordinate_model import ONDEMAND_ROUNDS, PIECE, CoordinateModel, StageTimer
from eagle_tpu_torch.pipeline.transfer import drain_together


class MultiClipRunner:
    """Runs a :class:`CoordinateModel` over a batch of clips.

    >>> runner = MultiClipRunner(model)
    >>> results = runner.run([clip_a, clip_b], fps=24)   # list of dicts

    ``mesh``: a :class:`~eagle_tpu_torch.parallel.mesh.Mesh` whose device is
    the model's, a sequence of devices (one without a process group), or
    None: ``make_mesh(model.config.mesh)`` on the model's device (over the
    process group's ranks when one is initialised, else one rank)."""

    def __init__(self, model: CoordinateModel, mesh=None):
        if not isinstance(mesh, Mesh):
            devices = None if mesh is None else np.asarray(getattr(mesh, "devices", mesh), dtype=object).reshape(-1)
            mesh = make_mesh(model.config.mesh, devices=devices, device=model.device if mesh is None else None)
        if mesh.device != same_device(model.device):
            raise ValueError(f"the mesh puts this rank on {mesh.device} and the model is on {model.device}")
        self.model = model
        self.mesh = mesh

    def run(
        self,
        clips: list[np.ndarray],
        fps: int,
        num_homography: int = 1,
        num_keypoint_detection: int = 1,
        verbose: bool = False,
        profile: StageTimer | None = None,
    ) -> list[dict]:
        """One ``get_coordinates`` dict per clip, on every rank of the mesh.
        ``profile``: a :class:`StageTimer` accumulating the stages'
        wall-clock seconds (this rank's)."""
        kw = dict(num_homography=num_homography, num_keypoint_detection=num_keypoint_detection,
                  verbose=verbose, profile=profile)
        if self.mesh.group is None:
            return self._run(clips, fps, **kw)
        lo, hi = block(len(clips), self.mesh)
        mine = self._run(clips[lo:hi], fps, **kw) if hi > lo else []
        return [r for part in gather_objects(mine, self.mesh) for r in part]

    def _run(self, clips, fps, num_homography, num_keypoint_detection, verbose, profile) -> list[dict]:
        """The clips on this rank's device."""
        model = self.model
        timer = profile or StageTimer(model.device)
        clips = [np.asarray(c) for c in clips]
        img_hw = (int(clips[0].shape[1]), int(clips[0].shape[2]))
        if any(tuple(c.shape[1:3]) != img_hw for c in clips):
            raise ValueError("clips must share one resolution")
        lengths = [len(c) for c in clips]
        L = max(lengths)
        # pad shorter clips by repeating their last frame (sliced off later)
        padded = [np.concatenate([c, np.repeat(c[-1:], L - len(c), axis=0)]) if len(c) < L else c for c in clips]
        geom = model._geometry(img_hw)
        kw = dict(num_homography=num_homography, num_keypoint_detection=num_keypoint_detection)
        canvas = not model._custom_det and geom.enabled
        if canvas and not model._custom_kp:
            return model.get_coordinates(padded, fps, verbose=verbose, profile=timer, _clip_lens=lengths, **kw)
        return self._run_clip_batched(padded, lengths, fps, geom, canvas, timer, **kw)

    def _run_clip_batched(self, padded, lengths, fps, geom, canvas: bool, timer, num_homography,
                          num_keypoint_detection) -> list[dict]:
        """The clip-batched path.  ``canvas``: the built-in detector on the
        working canvas with a custom keypoint function -- the frames are
        the device canvas, which the seed flows over too; otherwise the
        raw frames, and the seed flows over the host frames."""
        model = self.model
        dev = model.device
        C, L = len(padded), len(padded[0])
        n = C * L
        img_hw = (int(padded[0].shape[1]), int(padded[0].shape[2]))
        cfg = model.config.replace(work=geom)
        temporal.check_config(cfg)
        kp_interval = max(1, int(fps / max(1, num_keypoint_detection)))
        h_interval = max(1, int(fps / max(1, num_homography)))
        appearance = bool(cfg.tracker.use_appearance)
        flat = np.concatenate(padded)

        with timer("prescale"):
            # the raw frames as BGR under a custom detector (as the JAX
            # runner uploads them); else the clip's prescale and transport
            frames = upload_frames(flat, dev) if model._custom_det else model.upload(flat, geom)

        det_rows = []
        for i in range(0, n, PIECE):
            idx = list(range(i, min(i + PIECE, n)))
            if model._custom_det:
                pad = idx + idx[-1:] * (PIECE - len(idx))  # detector batches padded to PIECE
                with timer("detector"):
                    rows = torch.from_numpy(model._custom_detections(flat[pad])).to(dev)
                if appearance:
                    with timer("reid"):
                        rows = torch.cat([rows, model.embed(frames[pad], rows[..., :4])], dim=-1)
                rows = rows[: len(idx)]
            else:
                rows = model.run_detector(frames[i : i + PIECE], geom, img_hw, timer)
            det_rows.append(rows)
        det = torch.cat(det_rows)

        # keypoints at each clip's cadence; pad frames are never sampled
        sampled_rel = list(range(0, L, kp_interval))
        sampled = [c * L + t for c in range(C) for t in sampled_rel if t < lengths[c]]
        mem_kp = np.zeros((n, 57, 3), np.float32)
        mem_valid = np.zeros((n, 57), bool)
        mem_attempted = np.zeros((n,), bool)

        def detect(idx):
            packed = model._keypoints_at(idx, flat, frames, geom, img_hw)
            mem_kp[idx] = packed[..., :3]
            mem_valid[idx] = packed[..., 3] > 0.5
            mem_attempted[idx] = True

        with timer("keypoints"):
            detect(sampled)

        # per-clip first-frame seeding, within each clip's real length
        with timer("temporal"):
            model._seed_clips(
                [(ci * L, ln) for ci, ln in enumerate(lengths)], sampled, mem_kp, mem_valid, cfg,
                lambda lo, hi: frames[lo:hi] if canvas else upload_frames(flat[lo:hi], dev),
            )
        keys_fn = model._ransac_draws(cfg)

        # the clip-batched step over t = 0..L-1, with per-step carry
        # checkpoints; an on-demand round reruns from its first flagged step
        clip_det = det.unflatten(0, (C, L))
        steps = np.tile(np.arange(L), (C, 1))
        xs = temporal.FrameInputs(
            frame_bgr=frames.unflatten(0, (C, L)),
            prev_frame_bgr=None,  # each clip's own frames shifted by one
            model_kp=None,
            model_kp_valid=None,
            is_kp_frame=steps % kp_interval == 0,
            is_h_frame=steps % h_interval == 0,
            det_boxes=clip_det[..., :4],
            det_conf=clip_det[..., 4],
            det_cls=clip_det[..., 5].to(torch.int64),
            det_valid=clip_det[..., 6] > 0.5,
            t=steps,
            det_embed=clip_det[..., 7:] if appearance else None,
        )
        real = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
        carries = [temporal.stack_clips([temporal.init_carry(cfg, dev) for _ in range(C)])] + [None] * L
        outs: list = [None] * L
        start = 0
        for _round in range(ONDEMAND_ROUNDS):
            with timer("temporal"):
                xs = xs._replace(model_kp=torch.from_numpy(mem_kp).to(dev).unflatten(0, (C, L)),
                                 model_kp_valid=torch.from_numpy(mem_valid).to(dev).unflatten(0, (C, L)))
                temporal.scan_clips(carries, outs, xs, cfg, keys_fn, start)
                model.frames_stepped += C * (L - start)
                need = torch.stack([o.need_kp for o in outs], dim=1).cpu().numpy()
            flagged = np.flatnonzero((need & real).reshape(-1) & ~mem_attempted)
            if len(flagged) == 0:
                break
            model.ondemand_rounds += 1
            with timer("keypoints"):
                detect(flagged.tolist())
            start = int((flagged % L).min())

        with timer("assembly"):
            # every clip's outputs and detector rows in one device-to-host copy
            *leaves, det_np = drain_together(
                *(torch.stack([o[i] for o in outs], dim=1) for i in range(len(outs[0]))), clip_det[..., :7]
            )
            return [
                model._assemble(
                    temporal.FrameOutputs(*(leaf[ci, :ln] for leaf in leaves)),
                    det_np[ci, :ln, :, :4],
                    det_np[ci, :ln, :, 4],
                    det_np[ci, :ln, :, 5].astype(np.int32),
                    det_np[ci, :ln, :, 6] > 0.5,
                    fps,
                    img_hw,
                )
                for ci, ln in enumerate(lengths)
            ]
