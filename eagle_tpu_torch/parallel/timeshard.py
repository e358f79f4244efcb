"""Time-sharded processing of one clip with a halo exchange between ranks
(counterpart of ``eagle_tpu/parallel/timeshard.py``).

When one clip's frames are split over ranks, the segment boundaries need
what the sequential step carries across them: the previous frame for the
flow, and the keypoint / homography state.  Both travel one rank to the
right over the ring (:func:`~eagle_tpu_torch.parallel.mesh.shift_right`,
the ``ppermute`` of the JAX package):

- :func:`halo_exchange_prev`: each rank receives its left neighbour's last
  frame, so the flow at a segment's first frame sees the true previous
  frame;
- :func:`timesharded_keypoint_scan`: the keypoint / homography steps with
  the two-pass warm start: pass 1 runs every segment from a cold carry,
  each later pass re-runs it from its left neighbour's final carry of the
  pass before.  Segments whose boundaries fall on refresh frames (the
  keypoint and homography cadences) are exact; otherwise the cold start's
  transient fades within one cadence interval.

Each segment's steps see their global frame index ``t``, which the RANSAC
draws fold in.  Track identities cannot be split mid-clip, so the tracker
stays clip-parallel (:mod:`eagle_tpu_torch.parallel.pipeline`).
"""

from __future__ import annotations

import torch

from eagle_tpu_torch.config import PipelineConfig
from eagle_tpu_torch.parallel.mesh import Mesh, shift_right
from eagle_tpu_torch.pipeline import temporal


def _ici_axis(mesh: Mesh) -> str:
    """Time sharding splits ONE clip's timeline, so its ring must stay on
    one host's links: a ``(dcn, data)`` mesh is refused; build a 1-D mesh
    over one host's ranks instead."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            "timeshard needs a 1-D (data,) mesh; build one per host with MeshConfig(hosts=1) over the host's "
            "ranks"
        )
    return mesh.axis_names[0]


def halo_exchange_prev(local_frames: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The previous-frame view of this rank's segment: ``local_frames`` (n,
    H, W, 3) -> prev with prev[0] the left neighbour's last frame (rank 0's
    own first frame) and prev[i] = local_frames[i - 1]."""
    _ici_axis(mesh)
    (from_left,) = shift_right([local_frames[-1:]], mesh)
    if mesh.index == 0:
        from_left = local_frames[:1]
    return torch.cat([from_left, local_frames[:-1]])


def timesharded_keypoint_scan(
    mesh: Mesh, cfg: PipelineConfig, base_key: int, xs_local: temporal.FrameInputs, passes: int = 2
):
    """The keypoint / homography part of the temporal steps over this rank's
    segment of a clip (``xs_local``: its frames' inputs as
    :func:`~eagle_tpu_torch.pipeline.temporal.scan_chunk` takes them, ``t``
    global, ``prev_frame_bgr`` from :func:`halo_exchange_prev`).  Each pass
    after the first sends the final ``kp_xy``, ``kp_valid``, ``H``, ``H_ok``
    and ``retry_h`` one rank to the right and re-runs warm from what it
    received; rank 0 stays cold.  Returns (kp_xy (n, 57, 2), kp_valid (n,
    57), H (n, 3, 3), H_ok (n,)) of this rank's frames;
    :func:`~eagle_tpu_torch.parallel.mesh.gather_batch` gives the clip's."""
    _ici_axis(mesh)
    dev = xs_local.frame_bgr.device
    final, outs = temporal.scan_chunk(temporal.init_carry(cfg, dev), xs_local, cfg, base_key)
    for _ in range(passes - 1):
        kp_xy, kp_valid, H, H_ok, retry = shift_right(
            [final.kp_xy, final.kp_valid, final.H, final.H_ok, final.retry_h], mesh
        )
        if mesh.index == 0:
            continue  # cold == sequential: a re-run gives the same outputs
        warm = temporal.init_carry(cfg, dev)._replace(kp_xy=kp_xy, kp_valid=kp_valid, H=H, H_ok=H_ok, retry_h=retry)
        final, outs = temporal.scan_chunk(warm, xs_local, cfg, base_key)
    return outs.kp_xy, outs.kp_valid, outs.H, outs.H_ok
