"""The temporal scan as one device program a chunk: the counterpart of the
JAX package's ``_run_chunk`` (``eagle_tpu/pipeline/coordinate_model.py``),
a ``jax.lax.scan`` of the temporal step over ``chunk_frames`` frames.

A :class:`StepGraph` holds one captured CUDA graph of
:func:`temporal.temporal_step_static` for one (configuration, frame
geometry, detection width, seed, reset rule, device), with its static
slots:

- the frame and the previous frame, copied in before each step (the flow
  kernel bakes the frames' addresses into its tensor maps when it is
  launched, so a replay reads the buffers that existed at capture);
- chunk-sized buffers of the per-frame inputs (the memoized keypoint
  rows, the detection rows, ``t`` and the two cadence flags), loaded once
  a chunk, read inside the graph at the step index;
- the carry, which the graph overwrites with the new carry as its last
  work, and the step index, which it advances;
- the chunk's packed outputs (:func:`temporal.pack_outputs`' layout), a
  row a step; with ``gmc="features"`` two more columns a row, the step's
  features-GMC tally (the fallback taken, the fit's inlier corners), which
  the chunk's drain reads with the outputs.

Every GMC runs inside the graph: the keypoint-flow fits, and the features
GMC's grid corners of the previous frame slot, their flow (the kernel's
K = 240 launch on the same static frame slots) and the robust fit, whose
fallback to the keypoint-flow affine is a ``torch.where``.

For each frame the host enqueues two device-to-device frame copies and a
replay: nothing is read back inside a chunk.  On the CPU the same object
runs :func:`temporal.temporal_step_static` on the same slots eagerly: the
explicit CPU path, which runs everything but the capture.

The kernels' wrappers count their launches through
:mod:`eagle_tpu_torch.ops.launch_counts`: a step captured inside its
counting scope (:func:`~eagle_tpu_torch.ops.launch_counts.counting`) holds
an increment of a device counter beside each counted kernel, so a replay
counts what it launches; a step captured outside it holds none.  The
warm-up step counts nothing.  The warm-up and the capture are the span
``setup:capture`` in the span log.  There is no fallback: a step that
cannot be captured raises.
"""

from __future__ import annotations

import torch

from eagle_tpu_torch.config import PipelineConfig
from eagle_tpu_torch.ops import launch_counts
from eagle_tpu_torch.ops.optical_flow import alloc_frames
from eagle_tpu_torch.pipeline import temporal
from eagle_tpu_torch.utils.profiling import StageTimer


def _leaves(carry: temporal.TemporalCarry) -> list[torch.Tensor]:
    return [*carry[:-1], *carry.tracker]


def _carry_of(leaves: list[torch.Tensor]) -> temporal.TemporalCarry:
    n = len(temporal.TemporalCarry._fields) - 1
    return temporal.TemporalCarry(*leaves[:n], tracker=temporal.botsort.TrackerState(*leaves[n:]))


def pack_row(out: temporal.FrameOutputs) -> torch.Tensor:
    """One frame's :class:`temporal.FrameOutputs` as a (1, F) float32 row,
    in :func:`temporal.pack_outputs`' layout."""
    return torch.cat([a.to(torch.float32).reshape(1, -1) for a in out], dim=-1)


class StepGraph:
    """The captured temporal step of one configuration (see the module's
    docstring).  ``frame_hw``: the frames' (H, W); ``det_rows``,
    ``det_width``: the detection rows a frame and their width (7, plus the
    appearance width when appearance is on); ``seed``: the RANSAC draws'
    seed; ``reset_on_t0``: the flattened multi-clip stream, whose carry
    restarts from :func:`temporal.init_carry` wherever ``t == 0``."""

    def __init__(
        self,
        cfg: PipelineConfig,
        frame_hw: tuple[int, int],
        det_rows: int,
        det_width: int,
        seed: int,
        reset_on_t0: bool,
        device,
    ):
        dev = torch.device(device)
        chunk = cfg.chunk_frames
        h, w = frame_hw
        self.cfg, self.seed, self.reset_on_t0, self.device, self.chunk = cfg, seed, reset_on_t0, dev, chunk
        self.appearance = bool(cfg.tracker.use_appearance)
        self.frames = alloc_frames(2, h, w, dev)
        self.frames.zero_()
        self.model_kp = torch.zeros(chunk, 57, 3, device=dev)
        self.model_kp_valid = torch.zeros(chunk, 57, dtype=torch.bool, device=dev)
        self.det = torch.zeros(chunk, det_rows, det_width, device=dev)
        self.t = torch.zeros(chunk, dtype=torch.int64, device=dev)
        self.is_kp_frame = torch.zeros(chunk, dtype=torch.bool, device=dev)
        self.is_h_frame = torch.zeros(chunk, dtype=torch.bool, device=dev)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.carry = _leaves(temporal.init_carry(cfg, dev))
        self.fresh = _leaves(temporal.init_carry(cfg, dev)) if reset_on_t0 else None
        #: the step's features-GMC tally (:func:`temporal._features_gmc_warp`)
        self.gmc_stats = torch.zeros(2, dtype=torch.int64, device=dev) if cfg.tracker.gmc == "features" else None
        width = temporal.packed_width(cfg.tracker.max_tracks) + (2 if self.gmc_stats is not None else 0)
        self.out = torch.zeros(chunk, width, device=dev)
        self.graph = None
        #: seconds the warm-up and the capture took (None on the CPU): its
        #: ``setup:capture`` span
        self.capture_s: float | None = None

    # ------------------------------------------------------------------

    def _step(self) -> None:
        """One step on the slots: the work the graph holds."""
        i = self.index.view(1)

        def pick(buf):
            return buf.index_select(0, i)[0]

        row = pick(self.det)
        xs = temporal.FrameInputs(
            frame_bgr=self.frames[1],
            prev_frame_bgr=self.frames[0],
            model_kp=pick(self.model_kp),
            model_kp_valid=pick(self.model_kp_valid),
            is_kp_frame=pick(self.is_kp_frame),
            is_h_frame=pick(self.is_h_frame),
            det_boxes=row[:, :4],
            det_conf=row[:, 4],
            det_cls=row[:, 5].to(torch.int64),
            det_valid=row[:, 6] > 0.5,
            t=pick(self.t),
            det_embed=row[:, 7:] if self.appearance else None,
        )
        leaves = self.carry
        if self.reset_on_t0:  # the JAX package's reset_on_t0 select
            first = xs.t == 0
            leaves = [torch.where(first, f, c) for f, c in zip(self.fresh, leaves)]
        new, out = temporal.temporal_step_static(_carry_of(leaves), xs, self.cfg, self.seed, self.gmc_stats)
        new = _leaves(new)
        for dst, src in zip(self.carry, new):
            if dst is not src:
                dst.copy_(src)
        row = pack_row(out)
        if self.gmc_stats is not None:
            row = torch.cat([row, self.gmc_stats.to(torch.float32).view(1, 2)], dim=-1)
        self.out.index_copy_(0, i, row)
        self.index += 1

    def _capture(self) -> None:
        """Warm-up step on a side stream (the kernels' libraries, the
        libraries' handles, the constants' device copies and the launch
        counters), which counts nothing, then the capture, which runs
        nothing.  The warm-up runs on the slots as they are and advances
        them: :meth:`run_chunk` captures before it loads a chunk."""
        with StageTimer.span("setup:capture") as span:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), launch_counts.paused():
                self._step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's work on the card (a served clip's
            # Processor) goes on while the step is captured
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step()
            self.graph = graph
            torch.cuda.synchronize(self.device)
        self.capture_s = span.seconds

    # ------------------------------------------------------------------

    def run_chunk(
        self,
        carry: temporal.TemporalCarry,
        frame_pair,
        model_kp: torch.Tensor,
        model_kp_valid: torch.Tensor,
        det: torch.Tensor,
        t: torch.Tensor,
        is_kp_frame: torch.Tensor,
        is_h_frame: torch.Tensor,
    ) -> tuple[temporal.TemporalCarry, torch.Tensor]:
        """The steps of one chunk of L <= ``chunk_frames`` frames from
        ``carry``: the per-frame inputs are device tensors with a leading
        axis of L (``det`` (L, D, width)), ``frame_pair(i)`` gives step i's
        (previous frame, frame).  Returns (the carry after the chunk, the
        (L, F) packed outputs, with ``gmc="features"`` the tally's two
        columns after them), copies on the device; nothing is read on the
        host."""
        n = len(t)
        if not 0 < n <= self.chunk:
            raise ValueError(f"a chunk holds 1 to {self.chunk} frames, got {n}")
        if self.device.type == "cuda" and self.graph is None:
            self._capture()
        for dst, src in zip(
            (self.model_kp, self.model_kp_valid, self.det, self.t, self.is_kp_frame, self.is_h_frame),
            (model_kp, model_kp_valid, det, t, is_kp_frame, is_h_frame),
        ):
            dst[:n].copy_(src)
        for dst, src in zip(self.carry, _leaves(carry)):
            dst.copy_(src)
        self.index.zero_()
        for i in range(n):
            prev, cur = frame_pair(i)
            self.frames[0].copy_(prev)
            self.frames[1].copy_(cur)
            if self.graph is None:  # the CPU: the step itself
                self._step()
            else:
                self.graph.replay()
        return _carry_of([c.clone() for c in self.carry]), self.out[:n].clone()
