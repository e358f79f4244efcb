#!/usr/bin/env python3
"""Drive the PyTorch port (eagle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile PATH.json]

Phases (any failure exits non-zero, nothing is caught):

1. build: the CUDA kernels (nvcc, sm_90a: the LK flow, the JV
   assignment, the auction, NMS's suppression, the RANSAC keys and the
   DLT's eigen solve) and the host C++ (g++:
   the prescale and the float64 JV), in parallel, from the sources in this
   checkout;
2. kernel: every kernel of the main path against its plain PyTorch
   version on the same CUDA tensors at the main path's shapes -- the LK
   flow kernel, the whole flow step in one launch, at K = 57 points on the
   544x960 canvas: status bit-equal, positions within 1e-2 px, exactly one
   device kernel a call -- plus timings: the kernel's device time (from
   the profiler's trace), the call's and the plain version's (CUDA
   events), and the bound;
3. reference: the slice on the card against the port's plain CPU path on
   a 12-frame clip with oracle models that know the clip's geometry, and
   the tracked keypoints against the true landmark pixels; then the same
   with calibration on (the brightness snap moves the keypoints that lie
   on dim grass), card against CPU again;
4. slice: ``CoordinateModel(device="cuda").get_coordinates`` on 48 frames
   of 1280x720 at 24 fps with seeded full-width YOLOv8-l (960) and
   HRNet-W48 (540x960) in bfloat16, the YOLO class bias tuned to a
   broadcast-like detection count; the launch counters are zeroed just
   before and read just after, and every kernel must have launched (the
   auction 3 times a temporal step, its device-side round tally read
   after a synchronize, NMS once a 16-frame detector batch); the output
   must hold one dict per frame with the four keys; the bf16 models must
   agree with their float32 selves on one batch.  The wrappers count
   through ``ops/launch_counts.py``: on the card's default path the step
   is a captured graph, and each replay adds to device counters beside the
   kernels it runs.  Then the slice once more under the profiler, counts
   zeroed just before: every kernel's launch count must equal the device
   kernels of its name in that trace, and the timed run's counts;
4b. loops (the kernel phase's second half, after the slice: it needs the
   slice model): the device loops' kernels against their plain versions on
   the card.  The auction kernel (one block a matrix, every round inside
   it, the rows in registers) on the tracker's own solves, recorded in a run of the slice model
   on 16 frames (93 matrices of 64 x 192, all three stages), on the
   ``utils/kernel_cases.py`` kinds (sparse, random, tied, a tied block,
   infeasible rows) at 64 x 128, R > C and R < C, a tied block capped at
   1, 2 and 3 rounds, and one B = 4 launch against 4 single launches:
   matches and round counts bit-equal to ``auction_rounds_plain`` on CPU
   copies; ``masked_auction`` makes no host sync; device ms a launch (the
   profiler's trace; one device kernel a call) by stage with its rounds,
   the eager loop's ms on the same CUDA tensors and the bound; device ms
   a launch of kernel_cases problems of 0, 1, 4 and 11 rounds, and so a
   round's cost.  The NMS kernel (the overlap bits over the card, then the
   fixed point in a block an image: two device kernels a launch) on the
   slice's 16-frame detector batch (16 x 512) and the kernel_cases images
   (IoU exactly at the threshold and one float32 step above, a 12-link
   chain, an empty and an overflowing image), keep bit-equal to
   ``suppress_plain``, and on one image each of 1025, 2048, 4096 and
   10,710 clustered candidates (thousands valid) against
   ``suppress_plain`` on the same CUDA tensors; ``batched_nms`` makes no
   host sync; device ms a launch, the plain version's ms and the bound,
   the earlier one-block designs' recorded times beside them; then one
   ``get_coordinates`` of the slice model on 16 frames at
   ``nms_pre_topk=2048`` (one NMS launch a batch at that width) equals
   the same run at 512;
4c. graph (after the loops): the temporal scan as the JAX package runs
   it, one device program a ``chunk_frames`` chunk, here a captured CUDA
   graph of the step replayed frame by frame
   (``pipeline/step_graph.py``): (a) the 48-frame slice, (b) the 12-frame
   oracle clip, (c) the slice with ``assignment="exact"``, each run
   through the captured chunks and through the eager loop (the private
   ``_temporal_path``) on the card: the two dicts bit-equal, the temporal
   stage's ms a frame (synchronised) both ways, its blocking calls a frame
   both ways and inside the chunks' replays (must be 0), the capture's
   seconds and the launches a step, counted in the timed runs (a captured
   step's 1 flow, 3 auction or JV, 1 keys and 2 eigen launches, and the
   eager loop's flow and solver launches alike); the slice's traced run's
   device kernels, busy ms and idle share a step; then the RANSAC keys kernel
   (``csrc/threefry.cu``) bit-equal to its plain version at 512 x 57, and
   the DLT's eigen-solve kernel (``csrc/eigh9.cu``) on the slice's own
   normal matrices (512 hypotheses and the refit) against
   ``torch.linalg.eigh`` up to sign, each with its device time, the plain
   version's (and ``torch.linalg.eigh``'s) and the bound.  The slice phase
   already ran through the captured chunks (the card's default) and counts
   one keys and two eigen-solve launches a step;
5. process: the CLI's function (``eagle_tpu_torch.main.run``) from 48
   host frames of a match (the slice's frames with 22 players in two kits
   and a ball drawn over them, oracle models that know them) to the four
   JSON files in a temporary directory, on the card: ``get_coordinates``,
   then the ``Processor`` with its team votes on the card; the launch
   counters are zeroed just before and read just after; the run's votes
   must equal the plain CPU votes on the same crops bit for bit, the team
   mapping, the table and the formatted records must equal the port's CPU
   Processor's on the same coordinates, and the mapping must split the
   players by kit; the files must parse back to them.  Prints the
   Processor's stage milliseconds and the frames-to-files rate.  The run
   takes frames in memory;
5b. cli, where OpenCV imports: the CLI from an .mp4.  (a)
   ``eagle_tpu_torch.main.main(["--video_path", ...])`` in this process
   on the match written as a 48-frame 1280x720 mp4 by ``io.write_video``,
   with oracle models keyed on the decoded frames: the four JSON files
   bit-equal to ``main.run`` on ``read_video_array`` of the same file on
   the card, within 1 px / 1 m of the CPU run (the metadata equal),
   annotated.mp4 decoded back to 48 frames of 1280x720, and
   ``--segment_frames 16`` bit-equal to the whole run, its lazy frame
   source's opens and decoded frames counted; ms a frame of decode,
   ``get_coordinates``, the Processor and the files, render plus encode.
   (b) the CLI as users start it: the slice model's weights saved as
   ``.msgpack`` files, then ``python -X importtime -m eagle_tpu_torch.main
   --video_path --fps 24 --keypoint_weights --detector_weights
   --num_homography 24 --profile`` (a homography every frame: see
   ``CLI_HOMOGRAPHIES``)
   as a child process from an empty directory (this checkout on
   ``PYTHONPATH``), whole and with ``--segment_frames 16``: rc 0, the five
   files, no JAX module imported, no kernel rebuilt, the four JSON files
   bit-equal to ``main.run`` / ``main.run_streamed`` in this process with a
   model built from the same files; the wall, the fps from the mp4 to the
   files with and without the process start, the ``--profile`` stage table
   and the in-process run's flow, auction and NMS launches;
6. tracker: the reference's tracker, OSNet-x0.25 ReID association and
   the features GMC (grid corners of the previous frame tracked by the
   same flow kernel at K = 240, a robust 4-DOF fit): (a) the kernel at
   K = 240 on the grid corners of a frame pair, raw 1280x720 and on the
   544x960 canvas, against its plain version (status bit-equal, positions
   within 1e-2 px; neither frame is staged into a pitched copy), with its
   device time, the plain version's and the bound on the canvas; (b) the
   12-frame oracle clip with the features GMC and float32 OSNet, card
   against the plain CPU path, and the embeddings' largest difference;
   (c) the full-width 48-frame slice with bf16 OSNet (512-d embeddings of
   the first 64 detection slots) and the features GMC, launch counters
   zeroed just before and read just after (K = 57 and K = 240 apart),
   with its rate and stage milliseconds, ``reid`` among them, and the
   auction's and NMS's launches and device rounds; (d) the bf16
   OSNet's embeddings against its float32 self on one piece;
7. exact (after the tracker phase): the JV assignment kernel behind
   ``TrackerConfig.assignment="exact"``: (a) on tracking-like matrices
   (the tracker's extended matrices from the slice model's detections on
   the slice's frames) and random ones at n = 192 (the main path's size,
   the cost staged in shared memory), n = 300 (read from global memory)
   and, random only, n = 1025 (more than 32 columns a lane: the column
   vectors in shared memory), and as one launch over 4 matrices: indices
   bit-equal to the
   plain version on copies on the CPU, the batched launch to single
   launches, totals equal to scipy's ``linear_sum_assignment`` and the
   host JV's (float64) within 1e-5; device ms a launch, augmenting steps,
   ns a step, the bound, the plain version's and scipy's host ms, and
   ``-Xptxas -v``'s registers and spills of the three instantiations
   launched (one warp a matrix, K columns a lane); (b) the 12-frame
   oracle clip with the exact solver (24 track and 32 detection slots),
   card == plain CPU path, 3 launches a temporal step; (c) the full-width
   slice with the exact solver on the slice model's weights: fps, stage
   ms, launches (3 a step, shared path, no auction launch), then both
   solvers' slices under the profiler (the temporal step's and the
   detector stage's blocking calls and idle shares, the launches and
   device time of the JV, auction and NMS kernels) and the share of
   frames whose track ids differ from the auction slice's;
8. stream: (a) the 24-frame oracle clip streamed on the card at
   ``chunk_frames=16`` in ragged segments (blocks of 16 + 8) equals the
   card's one-shot run exactly and the port's CPU stream within the REF_*
   tolerances, with no frame staged into a pitched copy; (b) the
   full-width slice's 48 frames streamed with the slice model's weights in
   segments 10 + 23 + 15 (blocks of 32 + 16) equal the slice phase's
   one-shot result exactly, no frame staged, launch counters zeroed just
   before and read just after (its fps, stage ms, launches, the auction's
   device rounds and the on-demand rounds of both runs printed); (c) the
   peak device memory of
   the same model streaming 96 frames in blocks of 32 must be within 10%
   of its 48-frame stream's (printed beside the 48-frame one-shot's);
   (d) ``serve_clips(overlap=True)`` over three 16-frame clips of the
   process phase's match with oracle models equals a sequential
   ``get_coordinates`` + ``Processor`` of each clip on the card (clips a
   second of both orders printed); (e) the slice's HRNet-W48 and YOLOv8-l
   written as the reference's ``.pth`` and an ultralytics ``.pt``
   (``tests/torch_parity.py``) load back through
   ``CoordinateModel(keypoint_checkpoint=, detector_checkpoint=)`` with
   bit-equal state dicts and the same ``get_coordinates`` on 16 frames;
9. multi-clip: (a) the clip-batched launch of the flow kernel
   (``lk_flow_clips``), 4 pairs of consecutive raw 1280x720 frames in one
   launch at K = 57 and K = 240 (grid corners), against the plain version
   pair by pair (status bit-equal, positions within 1e-2 px) and against 4
   single launches (bit-equal), with its device time, the single launches'
   and the bound; (b) ``MultiClipRunner`` on the flattened path with the
   slice's weights, make_frames(96) split as [48, 48] and [48, 40]: each
   clip equals its own ``get_coordinates`` on the card exactly, fps against
   the sequential runs, the auction and NMS kernels launched; (c) on the
   clip-batched path with oracle models on
   raw frames, clips [24, 24, 20, 12], the default tracker and the features
   GMC: each clip equals its own run on the card, the card run equals the
   CPU's, one batched launch a step for all clips (counters zeroed just
   before and read just after), the auction launched every step and NMS
   never (oracle detections), fps against sequential;
10. prescale: the slice model on 640x360 and 854x480 frames (the 4:2:0
   letterbox outside the fused kernel's envelope), their canvases equal to
   the CPU host path's bytes; ``prescale="device"`` on the slice's frames
   within 4 LSB of the host canvas; prescale ms a frame, host against
   device; (stream phase (c) also reads the one-shot peak at 48 and 96
   frames: it may grow by the 48 canvases plus 5%);
11. multi-device (``eagle_tpu_torch/parallel``, torch.distributed): (a) a
   one-rank NCCL group: ``MultiClipRunner(model, mesh=make_mesh())`` on the
   slice's weights over make_frames(96) as clips [48, 48] (its results
   gathered by NCCL's ``all_gather``) equals the runner without a process
   group exactly, flow, auction and NMS launches counted around it; the
   time-sharded
   keypoint scan of the slice's 48 frames (oracle keypoints every 8
   frames, a homography every 24, the oracle players) over the one rank
   equals ``scan_chunk`` (the one-rank identity: at size 1 the halo and the
   warm start send no message and the rank runs one cold pass, so this
   checks the plumbing and NCCL's gather, not the ring; NCCL's
   ``batch_isend_irecv`` ring needs two cards and never runs here); (b) two
   gloo ranks spawned on the one card (NCCL
   refuses two ranks on one device), each loading the slice's weights:
   clips [48, 40] over the two ranks, each clip equal to its own
   ``get_coordinates`` in this process; the halo exchange of the 48 frames
   bit-equal to the frames shifted by one; the time-sharded scan over 2 x
   24 frames (boundaries on both cadences) equal to (a)'s ``scan_chunk``;
   each rank's flow launches (counted around its run, > 0), its peak device
   memory and wall time, and the phase's; a failing rank fails the run;
12. eval (after the prescale phase): (a) the eval CLI's body,
   ``eagle_tpu_torch.evaluate.run``, with the slice model (the default
   configuration: YOLOv8-l at 960 and HRNet-W48 at 540x960, bf16, seeded)
   on 32 frames of 1280x720 of the port's synthetic scene
   (``utils/synthetic.py``, drawn without OpenCV), run twice: the
   ``results.json`` keys against the reference artifact's schema, one NMS
   launch a ``_default_detector_fn`` call, and the metrics of the card's
   predictions equal within 1e-12 to those of the same predictions as host
   numpy arrays; each model's ms a frame, printed beside the card's name
   and power limit; (b) runners that return the scene's truth: acc@2px and
   F1@2 of 1.0 for both models and a box IoU of 1.0; (c) the acceptance
   runner, ``validate_acceptance --dry-run --frames 2``, on the card: exit
   0, the four gates PASS, gate C against ``cv2.findHomography`` where
   OpenCV imports and the float64 DLT (``numpy_dlt``) where it does not;
   then gate C alone with OpenCV hidden: PASS against ``numpy_dlt``; (d)
   where OpenCV imports, the eval CLI's ``--video`` / ``--labels`` mode on
   an mp4 of the scene written by ``io.write_video``, with the default
   model built on the card;
13. bench: the port's end-to-end bench, ``python -m eagle_tpu_torch.bench
   --reps 2``, as a child process (the four paths at full width on the
   synthetic 1280x720 scene with the scene's truth behind every real
   forward): exit 0, ``status`` "ok", every headline key, the card's name
   in ``device``, and the flow, auction and NMS kernels launched on every
   path (the JV kernel never); its headline printed;
14. with ``--profile``: one more run of the slice (24 frames) under
   ``torch.profiler``, and one of the tracker's slice, each summarised per
   stage (device busy and idle share, host time blocked in synchronising
   calls) into a JSON file: the given one, and the same name with
   ``_tracker`` appended; each prints the temporal step's and the detector
   stage's blocking calls.

The frames are made here from a fixed seed with numpy/scipy: a green
pitch texture with white lines, panned 1-2 px per frame, whose line
intersections are known tracking points.

Output: per-stage milliseconds and frames per second, a ``decoders:``
line (which of NVDEC's and NVENC's libraries, ``ffmpeg``,
``torchvision.io``, ``torchcodec`` and PyAV this machine has; information
only), one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

N_FRAMES = 48
FPS = 24
FRAME_HW = (720, 1280)
SEED = 0
#: LK status must match exactly; positions within the bar the JAX package
#: sets between its two flow engines (tests/test_pallas_flow.py)
FLOW_ATOL = 1e-2
#: bf16 vs float32 model outputs on the same batch of 8 frames, largest
#: absolute difference.  HRNet heatmaps are sigmoid probabilities; YOLO
#: boxes are pixels on a 960-wide canvas and scores sigmoid probabilities.
#: Each limit is 2.5-5 times the reading of sound runs of this script on an
#: H100 (PERF.md): heatmaps 4.3e-4, boxes 0.048 px, scores 0.093.  The
#: scores' error is large because the seeded YOLO's features fade through
#: the depth, bf16 keeps 8 bits of them, and the class head is scaled up
#: to a spread of CLS_LOGIT_STD logits (see spread_weights).
BF16_HEATMAP_ATOL = 2e-3
BF16_SCORE_ATOL = 0.25
BF16_BOX_ATOL = 0.25
#: bf16 vs float32 OSNet embeddings (L2-normalised, 512-d) of the valid
#: detections of one piece of the tracker's slice, largest absolute
#: difference: about 5 times the reading of the first runs on an H100,
#: 1.06e-2 (PERF.md)
BF16_EMBED_ATOL = 0.05
#: detection slots the tracker phase's reference clip embeds: its six
#: players (and two empty slots), which keeps the CPU side of the check short
REF_REID_SLOTS = 8
#: the slice on the card against its plain CPU path on a short clip:
#: keypoints, classes and track ids equal; boundaries (metres) within
#: 1 cm; boxes (pixels) and pitch positions (metres), both integers, within
#: 1.  Reported keypoints of landmarks in view within 6 px of their true
#: pixels: positions are truncated to integers at the oracle and after
#: each of the up to 3 flow steps between cadence frames (every 4th frame),
#: so each axis may lag by up to 4 px (5.7 px diagonally).
REF_FRAMES = 12
REF_BOUNDARY_ATOL = 1e-2
REF_TRUTH_PX = 6.0
#: frames of the profiled run (--profile)
PROFILE_FRAMES = 24
#: device ms a launch of the earlier one-block designs of the two loop
#: kernels on the main path, by the auction's stage: values recorded in
#: PERF.md section 6 (an H100 80GB HBM3 at 700 W), not measured by this
#: script, printed on the kernel lines marked as recorded and kept out of
#: the kernels line; ``python -m eagle_tpu_torch.utils.loop_bench --other
#: LABEL=DIR`` times two versions of the sources in one process
RECORDED_EARLIER_MS = {"auction": {1: 0.0090, 2: 0.0049, 3: 0.0037}, "nms": 0.0245}
#: the detector's pre-NMS candidates in the loops phase's wider run
WIDE_PRE_TOPK = 2048
#: the JV kernel's main-path size: DEFAULT_CONFIG's 64 track slots + 128
#: detection slots, the extended square matrix of masked_assignment
LAP_N = 192
#: a size whose cost matrix exceeds a block's shared memory (the global path)
LAP_N_GLOBAL = 300
#: the first size with more than 32 columns a lane (the vectors in shared memory)
LAP_N_WIDE = 1025
#: tracking-like matrices of the exact phase, and the batched launch's B
LAP_PAIRS = 4
#: the kernel's optimum against scipy's and the host JV's, relative
LAP_RTOL = 1e-5
#: track and detection slots of the exact solver's oracle clip (n = 56: the
#: CPU side's plain version takes ~10k Python steps a solve at n = 192)
EXACT_REF_SLOTS = (24, 32)
#: the multi-clip phase: frame pairs of the clip-batched launch, the
#: flattened path's splits of make_frames(96) (the JAX bench's two 48-frame
#: clips, and a ragged pair), the clip-batched path's clip lengths
MC_PAIRS = 4
MC_SPLITS = ([48, 48], [48, 40])
MC_LENS = [24, 24, 20, 12]
#: the multi-device phase: (a) one NCCL rank on make_frames(96) as two
#: clips; (b) two gloo ranks sharing the card, one clip each, and the
#: time-sharded scan of the slice's frames in segments of MD_SEGMENT, its
#: keypoint and homography cadences dividing the segment (so it is exact)
MD_CLIPS_A = [48, 48]
MD_CLIPS_B = [48, 40]
MD_RANKS = 2
MD_SEGMENT = 24
MD_KP_EVERY, MD_H_EVERY = 8, 24
#: the device prescale (prescale="device") against the host canvas, and
#: the port against the JAX package's device letterbox, largest byte
#: difference: measured at most 4 on noise frames
#: (tests/test_torch_prescale_paths.py)
PRESCALE_LSB = 4
#: the one-shot run's peak device memory may grow from 48 to 96 frames by
#: the 48 more 544x960 BGR canvases, plus 5%
CANVAS_BYTES = 544 * 960 * 3
#: the stream phase's oracle clip, and the length of each served clip
STREAM_REF_FRAMES = 24
#: the eval phase's clip: the eval CLI's default frame count
EVAL_FRAMES = 32
SERVE_CLIP = 16
#: the cli phase's --segment_frames
CLI_SEGMENT = 16
#: the bench phase's timed reps and wall budget (seconds; the bench cuts
#: reps, then its untimed runs, when the budget runs short)
BENCH_REPS = 2
BENCH_BUDGET_S = 150
#: the full-width CLI's --num_homography: a homography every frame.  With
#: the seeded weights the keypoints are noise, and a homography fitted to
#: them can project the image corners so close that the visible pitch's
#: boundaries are undefined; when no frame has them, both packages'
#: Processors raise KeyError('Bottom_Left') (the default, one a second, fits
#: two in 48 frames)
CLI_HOMOGRAPHIES = 24
#: a fresh process's (cuDNN, cuBLAS) TF32 switches, read before this
#: script turns them off: the cli phase's child processes run with them
DEFAULT_TF32 = (True, False)
#: the process phase's match (make_match): outfield players a team, drawn
#: in the two kits of the JAX package's synthetic scenes (BGR red and
#: blue), plus one goalkeeper a team (yellow, purple)
MATCH_PLAYERS = 10
KITS = [(40, 40, 215), (200, 140, 30)]
GK_KITS = [(30, 220, 230), (150, 40, 150)]
#: detections a frame kept at the detector's keep threshold that the
#: seeded YOLO's class bias is tuned to: a broadcast frame shows about 20
#: outfield players, the goalkeepers, 2-3 referees and the ball
TARGET_DETECTIONS = 25
#: spread (standard deviation over anchors) of the seeded YOLO's class
#: logits.  A trained detector puts objects and background several logits
#: apart, so few boxes score between NMS's floor (0.15) and the keep
#: threshold (0.35); at a spread of 1 such boxes fill the 128 slots
CLS_LOGIT_STD = 4.0
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32 (non
#: tensor-core) instructions/s.  The sheet's 67 TFLOP/s counts a fused
#: multiply-add as two operations; the flow kernel is built with
#: -fmad=false, so its multiplies and adds are separate instructions, and
#: one instruction (multiply, add or fused multiply-add) a lane a cycle,
#: 132 SMs x 128 lanes x 1.98 GHz, is half that rate
PEAK_BYTES_S = 3.35e12
#: the H100 SXM's int32 rate outside the tensor cores: 64 lanes an SM (half
#: the float32 lanes) x 132 SMs x 1.98 GHz
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9
#: float32 operations a second outside the tensor cores (the data sheet's 67
#: TFLOP/s)
PEAK_FP32_OPS_S = 67e12
#: integer operations of one threefry2x32 hash (20 rounds of an add, a
#: rotate (two shifts and an or) and a xor; 5 key injections of three adds;
#: the two initial adds), and the keys kernel's per-element xor and shift
KEYS_OPS_PER_HASH = 20 * 5 + 5 * 3 + 2
#: float32 operations of one symmetric 9x9 eigenvector solve at the least:
#: the tridiagonal reduction (4/3 n^3), its QR steps (~6 n^2) and the
#: vector's back-transform (2 n^2)
EIGH_OPS = 4 * 9**3 // 3 + 8 * 9**2
#: the eigen-solve kernel against torch.linalg.eigh up to sign, on matrices
#: whose two smallest eigenvalues lie EIGH_GAP of the largest apart
#: (float32 eigenvectors then hold ~1e-4: 6e-8 / 1e-3, cuSOLVER's
#: rounding), and its residual |A v - lambda v| / |A| (float64) on all
EIGH_GAP = 1e-3
EIGH_ATOL = 1e-3
EIGH_RESID = 1e-4
PEAK_F32_INSTR_S = 33.5e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


class _LaunchCounts:
    """``eagle_tpu_torch.ops.launch_counts``, imported at first use: the
    script starts, and refuses to run, where the package is not."""

    def __getattr__(self, name):
        from eagle_tpu_torch.ops import launch_counts

        return getattr(launch_counts, name)


#: the kernels' launch counts (every wrapper counts through this registry)
lc = _LaunchCounts()


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# synthetic broadcast-like frames (numpy/scipy only)
# ---------------------------------------------------------------------------


def make_frames(n: int, hw=FRAME_HW, seed: int = SEED, pan: float = 1.5):
    """(frames (n, H, W, 3) uint8 BGR, points (n, P, 2) float32 x, y of the
    white-line intersections in each frame)."""
    from scipy.ndimage import gaussian_filter

    h, w = hw
    rng = np.random.default_rng(seed)
    offs = np.round(pan * np.arange(n)).astype(int)
    W = w + int(offs[-1]) + 1
    tex = gaussian_filter(rng.normal(size=(h, W)), 2.5)
    tex = 9.0 * tex / tex.std()
    cols = np.arange(W)[None, :]
    rows = np.arange(h)[:, None]
    stripes = np.where((cols // 96) % 2 == 0, 0.0, -9.0)
    green = np.array([60.0, 140.0, 70.0])
    img = green[None, None, :] + (tex + stripes)[..., None]
    xs = np.arange(150, W - 100, 260, dtype=float)
    ys = np.array([0.2, 0.45, 0.72, 0.9]) * h
    white = np.zeros((h, W), bool)
    for x in xs:
        white |= np.abs(cols - x) <= 2
    for y in ys:
        white |= np.abs(rows - y) <= 2
    cx, cy = xs[len(xs) // 2] + 130.0, ys[1]
    rad = np.hypot(cols - cx, rows - cy)
    white |= np.abs(rad - 90.0) <= 2
    img[white] = 235.0
    world = np.clip(np.round(img), 0, 255).astype(np.uint8)
    frames = np.stack([world[:, o : o + w] for o in offs])
    gx, gy = np.meshgrid(xs, ys)
    pts_w = np.stack([gx.ravel(), gy.ravel()], -1)
    pts = np.stack([pts_w - [o, 0] for o in offs]).astype(np.float32)
    return np.ascontiguousarray(frames), pts


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> str:
    """Builds the kernels and the host libraries, all at once; prints and
    returns the CUDA kernels' compiler output (``-Xptxas -v``; empty for a
    library already built in this checkout)."""
    from eagle_tpu_torch import native
    from eagle_tpu_torch.ops import assignment, eigh, nms, optical_flow, prng

    t0 = time.perf_counter()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below; the phase fails
            errors.append(e)

    threads = [
        threading.Thread(target=run, args=(native._load_prescale,)),
        threading.Thread(target=run, args=(native._load_lapjv,)),
        threading.Thread(target=run, args=(lambda: optical_flow.build(verbose=True),)),
        threading.Thread(target=run, args=(lambda: assignment.build(verbose=True),)),
        threading.Thread(target=run, args=(lambda: assignment.build_auction(verbose=True),)),
        threading.Thread(target=run, args=(lambda: nms.build(verbose=True),)),
        threading.Thread(target=run, args=(lambda: prng.build(verbose=True),)),
        threading.Thread(target=run, args=(lambda: eigh.build(verbose=True),)),
    ]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):  # the verbose builds print their compiler output
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    print(log.getvalue(), end="")
    if errors:
        raise errors[0]
    print(f"build: {time.perf_counter() - t0:.1f} s")
    return log.getvalue()


def lk_flow_work(origin, hw, side: int, record, levels: int = 2, window: int = 15) -> tuple[int, int, int]:
    """(bytes, arithmetic instructions, live Newton steps) of one flow
    step, for the K points whose ROI ``origin`` (K, 2) the plain version
    computed and whose engine run filled ``record`` (:func:`engine_plain`).
    Bytes: the BGR bytes of the union of the K ROIs in each frame, each
    read once, plus the points and ``valid`` read and the outputs (g,
    status) written.  Instructions, each a multiply, an add or a fused
    multiply-add: the gray over the union of the ROIs in each frame (4 a
    pixel: a multiply, two fused multiply-adds and the rounding); per
    point pyrDown as ``pyr_down`` computes it (8 an output pixel of each
    axis pass, both frames) and the engine: per level the previous patch
    (~20 a tap), Scharr gradients (~24 a tap) and the structure tensor (6
    a tap), plus ~25 a tap for every live Newton step."""
    from eagle_tpu_torch.ops.optical_flow import level_sizes

    h, w = hw
    k = len(origin)
    union = np.zeros((h, w), bool)
    for x0, y0 in np.asarray(origin.cpu()).tolist():
        union[y0 : y0 + side, x0 : x0 + side] = True
    n_union = int(union.sum())
    # 3 B a pixel in each frame; pts and valid read, g and status written
    nbytes = 2 * 3 * n_union + k * (8 + 1) + k * (8 + 1)
    sizes = level_sizes(side, levels)
    pyr_ops = sum(8 * (s * sd + sd * sd) for s, sd in zip(sizes, sizes[1:]))
    live_steps = sum(int(live.sum()) for _, kind, _, live in record if kind == "curr")
    ext = window + 2
    setup = ext * ext * 20 + window * window * (24 + 6)
    ops = 2 * 4 * n_union + k * (2 * pyr_ops + len(sizes) * setup) + live_steps * window * window * 25
    return nbytes, ops, live_steps


def flow_input(frames, pts):
    """The flow step's K = 57 input on the 544x960 canvas: frames 0 and 6
    of the clip through the slice's 4:2:0 prescale and decode, the line
    intersections in view, 8 points on and near the borders, random points
    for the rest; ``valid`` false for one point."""
    import torch

    from eagle_tpu_torch.ops.preprocess import compute_work_geometry, host_letterbox_i420, i420_to_bgr

    dev = torch.device("cuda")
    geom = compute_work_geometry(FRAME_HW, 960)
    canvas = i420_to_bgr(torch.from_numpy(host_letterbox_i420(frames[[0, 6]], geom)).to(dev))
    ch, cw = geom.canvas_h, geom.canvas_w
    rng = np.random.default_rng(SEED + 1)
    inter = pts[0] * geom.gain + [geom.pad_x, geom.pad_y]
    inter = inter[(inter[:, 0] > 0) & (inter[:, 0] < cw - 1)]
    borders = np.array(
        [[0.5, 0.5], [cw - 1.5, ch - 1.5], [3.0, 270.0], [cw - 4.0, 9.0], [480.25, ch - 2.0],
         [96.0, 96.0], [cw - 97.0, ch - 97.0], [190.7, 4.2]],
        np.float32,
    )
    rand = rng.uniform([0, 0], [cw - 1, ch - 1], (57 - len(inter) - len(borders), 2))
    p = torch.from_numpy(np.concatenate([inter, borders, rand]).astype(np.float32)).to(dev)
    assert p.shape[0] == 57, p.shape
    valid = torch.ones(57, dtype=torch.bool, device=dev)
    valid[5] = False
    return canvas[0], canvas[1], p, valid


#: profiler sessions tried before a flow timing falls back to CUDA events,
#: and runs of a main path traced before its traced launches must equal
#: its counted ones
TRACE_ATTEMPTS = 3
#: the kernels a temporal step launches, by the names their launches count
#: under
STEP_KERNELS = ("lk_flow", "auction", "lap_jv", "ransac_keys", "eigh9")


def traced_flow(call, reps: int, kernel: str = "lk_flow", count: str = "lk_flow") -> dict:
    """``reps`` calls of ``call()`` under ``torch.profiler``: the device
    operations in the trace (kernels, copies and sets), the durations (us)
    and (start, end) spans of the flow kernels among them (every kernel
    whose name holds ``kernel``), and the launches counted meanwhile
    under ``count`` (``launch_counts``).  On the H100 the profiler
    has been seen to miss one launch of 20, and once to trace no device
    activity at all in a session: a trace that holds fewer flow kernels
    than were launched is taken again, up to TRACE_ATTEMPTS sessions, and
    the fullest one is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eagle_tpu_torch.utils.profiling import trace_events

    best: dict | None = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        launches0 = lc.get(count)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        launched = lc.get(count) - launches0
        ops = [e for e in trace_events(prof) if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        mine = [e for e in ops if e["cat"] == "kernel" and kernel in e["name"]]
        flow = [e["dur"] for e in mine]
        if best is None or len(flow) > len(best["flow"]):
            best = {"ops": ops, "flow": flow, "spans": [(e["ts"], e["ts"] + e["dur"]) for e in mine],
                    "launched": launched}
        if len(flow) >= launched:
            break
    return best | {"sessions": attempt}


def flow_step_timing(of, prev, curr, p, valid, reps: int = 20) -> dict:
    """One flow step (``of.lk_flow``) on CUDA tensors, from the profiler's
    trace over ``reps`` calls (:func:`traced_flow`): the launches a call
    (the wrapper's count), the flow kernels and the other device
    operations traced, and the flow kernel's device time a launch, the
    mean over the traced ones; the wall of a call by CUDA events.  Where no
    session traced a flow kernel, the kernel's time is the call's time by
    CUDA events (``kernel_timed_by``)."""
    import torch

    def call():
        return of.lk_flow(prev, curr, p, valid)

    call()
    torch.cuda.synchronize()
    tr = traced_flow(call, reps)
    wall = cuda_ms(call, reps=100, warmup=5)
    flow = tr["flow"]
    return {
        "launches_per_call": tr["launched"] / reps,
        "traced_kernels": len(flow),
        "launched": tr["launched"],
        "sessions": tr["sessions"],
        "other_device_ops": len(tr["ops"]) - len(flow),
        "flow_kernel_ms": sum(flow) / len(flow) / 1e3 if flow else wall,
        "kernel_timed_by": "profiler" if flow else f"CUDA events (no flow kernel traced in {tr['sessions']} sessions)",
        "wall_ms_per_call": wall,
    }


def check_flow_step(step: dict, what: str) -> str:
    """Fails unless each call launched the kernel once and the trace shows
    no device operation but the flow kernel; returns what the trace saw."""
    if step["launches_per_call"] != 1:
        fail(f"one lk_flow call {what} launched the kernel {step['launches_per_call']} times, expected once")
    if step["other_device_ops"] or step["traced_kernels"] > step["launched"]:
        fail(f"lk_flow calls {what} ran {step['other_device_ops']} device operations other than the "
             f"{step['launched']} flow kernels launched ({step['traced_kernels']} traced)")
    return (f"{step['traced_kernels']} of {step['launched']} launches traced in {step['sessions']} profiler "
            f"session(s), no other device operation; kernel time by {step['kernel_timed_by']}")


def flow_against_plain(of, prev, curr, p, valid) -> tuple[float, np.ndarray]:
    """One flow step on CUDA tensors against ``lk_flow_plain`` on the same
    ones: fails unless it launched the kernel once, the status is bit-equal
    and the tracked positions agree within FLOW_ATOL.  Returns (the largest
    position difference in px, the plain version's status)."""
    import torch

    k = p.shape[0]
    launches0 = lc.get("lk_flow")
    g_k, s_k = of.lk_flow(prev, curr, p, valid)
    torch.cuda.synchronize()
    if lc.get("lk_flow") != launches0 + 1:
        fail("lk_flow on CUDA tensors did not launch the kernel")
    g_p, s_p = of.lk_flow_plain(prev, curr, p, valid)
    torch.cuda.synchronize()
    s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
    if not np.array_equal(s_k, s_p):
        fail(f"lk_flow status at K = {k} differs from the plain version at {np.flatnonzero(s_k != s_p).tolist()}")
    err = float(np.abs(g_k.cpu().numpy() - g_p.cpu().numpy())[s_p].max()) if s_p.any() else 0.0
    if not err <= FLOW_ATOL:
        fail(f"lk_flow positions at K = {k} differ from the plain version by {err} > {FLOW_ATOL}")
    return err, s_p


def flow_times(of, prev, curr, p, valid) -> dict:
    """The flow step's work on this input (:func:`lk_flow_work`) and bound,
    the kernel's device time a launch and the call's wall
    (:func:`flow_step_timing`), and the plain version's time."""
    h, w = prev.shape[:2]
    side = of.roi_side(h, w)
    origin = of.roi_origins(p, h, w, side, 2)
    record: list = []
    of.engine_plain(of.roi_pyramids(prev, curr, origin, side, 2), origin, p, side, 2, record=record)
    nbytes, ops, live_steps = lk_flow_work(origin, (h, w), side, record)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_INSTR_S * 1e3
    return {
        "step": flow_step_timing(of, prev, curr, p, valid),
        "plain_ms": cuda_ms(lambda: of.lk_flow_plain(prev, curr, p, valid), reps=5),
        "nbytes": nbytes, "ops": ops, "live_steps": live_steps, "t_bytes": t_bytes, "t_ops": t_ops,
        "bound": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def work_line(t: dict) -> str:
    """The needs-and-bound part of a timing line."""
    return (f"needs {t['nbytes']} B (union of the ROIs, both frames, and I/O) = {t['t_bytes'] * 1e3:.4f} us and "
            f"{t['ops']} f32 instructions ({t['live_steps']} live Newton steps) = {t['t_ops'] * 1e3:.4f} us -> "
            f"bound {t['bound'] * 1e3:.4f} us by {t['bound_by']}, kernel {t['step']['flow_kernel_ms'] / t['bound']:.1f}x "
            f"over it")


def phase_kernel(frames, pts):
    """The LK flow kernel vs its plain version at K = 57 on the canvas:
    status bit-equal, positions within FLOW_ATOL, one launch a call and no
    other device operation traced;
    its device time, the call's wall, the plain version's, and the bound."""
    from eagle_tpu_torch.ops import optical_flow as of

    prev, curr, p, valid = flow_input(frames, pts)
    saved = lc.snapshot()
    err, s_p = flow_against_plain(of, prev, curr, p, valid)
    print(f"kernel lk_flow: K={p.shape[0]} ok={int(s_p.sum())} max |kernel - plain| = {err:.3e} px")
    t = flow_times(of, prev, curr, p, valid)
    lc.restore(saved)  # comparison launches are not main-path launches
    step, ms = t["step"], t["step"]["flow_kernel_ms"]
    seen = check_flow_step(step, "at K = 57")
    print(f"kernel lk_flow: {ms:.4f} ms device time a launch, one launch a call ({seen}), call "
          f"{step['wall_ms_per_call']:.4f} ms (CUDA events), plain {t['plain_ms']:.3f} ms; {work_line(t)}")
    return {
        "name": "lk_flow",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/lk_flow.cu",
        "replaces": "eagle_tpu/ops/pallas_flow2.py:272",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


def oracle_models(frames, pts, people=None):
    """``keypoint_fn`` / ``detector_fn`` that know the clip: the on-plane
    pitch landmarks in view, placed by a fixed broadcast-like world ->
    image homography of frame 0 (the near touchline spans x 20-85 m across
    the width, the far one is narrower) and panned with the frames, and
    ``people`` = (boxes (n, P, 4) image pixels, classes (P,)), by default
    six players standing still on the pitch.  Returns (keypoint_fn,
    detector_fn, truth (n, 57, 2) pixels of the landmarks in view, NaN for
    the others)."""
    from eagle_tpu_torch import pitch

    offs = pts[0, 0, 0] - pts[:, 0, 0]
    world = pitch.WORLD_XY
    proj = np.array([[17.7, 6.8, -314.0], [0.0, -9.18, 686.0], [0.0, 0.01, 1.0]]) @ np.concatenate(
        [world, np.ones((57, 1))], -1
    ).T
    base = (proj[:2] / proj[2]).T
    truth = base[None] - np.stack([offs, np.zeros_like(offs)], -1)[:, None]
    h, w = frames.shape[1:3]
    seen = (base[:, 0] >= 20) & (base[:, 0] < w - 40) & (base[:, 1] >= 20) & (base[:, 1] < h - 20)
    seen &= pitch.ON_PLANE_MASK
    truth[:, ~seen] = np.nan
    index = {frames[i].tobytes(): i for i in range(len(frames))}
    if people is None:
        feet = np.array([[300, 200], [520, 420], [700, 300], [900, 600], [400, 650], [1100, 380]], float)
        x = feet[None, :, 0] - offs[:, None]
        y = np.broadcast_to(feet[None, :, 1], x.shape)
        people = (np.stack([x - 15, y - 70, x + 15, y], -1).astype(np.float32), np.zeros(len(feet), np.int32))
    people_boxes, people_cls = people
    p = len(people_cls)

    def keypoint_fn(batch):
        idx = [index[f.tobytes()] for f in batch]
        kp = np.zeros((len(idx), 57, 3), np.float32)
        kp[..., :2] = np.nan_to_num(np.trunc(truth[idx]))
        kp[..., 2] = 0.9
        return kp, np.tile(seen, (len(idx), 1))

    def detector_fn(batch):
        idx = [index[f.tobytes()] for f in batch]
        b = len(idx)
        boxes = np.zeros((b, 128, 4), np.float32)
        cls = np.zeros((b, 128), np.int32)
        valid = np.zeros((b, 128), bool)
        boxes[:, :p] = people_boxes[idx]
        cls[:, :p] = people_cls
        valid[:, :p] = True
        return boxes, np.where(valid, 0.9, 0.0).astype(np.float32), cls, valid

    return keypoint_fn, detector_fn, truth


def coords_mismatch(got: dict, want: dict) -> str | None:
    """The first difference between two get_coordinates dicts beyond the
    REF_* tolerances, or None."""
    if sorted(got) != sorted(want):
        return "frame keys"
    for i in want:
        g, w = got[i], want[i]
        if g["Keypoints"] != w["Keypoints"] or g["Time"] != w["Time"]:
            return f"frame {i} keypoints"
        for bg, bw in zip(g["Boundaries"], w["Boundaries"]):
            if (bg is None) != (bw is None) or (
                bw is not None and not np.allclose(bg, bw, atol=REF_BOUNDARY_ATOL, rtol=0)
            ):
                return f"frame {i} boundaries {g['Boundaries']} vs {w['Boundaries']}"
        if {c: sorted(o) for c, o in g["Coordinates"].items()} != {
            c: sorted(o) for c, o in w["Coordinates"].items()
        }:
            return f"frame {i} classes or track ids"
        for cls, objs in w["Coordinates"].items():
            for oid, ow in objs.items():
                og = g["Coordinates"][cls][oid]
                if not np.allclose(og["BBox"], ow["BBox"], atol=1, rtol=0):
                    return f"frame {i} {cls} {oid} box"
                tg, tw = og["Transformed_Coordinates"], ow["Transformed_Coordinates"]
                if (tg is None) != (tw is None) or (tw is not None and not np.allclose(tg, tw, atol=1, rtol=0)):
                    return f"frame {i} {cls} {oid} pitch position"
    return None


def phase_reference(frames, pts):
    """The slice on the card against the port's plain CPU path on a small
    clip (raw 1280x720 frames, the oracle models of :func:`oracle_models`):
    the two dicts agree within the REF_* tolerances, and every reported
    keypoint of a landmark in view lies within REF_TRUTH_PX of its true
    pixel (points synthesized beyond the view are extrapolations).  Then
    with calibration on: card and CPU agree, and the snap moved keypoints."""
    from eagle_tpu_torch import pitch
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    clip = frames[:REF_FRAMES]
    res = {}
    for dev in ("cuda", "cpu"):
        kp_fn, det_fn, truth = oracle_models(clip, pts)
        model = CoordinateModel(keypoint_fn=kp_fn, detector_fn=det_fn, device=dev)
        res[dev] = model.get_coordinates(clip, FPS, num_keypoint_detection=6)
    bad = coords_mismatch(res["cuda"], res["cpu"])
    if bad:
        fail(f"the slice on the card differs from its plain CPU path: {bad}")
    errs = [
        np.hypot(*(np.asarray(xy) - truth[i, pitch.NAME_TO_ID[name]]))
        for i, fr in res["cuda"].items()
        for name, xy in fr["Keypoints"].items()
        if np.isfinite(truth[i, pitch.NAME_TO_ID[name]]).all()
    ]
    n_h = sum(fr["Boundaries"][0] is not None for fr in res["cuda"].values())
    n_players = min(len(fr["Coordinates"].get("Player", {})) for fr in res["cuda"].values())
    print(f"reference: {len(clip)} frames, card == plain CPU path; {len(errs)} keypoints in view, "
          f"max {max(errs):.2f} px from the truth; {n_h} frames with boundaries; "
          f">= {n_players} players tracked per frame")
    if not (max(errs) <= REF_TRUTH_PX and n_h == len(clip) and n_players == 6):
        fail("the slice on the small reference clip lost keypoints, the homography or the players")

    cal = {}
    for dev in ("cuda", "cpu"):
        kp_fn, det_fn, _ = oracle_models(clip, pts)
        model = CoordinateModel(keypoint_fn=kp_fn, detector_fn=det_fn, device=dev)
        cal[dev] = model.get_coordinates(clip, FPS, num_keypoint_detection=6, calibration=True)
    bad = coords_mismatch(cal["cuda"], cal["cpu"])
    if bad:
        fail(f"the calibrated slice on the card differs from its plain CPU path: {bad}")
    moved = sum(
        xy != res["cuda"][i]["Keypoints"].get(name)
        for i, fr in cal["cuda"].items()
        for name, xy in fr["Keypoints"].items()
    )
    print(f"reference, calibration on: card == plain CPU path; {moved} of "
          f"{sum(len(fr['Keypoints']) for fr in cal['cuda'].values())} reported keypoints differ from "
          f"the uncalibrated run")
    if moved == 0:
        fail("calibration moved no keypoint of the reference clip")


def phase_models_bf16(model, frames):
    """bf16 HRNet / YOLO outputs vs float32 copies of the same modules on
    one batch of canvas frames."""
    import copy

    import torch

    dev = model.device
    geom = model._geometry(FRAME_HW)
    x = model.upload(frames[:8], geom)
    with torch.no_grad():
        img = x[:, geom.pad_y : geom.pad_y + geom.img_h, geom.pad_x : geom.pad_x + geom.img_w]
        from eagle_tpu_torch.ops.preprocess import normalize_imagenet

        pre = normalize_imagenet(img.flip(-1).float()).permute(0, 3, 1, 2).contiguous()
        hr16 = model.keypoint_model
        hr32 = copy.deepcopy(hr16)
        hr32.use_bf16 = False
        hm_err = float((hr16(pre) - hr32(pre)).abs().max())
        imgs = (x.flip(-1).float() / 255.0).permute(0, 3, 1, 2).contiguous()
        yo16 = model.detector_model
        yo32 = copy.deepcopy(yo16)
        yo32.use_bf16 = False
        b16, s16 = yo16(imgs)
        b32, s32 = yo32(imgs)
        box_err = float((b16 - b32).abs().max())
        score_err = float((s16 - s32).abs().max())
    torch.cuda.synchronize(dev)
    print(
        f"bf16 vs float32: HRNet heatmaps {hm_err:.3e} (atol {BF16_HEATMAP_ATOL}), YOLO boxes "
        f"{box_err:.3f} px (atol {BF16_BOX_ATOL}), scores {score_err:.3e} (atol {BF16_SCORE_ATOL})"
    )
    if not (hm_err <= BF16_HEATMAP_ATOL and box_err <= BF16_BOX_ATOL and score_err <= BF16_SCORE_ATOL):
        fail("bf16 model outputs disagree with float32")


def detections_per_frame(model, x) -> tuple[float, float]:
    """Mean detections a frame of the built-in detector + NMS over the
    device frames ``x``: (valid, i.e. at or above the low threshold, which
    is what enters the tracker; at or above the keep threshold)."""
    import torch

    geom = model._geometry(FRAME_HW)
    d = torch.cat([model.run_detector(x[i : i + 16], geom, FRAME_HW) for i in range(0, len(x), 16)])
    valid = d[..., 6] > 0.5
    kept = valid & (d[..., 4] >= model.detector_conf)
    return float(valid.sum(1).float().mean()), float(kept.sum(1).float().mean())


def spread_class_logits(net, x) -> None:
    """Scale the class output conv of each YOLO head level so that every
    class logit, without the bias, has standard deviation CLS_LOGIT_STD
    over the anchors of one forward pass on ``x``."""
    import torch
    import torch.nn.functional as F

    def rescale(conv, args):
        y = F.conv2d(args[0].float(), conv.w.float(), padding=conv.padding)
        conv.w.mul_(CLS_LOGIT_STD / y.std(dim=(0, 2, 3))[:, None, None, None])

    hooks = [lvl.cls_out.register_forward_pre_hook(rescale) for lvl in net.head["levels"]]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()


def spread_weights(model, frames, seed: int = SEED) -> tuple[float, float]:
    """Re-draw the seeded random weights so the slice is not degenerate:
    with the reference init (HRNet conv std 0.001) every heatmap is flat,
    all 57 argmaxes land on one pixel and dedup leaves one keypoint; the
    YOLO activations fade through the depth and its class head (std 0.01)
    gives every anchor the same score, so the count of detections jumps
    from 0 to the 128 slots as the class bias moves -- the homography and
    tracker would either never run or run saturated.  HRNet convs get std
    0.5 / sqrt(fan_in) (spread heatmaps, no saturation).  YOLO's class
    head is scaled to CLS_LOGIT_STD on 8 frames spread over the clip, and
    its class bias (one value for every class and level) is bisected on
    those frames until they keep TARGET_DETECTIONS a frame at the keep
    threshold: a broadcast frame's load on NMS, the auction and the
    tracker.  Returns (bias, kept detections a frame on those frames)."""
    import torch

    from eagle_tpu_torch.models.layers import init_normal_

    gen = torch.Generator().manual_seed(seed)
    init_normal_(model.keypoint_model, gen,
                 lambda name, p: 0.5 / (p.shape[1] * p.shape[2] * p.shape[3]) ** 0.5)
    x = model.upload(frames[:: max(1, len(frames) // 8)][:8], model._geometry(FRAME_HW))
    spread_class_logits(model.detector_model, (x.flip(-1).float() / 255.0).permute(0, 3, 1, 2).contiguous())

    def kept(bias: float) -> float:
        with torch.no_grad():
            for lvl in model.detector_model.head["levels"]:
                lvl.cls_out.b.fill_(bias)
        return detections_per_frame(model, x)[1]

    lo, hi = -40.0, 8.0
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        if kept(mid) < TARGET_DETECTIONS:
            lo = mid
        else:
            hi = mid
    return hi, kept(hi)


def traced_run(model, frames, what: str, **kw):
    """One run of a main path, ``model.get_coordinates(frames, FPS, **kw)``
    under the profiler (``profile_stages``), with every count zeroed just
    before it: fails unless each hand-written kernel's launch count equals
    the device kernels of its name in the trace (``bench.TRACED``, one a
    launch).  The profiler has been seen to miss a launch: a trace that
    holds fewer is taken again, up to TRACE_ATTEMPTS runs; one that holds
    more fails at once.  Returns ({kernel: launches}, the rounds and NMS
    launches (:func:`loop_counts`), the ``StageProfile``, the temporal
    steps, the runs taken)."""
    from eagle_tpu_torch.bench import TRACED
    from eagle_tpu_torch.utils.profiling import profile_stages

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        zero_loop_counts()
        stepped0 = model.frames_stepped
        prof = profile_stages(model, frames, FPS, **kw)
        loops = loop_counts()
        counted = {k: lc.get(k) for k in TRACED}
        traced = {k: sum(c for name, (c, _) in prof.kernels.items() if re.search(pat, name))
                  for k, pat in TRACED.items()}
        if any(traced[k] > counted[k] for k in TRACED):
            fail(f"{what}, traced: the trace holds {traced} device kernels, more than the {counted} launches counted")
        if traced == counted:
            return counted, loops, prof, model.frames_stepped - stepped0, attempt
    fail(f"{what}, traced: the trace holds {traced} device kernels, the counts {counted} launches "
         f"({TRACE_ATTEMPTS} runs)")


def phase_slice(frames):
    import torch

    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.pipeline.coordinate_model import PIECE, CoordinateModel, StageTimer

    cfg = DEFAULT_CONFIG
    assert cfg.detector.variant == "large_hd" and cfg.detector.image_size == 960
    assert tuple(cfg.keypoint.input_hw) == (540, 960) and cfg.keypoint.use_bf16
    t0 = time.perf_counter()
    model = CoordinateModel(config=cfg, seed=SEED, device="cuda")
    bias, kept = spread_weights(model, frames)
    print(f"slice: models built in {time.perf_counter() - t0:.1f} s "
          f"(YOLOv8-{model.detector_model.variant} @ {cfg.detector.image_size}, HRNet-W48 @ "
          f"{cfg.keypoint.input_hw[0]}x{cfg.keypoint.input_hw[1]}, bf16); YOLO class bias "
          f"{bias:.4f} keeps {kept:.2f} detections a frame on 8 frames of the clip (target "
          f"{TARGET_DETECTIONS})")
    phase_models_bf16(model, frames)

    # warm-up on a short clip (cuDNN algorithm choice, allocator)
    model.get_coordinates(frames[:16], FPS, num_keypoint_detection=3)
    torch.cuda.synchronize()

    timer = StageTimer(model.device, sync=True)
    zero_loop_counts()
    stepped0 = model.frames_stepped
    t0 = time.perf_counter()
    res = model.get_coordinates(frames, FPS, num_keypoint_detection=3, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lc.get("lk_flow")
    loops, stepped = loop_counts(), model.frames_stepped - stepped0
    loops["keys"], loops["eigh9"] = lc.get("ransac_keys"), lc.get("eigh9")

    if sorted(res) != list(range(len(frames))):
        fail("get_coordinates did not return one entry per frame")
    for i, fr in res.items():
        if set(fr) != {"Coordinates", "Time", "Keypoints", "Boundaries"}:
            fail(f"frame {i} has keys {sorted(fr)}")
        for name, (x, y) in fr["Keypoints"].items():
            if not (np.isfinite(x) and np.isfinite(y)):
                fail(f"frame {i} keypoint {name} is not finite")
    if launches < len(frames) - 1:
        fail(f"lk_flow kernel launched {launches} times for {len(frames)} frames")
    if loops["auction"] != 3 * stepped or not loops["rounds"] or loops["nms"] != -(-len(frames) // PIECE):
        fail(f"the slice's {stepped} temporal steps over {len(frames)} frames: {loop_line(loops)}; expected 3 "
             f"auction launches a step and one nms launch a {PIECE}-frame detector batch")
    if loops["keys"] != stepped or loops["eigh9"] != 2 * stepped:
        fail(f"the slice's {stepped} captured temporal steps launched the keys kernel {loops['keys']} times and the "
             f"eigen solve {loops['eigh9']} times; expected one and two a step")
    n_kp = np.mean([len(fr["Keypoints"]) for fr in res.values()])
    n_h = sum(fr["Boundaries"][0] is not None for fr in res.values())
    n_obj = np.mean([sum(len(o) for o in fr["Coordinates"].values()) for fr in res.values()])
    n_tracked = np.mean([len(fr["Coordinates"].get("Player", {})) + len(fr["Coordinates"].get("Goalkeeper", {}))
                         for fr in res.values()])
    n_valid, n_kept = detections_per_frame(model, model.upload(frames, model._geometry(FRAME_HW)))
    stages = {k: round(v * 1e3, 3) for k, v in timer.seconds.items()}
    print(f"slice: {len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.2f} fps; "
          f"stage ms {json.dumps(stages)}; lk_flow launches {launches}; {loop_line(loops)}; keys launches "
          f"{loops['keys']}, eigh9 launches {loops['eigh9']} for {stepped} temporal steps")
    timed = {"lk_flow": launches, "auction": loops["auction"], "nms": loops["nms"], "ransac_keys": loops["keys"],
             "eigh9": loops["eigh9"], "lap_jv": lc.get("lap_jv")}
    counted, traced_loops, prof, traced_steps, runs = traced_run(model, frames, "slice", num_keypoint_detection=3)
    if counted != timed or traced_steps != stepped or traced_loops["rounds"] != loops["rounds"]:
        fail(f"the slice's traced run counted {counted} launches ({traced_loops['rounds']} device rounds) in "
             f"{traced_steps} temporal steps, the timed run {timed} ({loops['rounds']}) in {stepped}")
    print(f"slice, traced: launches counted == device kernels in the trace == the timed run's {json.dumps(counted)} "
          f"({runs} traced run(s))")
    print(f"slice traffic, means a frame: detections entering the tracker {n_valid:.2f} "
          f"(kept at the keep threshold {n_kept:.2f}); objects reported {n_obj:.2f}, of which "
          f"tracked players and goalkeepers {n_tracked:.2f}; keypoints {n_kp:.2f}; frames with "
          f"boundaries {n_h}")
    return launches, model, res, loops, (prof, traced_steps)


# ---------------------------------------------------------------------------
# the temporal scan as captured chunks: the step graph, the RANSAC keys
# kernel and the DLT's eigen solve
# ---------------------------------------------------------------------------


def temporal_syncs(model, frames, **kw) -> dict:
    """Two more ``get_coordinates`` of the model: one with a ``StageTimer``
    that counts the synchronising calls inside its ``temporal`` spans (the
    scan's uploads, replays or steps, and drains; not the on-demand
    keypoint runs, which time as ``keypoints``), one with every chunk's
    replays (``StepGraph.run_chunk``) counted by :func:`host_syncs`:
    {"stage": the first, "replays": the second}."""
    import warnings

    import torch

    from eagle_tpu_torch.pipeline import step_graph
    from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

    host_syncs(lambda: None)  # fails unless the debug mode reports a known sync
    counts = {"stage": 0, "replays": 0}

    class Counting(StageTimer):
        def __call__(self, name):
            span = super().__call__(name)
            if name != "temporal":
                return span

            class Counted:
                def __enter__(self):
                    span.__enter__()
                    self.caught = warnings.catch_warnings(record=True)
                    self.seen = self.caught.__enter__()
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")

                def __exit__(self, *exc):
                    torch.cuda.set_sync_debug_mode("default")
                    self.caught.__exit__(*exc)
                    counts["stage"] += sum("synchroniz" in str(w.message) for w in self.seen)
                    span.__exit__(*exc)

            return Counted()

    model.get_coordinates(frames, FPS, timer=Counting(model.device), **kw)
    real_chunk = step_graph.StepGraph.run_chunk

    def chunk(self, *a, **k):
        out = []
        counts["replays"] += host_syncs(lambda: out.append(real_chunk(self, *a, **k)))
        return out[0]

    step_graph.StepGraph.run_chunk = chunk
    try:
        model.get_coordinates(frames, FPS, **kw)
    finally:
        step_graph.StepGraph.run_chunk = real_chunk
    return counts


def graph_against_eager(model, frames, what: str, **kw) -> dict:
    """``model.get_coordinates(frames, FPS, **kw)`` through the captured
    chunks and through the eager loop (the private ``_temporal_path``), each
    after a warm-up run (the graph's capture, cuDNN's choices): fails
    unless the two dicts are equal.  Returns the temporal stage's ms a frame
    (a synchronised ``StageTimer``), its blocking calls a frame, the syncs
    inside the chunks' replays, the capture's seconds and the launches a
    temporal step, counted in the timed runs: fails unless a captured step
    (device counters, added by the replays) launched one flow, three
    auction (or JV), one keys and two eigen-solve kernels, and the eager
    loop (host counts, added by each launch) as many flow and solver
    kernels a step (its RANSAC runs only on the frames that solve)."""
    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

    out, res, per_step = {}, {}, {}
    for path in ("chunks", "frames"):
        model._temporal_path = path
        try:
            model.get_coordinates(frames, FPS, **kw)  # warm-up (and the capture)
            torch.cuda.synchronize()
            timer = StageTimer(model.device, sync=True)
            lc.reset()
            stepped0 = model.frames_stepped
            res[path] = model.get_coordinates(frames, FPS, timer=timer, **kw)
            steps = model.frames_stepped - stepped0
            per_step[path] = {k: n / steps for k in STEP_KERNELS if (n := lc.get(k))}
            syncs = temporal_syncs(model, frames, **kw)
        finally:
            model._temporal_path = None
        out[path] = {"temporal_ms_per_frame": 1e3 * timer.seconds["temporal"] / len(frames),
                     "blocking_calls_per_frame": syncs["stage"] / len(frames), "replay_syncs": syncs["replays"]}
    if res["chunks"] != res["frames"]:
        bad = next(i for i in res["frames"] if res["chunks"].get(i) != res["frames"][i])
        fail(f"graph: {what}: the captured chunks differ from the eager loop at frame {bad}")
    if out["chunks"]["replay_syncs"]:
        fail(f"graph: {what}: {out['chunks']['replay_syncs']} synchronising calls inside the chunks' replays")
    solver = "lap_jv" if model.config.tracker.assignment == "exact" else "auction"
    want = {"lk_flow": 1.0, solver: 3.0, "ransac_keys": 1.0, "eigh9": 2.0}
    if per_step["chunks"] != want or any(per_step["chunks"][k] != per_step["frames"].get(k) for k in ("lk_flow", solver)):
        fail(f"graph: {what}: launches a temporal step {per_step['chunks']} in the captured chunks (expected {want}), "
             f"{per_step['frames']} in the eager loop (the same flow and {solver} launches)")
    graphs = [g for g in model._step_graphs.values() if g.graph is not None]
    print(f"graph: {what}: captured chunks == eager loop ({len(frames)} frames); temporal ms a frame "
          f"{out['chunks']['temporal_ms_per_frame']:.3f} captured, {out['frames']['temporal_ms_per_frame']:.3f} "
          f"eager; blocking calls in the temporal stage a frame {out['chunks']['blocking_calls_per_frame']:.4f} "
          f"captured, {out['frames']['blocking_calls_per_frame']:.4f} eager; syncs inside the replays "
          f"{out['chunks']['replay_syncs']}; capture {graphs[-1].capture_s:.3f} s; launches a step, counted in "
          f"the timed runs: captured {per_step['chunks']}, eager {per_step['frames']} (RANSAC only on the frames "
          f"that solve)")
    return out


def graph_profile(traced) -> None:
    """The slice's temporal stage through the captured chunks in the slice's
    traced run (:func:`traced_run`, ``utils/profiling.py::profile_stages``):
    device kernels a step, device-busy ms a step, the idle share and the
    host's calls that may block (and those that wait)."""
    prof, steps = traced
    st, kernels = prof.stages["temporal"], prof.stage_kernels["temporal"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"graph: slice, profiled: {steps} captured steps, {sum(kernels.values()) / steps:.1f} device kernels a "
          f"step ({len(kernels)} names; most frequent {[(k[:48], n) for k, n in top]}), device busy "
          f"{st['device_busy_ms'] / steps:.4f} ms a step, temporal stage {st['wall_ms']:.3f} ms, idle "
          f"{st['device_idle_share']:.4f}, {st['blocking_calls']} blocking calls ({st['waiting_calls']} but the "
          f"copies from the card to the card)")


def keys_kernel() -> dict:
    """The RANSAC keys kernel at the main path's shape (512 x 57) against
    its plain version on the same CUDA scalar ``t``, bit-equal at several
    seeds and frames; its device time, the plain version's and the
    bound."""
    import torch

    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.ops import prng

    iters = DEFAULT_CONFIG.homography.ransac_iters
    saved = lc.snapshot()
    for seed, step in ((0, 0), (0, 47), (7, 10**6), (2**31 + 3, 2**33 + 5)):
        t_ = torch.tensor(step, device="cuda")
        if not torch.equal(prng.ransac_keys_cuda(seed, t_, iters, 57), prng.ransac_keys_plain(seed, t_, iters, 57)):
            fail(f"the keys kernel differs from its plain version at seed {seed}, t {step}")
    t_ = torch.tensor(47, device="cuda")
    ms, how = kernel_ms(lambda: prng.ransac_keys_cuda(SEED, t_, iters, 57), "ransac_keys", "ransac_keys",
                        "ransac_keys")
    plain = cuda_ms(lambda: prng.ransac_keys_plain(SEED, t_, iters, 57))
    lc.restore(saved)  # comparison launches are not main-path launches
    n = iters * 57
    nbytes = 4 * n + 8
    ops = KEYS_OPS_PER_HASH * (n + 1) + 2 * n
    bound_b, bound_o = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_INT32_OPS_S * 1e3
    print(f"graph: keys kernel ({iters} x 57) bit-equal to its plain version; {ms:.4f} ms a launch ({how}), plain "
          f"{plain:.4f} ms; bound {max(bound_b, bound_o) * 1e3:.4f} us ({nbytes} B; {ops} int32 operations)")
    return {
        "name": "ransac_keys",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/threefry.cu",
        "replaces": "eagle_tpu/ops/homography.py:128 (jax.random.gumbel + top_k's draw in the scan program)",
        "launches": None,
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": None,
        "shape": [iters, 57],
    }


def eigh_inputs(model, frames) -> list:
    """The DLT's normal matrices of one eager step's RANSAC on the card at
    the main path's shapes: [(512, 9, 9) the hypotheses', (9, 9) the
    refit's], recorded from a 2-frame run of the slice model with a
    homography every frame."""
    from eagle_tpu_torch.ops import homography

    seen, real = [], homography.smallest_eigenvector

    def record(a):
        seen.append(a.clone())
        return real(a)

    homography.smallest_eigenvector = record
    model._temporal_path = "frames"
    try:
        model.get_coordinates(frames[:2], FPS, num_homography=FPS, num_keypoint_detection=FPS)
    finally:
        homography.smallest_eigenvector = real
        model._temporal_path = None
    big = next((a for a in seen if a.dim() == 3), None)
    one = next((a for a in seen if a.dim() == 2), None)
    if big is None or one is None:
        fail("graph: the slice's RANSAC made no eigen solve to record")
    return [big.contiguous(), one.contiguous()]


def eigh_kernel(model, frames) -> dict:
    """The eigen-solve kernel on the slice's own DLT normal matrices (the
    512 hypotheses' and the refit's) against its plain version
    (``torch.linalg.eigh`` on the same CUDA tensors), up to sign, on the
    matrices whose two smallest eigenvalues lie apart (EIGH_GAP of the
    largest, by float64 ``eigh``), within EIGH_ATOL; its residual on all within
    EIGH_RESID of the matrix's norm; device ms, the plain version's,
    ``torch.linalg.eigh``'s and the bound; the synchronising calls of one
    ``torch.linalg.eigh`` and of one launch (must be 0)."""
    import torch

    from eagle_tpu_torch.ops import eigh

    saved = lc.snapshot()
    errs = []
    mats = eigh_inputs(model, frames)
    for a in mats:
        got = eigh.smallest_eigenvector_cuda(a).reshape(-1, 9)
        plain = eigh.smallest_eigenvector_plain(a).reshape(-1, 9)
        a64 = a.double().reshape(-1, 9, 9)
        lam, _ = torch.linalg.eigh(a64)
        apart = (lam[:, 1] - lam[:, 0]) > EIGH_GAP * lam[:, -1].abs()
        err = torch.minimum((got - plain).abs().amax(-1), (got + plain).abs().amax(-1))
        g64 = got.double()
        resid = ((a64 @ g64[..., None])[..., 0] - lam[:, :1] * g64).norm(dim=-1) / a64.flatten(1).norm(dim=-1)
        errs.append(float(err[apart].max()) if bool(apart.any()) else 0.0)
        if errs[-1] > EIGH_ATOL or float(resid.max()) > EIGH_RESID:
            fail(f"the eigen-solve kernel differs from torch.linalg.eigh on the slice's {tuple(a.shape)} matrices: "
                 f"{errs[-1]:.3e} on {int(apart.sum())} separated ones, residual {float(resid.max()):.3e}")
    big = mats[0]
    syncs = {what: host_syncs(fn) for what, fn in (("torch.linalg.eigh", lambda: torch.linalg.eigh(big)),
                                                    ("eigh9", lambda: eigh.smallest_eigenvector_cuda(big)))}
    if syncs["eigh9"]:
        fail(f"the eigen-solve kernel made {syncs['eigh9']} synchronising calls")
    ms, how = kernel_ms(lambda: eigh.smallest_eigenvector_cuda(big), "eigh9", "eigh9", "eigh9")
    plain = cuda_ms(lambda: eigh.smallest_eigenvector_plain(big))
    library = cuda_ms(lambda: torch.linalg.eigh(big))
    lc.restore(saved)  # comparison launches are not main-path launches
    b = big.shape[0]
    nbytes = b * (81 + 9) * 4
    ops = b * EIGH_OPS
    bound_b, bound_o = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_OPS_S * 1e3
    print(f"graph: eigen-solve kernel ({b} x 9 x 9 and 9 x 9 of the slice's RANSAC) within {max(errs):.3e} of "
          f"torch.linalg.eigh up to sign; {ms:.4f} ms a launch ({how}), plain {plain:.4f} ms, torch.linalg.eigh "
          f"{library:.4f} ms; bound {max(bound_b, bound_o) * 1e3:.4f} us ({nbytes} B; {ops} float32 operations); "
          f"synchronising calls a call: {syncs}")
    return {
        "name": "eigh9",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/eigh9.cu",
        "replaces": "eagle_tpu/ops/homography.py:79 (dlt_homography's jnp.linalg.eigh in the scan program)",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": library,
        "shape": [b, 9, 9],
    }


def phase_graph(frames, pts, slice_model, slice_traced) -> tuple[dict, dict]:
    """The temporal scan as captured chunks: (a) the 48-frame slice, (b) the
    oracle-keypoint clip, (c) the exact slice, each through the captured
    chunks and the eager loop on the card, bit-equal, with the temporal
    stage's ms and blocking calls a frame both ways; then the keys and
    eigen-solve kernels against their plain versions.  Returns their
    kernels-line entries."""
    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    t0 = time.perf_counter()
    graph_against_eager(slice_model, frames, "slice", num_keypoint_detection=3)
    graph_profile(slice_traced)
    kp_fn, det_fn, _ = oracle_models(frames[:REF_FRAMES], pts)
    oracle = CoordinateModel(keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda")
    graph_against_eager(oracle, frames[:REF_FRAMES], "oracle clip", num_keypoint_detection=6)
    exact = CoordinateModel(config=exact_config(), seed=SEED, device="cuda")
    exact.keypoint_model.load_state_dict(slice_model.keypoint_model.state_dict())
    exact.detector_model.load_state_dict(slice_model.detector_model.state_dict())
    graph_against_eager(exact, frames, "exact slice", num_keypoint_detection=3)
    del exact
    torch.cuda.empty_cache()
    keys = keys_kernel()
    eig = eigh_kernel(slice_model, frames)
    print(f"graph: phase {time.perf_counter() - t0:.1f} s")
    return keys, eig


# ---------------------------------------------------------------------------
# the device loops: the auction kernel and the NMS kernel
# ---------------------------------------------------------------------------


def zero_loop_counts() -> None:
    """Zeroes every kernel's launch count and the auction's rounds (the
    plain version's and the kernel's device-side tallies)."""
    from eagle_tpu_torch.ops import assignment

    lc.reset()
    assignment.reset_rounds()


def loop_counts() -> dict:
    """After a synchronize: the auction's launches and the bidding rounds
    its kernels ran (the device tally), NMS's launches."""
    import torch

    from eagle_tpu_torch.ops import assignment

    torch.cuda.synchronize()
    return {"auction": lc.get("auction"), "rounds": assignment.device_rounds(), "nms": lc.get("nms")}


def loop_line(c: dict) -> str:
    return f"auction launches {c['auction']} ({c['rounds']} device rounds), nms launches {c['nms']}"


def host_syncs(call) -> int:
    """The synchronising operations of one ``call()``
    (``torch.cuda.set_sync_debug_mode("warn")``); fails if the mode
    reports nothing on a known sync."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call()
        with warnings.catch_warnings(record=True) as control:
            warnings.simplefilter("always")
            bool(torch.ones((), device="cuda"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not any("synchroniz" in str(w.message) for w in control):
        fail("torch.cuda.set_sync_debug_mode did not report a host sync: the sync count would read nothing")
    return sum("synchroniz" in str(w.message) for w in caught)


def record_loop_inputs(model, frames) -> tuple[list, list]:
    """One ``get_coordinates`` of the model on ``frames`` with the
    tracker's solver calls and the detector's suppression calls recorded:
    ([(stage, cost, row_valid, col_valid, gate)] in call order, three a
    temporal step; [(shifted, valid, iou threshold)], one a detector
    batch), copies on the card.  The temporal stage runs its eager loop
    here: a captured step's replay calls no Python to record."""
    from eagle_tpu_torch.ops import nms
    from eagle_tpu_torch.track import botsort

    solves, batches = [], []
    real_solver, real_suppress = botsort.masked_auction, nms.suppress

    def solver(cost, rows, cols, gate, *a, **kw):
        solves.append((len(solves) % 3 + 1, cost.clone(), rows.clone(), cols.clone(), gate))
        return real_solver(cost, rows, cols, gate, *a, **kw)

    def suppress(shifted, valid, thr):
        batches.append((shifted.clone(), valid.clone(), thr))
        return real_suppress(shifted, valid, thr)

    botsort.masked_auction, nms.suppress = solver, suppress
    model._temporal_path = "frames"
    try:
        model.get_coordinates(frames, FPS, num_keypoint_detection=3)
    finally:
        botsort.masked_auction, nms.suppress = real_solver, real_suppress
        model._temporal_path = None
    return solves, batches


def kernel_ms(call, count: str, kernel: str, what: str, reps: int = 20, per_call: int = 1) -> tuple[float, str]:
    """Device time of one launch from the profiler's trace over ``reps``
    calls (:func:`traced_flow`): the time the ``per_call`` device kernels a
    launch runs (every kernel whose name holds ``kernel``) cover, the union
    of their spans (a dependent kernel may start before the one it waits
    on ends), or by CUDA events where no session traced one; fails unless
    each call launched once (``mod``'s ``count``) and ran no other device
    operation."""
    from eagle_tpu_torch.utils.profiling import _union_ms

    tr = traced_flow(call, reps, kernel=kernel, count=count)
    if tr["launched"] != reps or len(tr["ops"]) != len(tr["flow"]) or len(tr["flow"]) > per_call * reps:
        fail(f"{reps} {what} calls launched the kernel {tr['launched']} times and traced "
             f"{len(tr['ops']) - len(tr['flow'])} other device operations")
    if tr["flow"]:
        return (per_call * _union_ms(tr["spans"]) / len(tr["flow"]),
                f"profiler, {len(tr['flow'])} of {per_call * reps} kernels traced, {per_call} a call")
    return cuda_ms(call, reps=reps), f"CUDA events (no {kernel} kernel traced in {tr['sessions']} sessions)"


def auction_against_plain(benefit, row_ok, c: int, iterations: int, what: str) -> tuple[int, list]:
    """One auction launch over CUDA tensors against ``auction_rounds_plain``
    on CPU copies: fails unless it launched once and the matches and round
    counts are bit-equal.  Returns (the rounds, the bidding rows of each
    round)."""
    import torch

    from eagle_tpu_torch.ops import assignment as lap

    before = lc.get("auction")
    got_m, got_r = lap.auction_rounds(benefit, row_ok, c, iterations)
    torch.cuda.synchronize()
    if lc.get("auction") != before + 1:
        fail(f"auction_rounds on CUDA tensors ({what}) did not launch the kernel once")
    record: list = []
    want_m, want_r = lap.auction_rounds_plain(benefit.cpu(), row_ok.cpu(), c, iterations, record=record)
    if not torch.equal(got_m.cpu(), want_m):
        bad = torch.nonzero(got_m.cpu() != want_m).flatten()[:10].tolist()
        fail(f"the auction kernel's matches differ from the plain version's ({what}) at {bad}")
    if not torch.equal(got_r.cpu(), want_r):
        fail(f"the auction kernel ran {got_r.tolist()} rounds, the plain version {want_r.tolist()} ({what})")
    return int(want_r.sum()), record


def auction_bound(b: int, r: int, ctot: int, bidding: int) -> tuple[float, float, float, str]:
    """(bytes ms, operations ms, bound ms, what bounds it) of B auctions
    over (R, C + R) benefits whose rounds had ``bidding`` bidding rows in
    all: the benefit and row_ok read once, the matches (int64) and rounds
    written once; 3 float32 instructions a column for each bidding row a
    round (the subtraction of the price, the compare with the best, the
    maximum for the second)."""
    nbytes = b * (r * ctot * 4 + r + r * 8 + 4)
    ops = 3 * ctot * bidding
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_INSTR_S * 1e3
    return t_bytes, t_ops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def auction_kernel(solves: list) -> dict:
    """The auction kernel on the card: (a) every recorded tracker solve
    (the three stages' 64 x 192 benefits), (b) the kernel_cases kinds at
    64 x 128, R > C and R < C, (c) the cap at 1-3 rounds on a tied block,
    (d) one B = 4 launch over four stage-1 benefits against 4 single
    launches, all against the plain version bit for bit; no host sync in
    ``masked_auction``; device ms a launch by stage, rounds a launch, the
    plain version's ms on the same CUDA tensors, the bound.  Returns the
    auction entry."""
    import torch

    from eagle_tpu_torch.ops import assignment as lap
    from eagle_tpu_torch.utils.kernel_cases import AUCTION_KINDS, ROUND_CASES, auction_case, auction_round_case

    def inputs(cost, rows, cols, gate):
        feas = rows[:, None] & cols[None, :] & (cost <= gate)
        return lap.auction_benefit(cost, feas, gate, max_cardinality=False)

    saved = lc.snapshot()
    tracked = [(st, *inputs(cost, rows, cols, gate), cost.shape[1]) for st, cost, rows, cols, gate in solves]
    r, ctot = tracked[0][1].shape
    if lap.auction_path(r, ctot) != "registers":
        fail(f"the auction at R = {r}, C + R = {ctot} does not keep its rows in registers")
    per_stage = {1: [0, 0, 0], 2: [0, 0, 0], 3: [0, 0, 0]}  # launches, rounds, bidding rows
    for k, (st, ben, ok, c) in enumerate(tracked):
        done, record = auction_against_plain(ben, ok, c, 512, f"tracker solve {k}, stage {st}")
        per_stage[st][0] += 1
        per_stage[st][1] += done
        per_stage[st][2] += sum(record)
    print(f"kernel auction: {len(tracked)} tracker solves ({r} x {ctot}, {len(tracked) // 3} temporal steps) == plain "
          f"bit for bit (matches and rounds); launches, rounds, bidding rows by stage {json.dumps(per_stage)}")

    cases = 0
    for kind in AUCTION_KINDS:
        for rr, cc in ((64, 128), (20, 12), (12, 20)):
            cost, rows, cols, gate = (torch.from_numpy(a).cuda() if isinstance(a, np.ndarray) else a
                                      for a in auction_case(kind, rr, cc, SEED + rr))
            ben, ok = inputs(cost, rows, cols, gate)
            auction_against_plain(ben, ok, cc, 512, f"{kind} {rr} x {cc}")
            cases += 1
            if kind == "tied_block" and (rr, cc) == (20, 12):
                for cap in (1, 2, 3):
                    done, _ = auction_against_plain(ben, ok, cc, cap, f"{kind} {rr} x {cc}, cap {cap}")
                    if done != cap:
                        fail(f"the tied block ran {done} rounds under a cap of {cap}")
                    cases += 1
    stage1 = [(ben, ok) for st, ben, ok, _ in tracked if st == 1][:4]
    ben4, ok4 = torch.stack([b for b, _ in stage1]), torch.stack([o for _, o in stage1])
    c = ctot - r
    batched, rounds4 = lap.auction_rounds(ben4, ok4, c)
    singles = [lap.auction_rounds(ben4[k], ok4[k], c) for k in range(4)]
    torch.cuda.synchronize()
    if not all(torch.equal(batched[k], singles[k][0]) and int(rounds4[k]) == int(singles[k][1]) for k in range(4)):
        fail("the batched auction launch over 4 matrices differs from 4 single launches")
    auction_against_plain(ben4, ok4, c, 512, "B = 4")
    cost, rows, cols, gate = solves[0][1:]
    syncs = host_syncs(lambda: lap.masked_auction(cost, rows, cols, gate))
    if syncs:
        fail(f"masked_auction on the card synchronised with the host {syncs} times")
    print(f"kernel auction: {cases} kernel_cases matrices (every kind at 64 x 128, 20 x 12, 12 x 20; a tied block "
          f"capped at 1, 2, 3 rounds) and one B = 4 launch == plain and == 4 single launches; masked_auction "
          f"{syncs} host syncs")

    # a launch's cost and a round's: kernel_cases' problems of 0, 1, 4 and 11 rounds
    by_rounds = {}
    for n in sorted(ROUND_CASES):
        cost, rows, cols, gate = (torch.from_numpy(a).cuda() if isinstance(a, np.ndarray) else a
                                  for a in auction_round_case(n))
        ben, ok = inputs(cost, rows, cols, gate)
        if auction_against_plain(ben, ok, cost.shape[1], 512, f"the {n}-round case")[0] != n:
            fail(f"the {n}-round auction case ran another number of rounds")
        by_rounds[n], _ = kernel_ms(lambda: lap.auction_rounds(ben, ok, cost.shape[1]), "auction",
                                    "auction", f"auction_rounds ({n} rounds)")
    round_ms = (by_rounds[11] - by_rounds[1]) / 10
    print(f"kernel auction at 64 x 192: device ms a launch of 0, 1, 4, 11 rounds "
          f"{json.dumps({k: round(v, 5) for k, v in by_rounds.items()})}; a round {round_ms * 1e3:.3f} us "
          f"((11 rounds - 1 round) / 10); the earlier one-block design, recorded in PERF.md and not measured "
          f"here: a launch of 0 rounds {RECORDED_EARLIER_MS['auction'][3]} ms, 4 rounds "
          f"{RECORDED_EARLIER_MS['auction'][1]} ms")

    # times: the three stages of the last recorded step, each its own matrix
    entry_stages = {}
    for st, ben, ok, c in tracked[-3:]:
        ms, how = kernel_ms(lambda: lap.auction_rounds(ben, ok, c), "auction", "auction",
                            f"auction_rounds (stage {st})")
        done, record = auction_against_plain(ben, ok, c, 512, f"timed stage {st}")
        plain = cuda_ms(lambda: lap.auction_rounds_plain(ben, ok, c), reps=5, warmup=1)
        t_bytes, t_ops, bound, by = auction_bound(1, r, ctot, sum(record))
        print(f"kernel auction stage {st}: {ms:.4f} ms device time a launch ({how}; the earlier design "
              f"{RECORDED_EARLIER_MS['auction'][st]} ms, recorded in PERF.md, not measured here), {done} rounds "
              f"({sum(record)} bidding rows); plain (the eager loop on the card, a host sync a round) {plain:.4f} ms; "
              f"needs {r * ctot * 4 + r + r * 8 + 4} B = {t_bytes * 1e3:.4f} us and {3 * ctot * sum(record)} f32 "
              f"instructions = {t_ops * 1e3:.5f} us -> bound {bound * 1e3:.4f} us by {by}, launch {ms / bound:.0f}x "
              f"over it")
        entry_stages[str(st)] = {"ms": ms, "rounds": done, "bidding_rows": sum(record), "plain_ms": plain,
                                 "bound_ms": bound, "bound_by": by}
    lc.restore(saved)  # comparison launches are not main-path launches
    mean = {k: sum(v[k] for v in entry_stages.values()) / 3 for k in ("ms", "plain_ms", "bound_ms")}
    return {
        "name": "auction",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/auction.cu",
        "replaces": "eagle_tpu/ops/assignment.py:207 (auction_assignment's rounds, XLA while_loop)",
        "launches": None,
        "max_abs_err": 0,
        "ms": mean["ms"],
        "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": entry_stages["1"]["bound_by"],
        "library_ms": None,
        "shape": [r, ctot],
        "stages": entry_stages,
        "tracker_solves": {str(k): v for k, v in per_stage.items()},
        "ms_by_rounds": {str(k): v for k, v in by_rounds.items()},
        "round_ms": round_ms,
    }


def nms_bound(valid, k: int) -> tuple[float, float, float, str, int]:
    """(bytes ms, operations ms, bound ms, what bounds it, pairs) of the
    suppression of B images of k candidates whose valid ones number v_b:
    the boxes and valid read once and keep written once; 18 float32
    instructions an IoU of each pair i < j of valid candidates (4 min /
    max, 2 subtractions, 2 clamps, 3 products, 3 subtractions for the
    area, an addition and a subtraction for the union, the clamp and the
    division; the compare)."""
    v = valid.sum(dim=1).cpu().numpy().astype(np.int64)
    pairs = int((v * (v - 1) // 2).sum())
    b = valid.shape[0]
    nbytes = b * k * (16 + 1 + 1)
    ops = 18 * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_INSTR_S * 1e3
    return t_bytes, t_ops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", pairs


def nms_kernel(batches: list) -> dict:
    """The NMS kernel on the card: the slice's 16-frame detector batch and
    the kernel_cases images (IoU exactly at the threshold and one float32
    step above, a 12-link chain, an empty and an overflowing image) at k =
    512, keep bit-equal to ``suppress_plain`` on CPU copies; no host sync
    in ``batched_nms``; device ms a launch, the plain version's ms on the
    same CUDA tensors, the bound.  Returns the nms entry."""
    import torch

    from eagle_tpu_torch.ops import nms
    from eagle_tpu_torch.utils.kernel_cases import ANCHORS, CHAIN, NMS_KINDS, nms_cases, nms_wide_case, suppress_inputs

    saved = lc.snapshot()
    shifted, valid, thr = batches[0]

    def against_plain(s, v, what):
        before = lc.get("nms")
        got = nms.suppress(s, v, thr)
        torch.cuda.synchronize()
        if lc.get("nms") != before + 1:
            fail(f"suppress on CUDA tensors ({what}) did not launch the kernel once")
        want = nms.suppress_plain(s.cpu(), v.cpu(), thr)
        if not torch.equal(got.cpu(), want):
            bad = torch.nonzero(got.cpu() != want)[:10].tolist()
            fail(f"the NMS kernel's keep differs from the plain version's ({what}) at {bad}")
        return want

    def against_plain_on_card(s, v, what):
        before = lc.get("nms")
        got = nms.suppress(s, v, thr)
        want = nms.suppress_plain(s, v, thr)
        if lc.get("nms") != before + 1 or not torch.equal(got, want):
            fail(f"the NMS kernel's keep differs from the plain version's ({what})")
        return got

    keep = against_plain(shifted, valid, "the slice's detector batch")
    cases = []
    seen = [suppress_inputs(*nms_cases(seed), 512, device="cuda") for seed in (SEED, SEED + 1)]
    for k, (s, v) in enumerate(seen):
        want = against_plain(s, v, f"kernel_cases seed {k}")
        if want[NMS_KINDS.index("threshold"), :4].tolist() != [True, True, True, False] or want[
            NMS_KINDS.index("chain"), :CHAIN
        ].tolist() != [m % 2 == 0 for m in range(CHAIN)]:
            fail("the kernel_cases threshold pairs or chain did not resolve as built")
        cases.append(s.shape[0])
    boxes, scores = (torch.from_numpy(a).cuda() for a in nms_cases(SEED))
    syncs = host_syncs(lambda: nms.batched_nms(boxes, scores))
    if syncs:
        fail(f"batched_nms on the card synchronised with the host {syncs} times")
    b, k = valid.shape
    print(f"kernel nms: the slice's detector batch ({b} x {k}, {int(valid.sum())} valid, {int(keep.sum())} kept) and "
          f"{sum(cases)} kernel_cases images (threshold pairs, a {CHAIN}-link chain, empty, overflow) == plain bit "
          f"for bit; batched_nms {syncs} host syncs")

    ms, how = kernel_ms(lambda: nms.suppress(shifted, valid, thr), "nms", "nms_suppress", "suppress",
                        per_call=2)
    plain = cuda_ms(lambda: nms.suppress_plain(shifted, valid, thr), reps=5, warmup=1)
    t_bytes, t_ops, bound, by, pairs = nms_bound(valid, k)
    print(f"kernel nms: {ms:.4f} ms device time a launch ({how}; the earlier one-block design "
          f"{RECORDED_EARLIER_MS['nms']} ms, recorded in PERF.md, not measured here); plain (the dense IoU block "
          f"and the loop on the card, a host sync a pass) {plain:.4f} ms; "
          f"needs {b * k * 18} B = {t_bytes * 1e3:.4f} us and {18 * pairs} f32 instructions ({pairs} pairs) = "
          f"{t_ops * 1e3:.4f} us -> bound {bound * 1e3:.4f} us by {by}, launch {ms / bound:.1f}x over it")

    # past 1024 candidates, one image each, up to the anchor count: the
    # plain version's dense (k, k) block on the same CUDA tensors
    wide = {}
    for kw in (1025, 2048, 4096, ANCHORS):
        sw, vw = suppress_inputs(*nms_wide_case(kw, b=1, seed=kw), kw, device="cuda")
        got = against_plain_on_card(sw, vw, f"one image of {kw} candidates")
        wms, whow = kernel_ms(lambda: nms.suppress(sw, vw, thr), "nms", "nms_suppress",
                              f"suppress at k = {kw}", reps=5, per_call=2)
        wb, wo, wbound, wby, wpairs = nms_bound(vw, kw)
        wide[str(kw)] = {"valid": int(vw.sum()), "kept": int(got.sum()), "ms": wms, "bound_ms": wbound,
                         "bound_by": wby}
        print(f"kernel nms at 1 x {kw}: {int(vw.sum())} valid, {int(got.sum())} kept == plain; {wms:.4f} ms device "
              f"time a launch ({whow}); bound {wbound * 1e3:.4f} us by {wby} ({wpairs} pairs), {wms / wbound:.1f}x")
    lc.restore(saved)  # comparison launches are not main-path launches
    return {
        "name": "nms",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/nms.cu",
        "replaces": "eagle_tpu/ops/nms.py:95 (nms's suppression, XLA while_loop)",
        "launches": None,
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "shape": [b, k],
        "pairs": pairs,
        "wide": wide,
    }


def phase_loops(model, frames) -> tuple[dict, dict]:
    """The two device loops' kernels against their plain versions at the
    main path's shapes, on the tracker's and the detector's own inputs
    (recorded in one run of the slice model on the first 16 frames) and on
    edge cases.  Returns (the auction entry, the nms entry)."""
    t0 = time.perf_counter()
    solves, batches = record_loop_inputs(model, frames[:16])
    if len(solves) < 45 or len(solves) % 3 or not batches:
        fail(f"the slice model's run on 16 frames made {len(solves)} solver calls and {len(batches)} suppressions")
    entries = auction_kernel(solves), nms_kernel(batches)
    nms_wide_slice(model, frames[:16])
    print(f"loops: phase wall {time.perf_counter() - t0:.1f} s")
    return entries


def nms_wide_slice(model, frames) -> None:
    """``get_coordinates`` of the slice model on ``frames`` with the
    detector's ``nms_pre_topk`` at WIDE_PRE_TOPK: one NMS launch a batch at
    that width, and the same coordinates as at the default 512 (the
    seeded detector's valid candidates, ~90 an image, all lie in the first
    512, and the candidates past them can only add boxes after the kept
    ones, which max_det already cut)."""
    import dataclasses

    from eagle_tpu_torch.ops import nms
    from eagle_tpu_torch.pipeline.coordinate_model import PIECE

    want = model.get_coordinates(frames, FPS, num_keypoint_detection=3)
    cfg = model.config
    widths = []
    real = nms.suppress

    def record(shifted, valid, thr):
        widths.append(shifted.shape[1])
        return real(shifted, valid, thr)

    model.config = cfg.replace(detector=dataclasses.replace(cfg.detector, nms_pre_topk=WIDE_PRE_TOPK))
    nms.suppress = record
    launches0 = lc.get("nms")
    try:
        got = model.get_coordinates(frames, FPS, num_keypoint_detection=3)
    finally:
        model.config, nms.suppress = cfg, real
    batches = -(-len(frames) // PIECE)
    if widths != [WIDE_PRE_TOPK] * batches or lc.get("nms") - launches0 != batches:
        fail(f"get_coordinates at nms_pre_topk={WIDE_PRE_TOPK} suppressed at widths {widths} in "
             f"{lc.get('nms') - launches0} launches")
    if got != want:
        bad = [i for i in want if got.get(i) != want[i]]
        fail(f"get_coordinates at nms_pre_topk={WIDE_PRE_TOPK} differs from the run at 512 in frames {bad[:10]}")
    print(f"loops: get_coordinates at nms_pre_topk={WIDE_PRE_TOPK} on {len(frames)} frames: {batches} NMS launches "
          f"at k = {WIDE_PRE_TOPK}, the coordinates == the run at 512")


# ---------------------------------------------------------------------------
# the reference's tracker: ReID association and the features GMC
# ---------------------------------------------------------------------------


def tracker_config(use_bf16: bool, reid_slots: int):
    """DEFAULT_CONFIG with the reference's tracker: OSNet-x0.25 ReID (512-d,
    the seeded random init) and the features GMC."""
    import dataclasses

    from eagle_tpu_torch import DEFAULT_CONFIG

    cfg = DEFAULT_CONFIG
    tracker = dataclasses.replace(
        cfg.tracker, gmc="features", use_appearance=True, embedder="osnet", embed_dim=512, reid_slots=reid_slots
    )
    return cfg.replace(detector=dataclasses.replace(cfg.detector, use_bf16=use_bf16), tracker=tracker)


def tracker_model(cfg, **kw):
    """CoordinateModel on ``cfg``, without the warning that its OSNet has
    random weights (it has, on purpose)."""
    import warnings

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="OSNet ReID enabled without weights")
        return CoordinateModel(config=cfg, **kw)


def grid_corner_input(frames, canvas: bool):
    """The features GMC's flow step on frames 0 and 1 of the clip: on the
    544x960 canvas (the slice's 4:2:0 prescale and decode) or raw 1280x720
    frames uploaded as the identity path uploads them; the grid corners of
    frame 0 and their valid mask."""
    import torch

    from eagle_tpu_torch.ops.corners import grid_corners
    from eagle_tpu_torch.ops.optical_flow import upload_frames
    from eagle_tpu_torch.ops.preprocess import compute_work_geometry, host_letterbox_i420, i420_to_bgr

    dev = torch.device("cuda")
    if canvas:
        geom = compute_work_geometry(FRAME_HW, 960)
        x = i420_to_bgr(torch.from_numpy(host_letterbox_i420(frames[[0, 1]], geom)).to(dev))
    else:
        x = upload_frames(frames[[0, 1]], dev)
    p, valid = grid_corners(x[0])
    return x[0], x[1], p, valid


def tracker_kernel(frames) -> dict:
    """(a) The flow kernel at K = 240 on grid corners, raw and on the
    canvas, against its plain version; device time, plain time and bound
    on the canvas; the features GMC's time a frame and its host syncs.
    Returns the lk_flow entry's K = 240 fields."""
    from eagle_tpu_torch.ops import optical_flow as of

    saved = lc.snapshot()
    for canvas in (False, True):
        prev, curr, p, valid = grid_corner_input(frames, canvas)
        if any(of._pitched(f)[0].data_ptr() != f.data_ptr() for f in (prev, curr)):
            fail("a frame of the features GMC would be staged into a pitched copy")
        err, s_p = flow_against_plain(of, prev, curr, p, valid)
        h, w = prev.shape[:2]
        print(f"tracker kernel lk_flow: K={p.shape[0]} grid corners of a {h}x{w} pair, {int(valid.sum())} valid, "
              f"ok={int(s_p.sum())}, max |kernel - plain| = {err:.3e} px, no frame staged")
        if s_p.sum() < 50:
            fail("fewer than 50 grid corners tracked: the K = 240 check is too thin")

    # prev, curr, p, valid are the canvas pair's: the full-width slice's frames
    t = flow_times(of, prev, curr, p, valid)
    gmc_ms, gmc_syncs = features_gmc_timing(prev, curr)
    lc.restore(saved)  # comparison launches are not main-path launches
    step, ms = t["step"], t["step"]["flow_kernel_ms"]
    seen = check_flow_step(step, "at K = 240")
    print(f"tracker kernel lk_flow: K=240 {ms:.4f} ms device time a launch ({seen}), call "
          f"{step['wall_ms_per_call']:.4f} ms (CUDA events), plain {t['plain_ms']:.3f} ms; {work_line(t)}")
    print(f"tracker features GMC: {gmc_ms:.3f} ms a frame on the canvas (grid corners, the K = 240 flow step, "
          f"the robust fit and the fallback warp; CUDA events), {gmc_syncs} host syncs")
    if gmc_syncs:
        fail(f"the features GMC synchronises with the host {gmc_syncs} times a frame")
    return {"max_abs_err_k240": err, "ms_k240": ms, "plain_ms_k240": t["plain_ms"], "bound_ms_k240": t["bound"],
            "bound_by_k240": t["bound_by"], "features_gmc_ms": gmc_ms}


def features_gmc_timing(prev, curr) -> tuple[float, int]:
    """One features-GMC warp (``temporal._features_gmc_warp``) on a canvas
    pair, as the tracker's slice runs it each frame: its time a call (CUDA
    events over 20 calls) and the synchronising operations of one call
    (``torch.cuda.set_sync_debug_mode``)."""
    import types

    import torch

    from eagle_tpu_torch.ops.preprocess import compute_work_geometry
    from eagle_tpu_torch.pipeline import temporal

    dev = prev.device
    cfg = tracker_config(use_bf16=True, reid_slots=64).replace(work=compute_work_geometry(FRAME_HW, 960))
    carry = types.SimpleNamespace(kp_xy=torch.zeros(57, 2, device=dev))
    xs = types.SimpleNamespace(prev_frame_bgr=prev, frame_bgr=curr)
    flow_xy, flow_valid = torch.zeros(57, 2, device=dev), torch.zeros(57, dtype=torch.bool, device=dev)

    def call():
        return temporal._features_gmc_warp(carry, xs, cfg, flow_xy, flow_valid)

    call()
    torch.cuda.synchronize()
    syncs = host_syncs(call)
    return cuda_ms(call, reps=20), syncs


def tracker_reference(frames, pts) -> None:
    """(b) The oracle clip with the features GMC and float32 OSNet: card ==
    plain CPU path; the embeddings' largest difference."""
    import torch

    from eagle_tpu_torch.ops.optical_flow import upload_frames

    clip = frames[:REF_FRAMES]
    cfg = tracker_config(use_bf16=False, reid_slots=REF_REID_SLOTS)
    res, models = {}, {}
    for dev in ("cuda", "cpu"):
        kp_fn, det_fn, _ = oracle_models(clip, pts)
        models[dev] = tracker_model(cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device=dev)
        lc.reset("lk_flow")
        res[dev] = models[dev].get_coordinates(clip, FPS, num_keypoint_detection=6)
        if dev == "cuda":
            torch.cuda.synchronize()
            n240 = lc.get("lk_flow/k=240")
    bad = coords_mismatch(res["cuda"], res["cpu"])
    if bad:
        fail(f"the tracker (features GMC, OSNet f32) on the card differs from its plain CPU path: {bad}")
    boxes = torch.from_numpy(oracle_models(clip, pts)[1](clip)[0])
    emb_card = models["cuda"].embed(upload_frames(clip, "cuda"), boxes.cuda()).cpu()
    emb_cpu = models["cpu"].embed(torch.from_numpy(clip), boxes)
    emb_err = float((emb_card - emb_cpu)[:, :REF_REID_SLOTS].abs().max())
    n_players = min(len(fr["Coordinates"].get("Player", {})) for fr in res["cuda"].values())
    print(f"tracker reference: {len(clip)} frames, features GMC and OSNet f32 ({REF_REID_SLOTS} slots), card == "
          f"plain CPU path; {n240} K=240 launches; embeddings max |card - CPU| = {emb_err:.3e}; "
          f">= {n_players} players tracked per frame")
    if n240 < len(clip) or n_players != 6:
        fail("the tracker's reference clip did not run the features GMC every frame or lost players")


def tracker_slice(frames, slice_model):
    """(c) The full-width slice with the reference's tracker (bf16 OSNet,
    64 slots, 512-d, the features GMC), on the slice model's weights;
    (d) the bf16 embeddings against float32.  Returns (the K = 57 and
    K = 240 launches of the run, the model)."""
    import copy

    import torch

    from eagle_tpu_torch.models.osnet import embed_boxes
    from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

    cfg = tracker_config(use_bf16=True, reid_slots=64)
    model = tracker_model(cfg, seed=SEED, device="cuda")
    model.keypoint_model.load_state_dict(slice_model.keypoint_model.state_dict())
    model.detector_model.load_state_dict(slice_model.detector_model.state_dict())
    model.get_coordinates(frames[:16], FPS, num_keypoint_detection=3)  # warm-up
    torch.cuda.synchronize()

    timer = StageTimer(model.device, sync=True)
    zero_loop_counts()
    stepped0 = model.frames_stepped
    t0 = time.perf_counter()
    res = model.get_coordinates(frames, FPS, num_keypoint_detection=3, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n57, n240 = lc.get("lk_flow/k=57"), lc.get("lk_flow/k=240")
    loops, stepped = loop_counts(), model.frames_stepped - stepped0
    if sorted(res) != list(range(len(frames))) or any(
        set(fr) != {"Coordinates", "Time", "Keypoints", "Boundaries"} for fr in res.values()
    ):
        fail("the tracker's slice did not return one entry per frame with the four keys")
    if "reid" not in timer.seconds or n240 < len(frames) or n57 < len(frames) - 1:
        fail(f"the tracker's slice did not embed or did not run both flows: launches K=57 {n57}, K=240 {n240}")
    if loops["auction"] != 3 * stepped or not loops["nms"]:
        fail(f"the tracker's slice: {loop_line(loops)} for {stepped} temporal steps")
    n_tracked = np.mean([len(fr["Coordinates"].get("Player", {})) + len(fr["Coordinates"].get("Goalkeeper", {}))
                         for fr in res.values()])
    stages = {k: round(v * 1e3, 3) for k, v in timer.seconds.items()}
    print(f"tracker slice: {len(frames)} frames (OSNet-x0.25 bf16, 64 slots, 512-d; features GMC) in {wall:.3f} s "
          f"= {len(frames) / wall:.2f} fps; stage ms {json.dumps(stages)}; lk_flow launches K=57 {n57}, "
          f"K=240 {n240}; {loop_line(loops)}; tracked players and goalkeepers {n_tracked:.2f} a frame")

    geom = model._geometry(FRAME_HW)
    x = model.upload(frames[:16], geom)
    with torch.no_grad():
        rows = model.run_detector(x, geom, FRAME_HW)
        pad = torch.tensor([geom.pad_x, geom.pad_y] * 2, dtype=torch.float32, device=x.device)
        boxes = (rows[:, :64, :4] * geom.gain + pad).contiguous()
        valid = rows[:, :64, 6] > 0.5
        e16 = embed_boxes(model.reid_model, x, boxes)
        r32 = copy.deepcopy(model.reid_model)
        r32.use_bf16 = False
        e32 = embed_boxes(r32, x, boxes)
        emb_err = float((e16 - e32).abs()[valid].max())
        norm_err = float((torch.linalg.vector_norm(e16[valid], dim=-1) - 1).abs().max())
    torch.cuda.synchronize()
    print(f"bf16 vs float32: OSNet embeddings of {int(valid.sum())} detections {emb_err:.3e} "
          f"(atol {BF16_EMBED_ATOL}); unit norm within {norm_err:.1e}")
    if not (emb_err <= BF16_EMBED_ATOL and norm_err < 1e-3):
        fail("bf16 OSNet embeddings disagree with float32")
    return n57, n240, model


def phase_tracker(frames, pts, slice_model):
    """The reference's tracker on the card: (a) the K = 240 kernel, (b) the
    reference clip, (c) the full-width slice, (d) bf16 OSNet.  Returns (the
    lk_flow entry's tracker fields, the tracker model)."""
    fields = tracker_kernel(frames)
    tracker_reference(frames, pts)
    n57, n240, model = tracker_slice(frames, slice_model)
    fields.update(tracker_launches_k57=n57, tracker_launches_k240=n240)
    return fields, model


# ---------------------------------------------------------------------------
# the exact assignment solver: the JV kernel behind TrackerConfig.assignment="exact"
# ---------------------------------------------------------------------------


def exact_config(**tracker):
    """DEFAULT_CONFIG with ``assignment="exact"`` (and any other tracker
    fields given)."""
    import dataclasses

    from eagle_tpu_torch import DEFAULT_CONFIG

    return DEFAULT_CONFIG.replace(
        tracker=dataclasses.replace(DEFAULT_CONFIG.tracker, assignment="exact", **tracker)
    )


def lap_inputs(model, frames) -> dict:
    """The JV kernel's inputs on the card, name -> (B, n, n) float32:
    ``tracking``: LAP_PAIRS extended matrices (``extended_cost``) of the
    tracker's first stage at the main path's n = 192, made from the slice
    model's detections on the slice's own frames: the 64 track slots hold
    frame t's first 64 detection slots (the predicted boxes of tracks
    that stood there), the 128 columns frame t + 1's, 1 - IoU costs, rows
    and columns valid at the high threshold, gate ``match_thresh``;
    ``tracking_300``: the same at n = LAP_N_GLOBAL (100 slots of frame t
    against frame t + 1's 128 and frame t + 2's first 72), too large for
    the block's shared memory; ``random``, ``random_300`` and
    ``random_1025``: uniform costs at those sizes and at LAP_N_WIDE."""
    import torch

    from eagle_tpu_torch.ops.assignment import extended_cost
    from eagle_tpu_torch.ops.nms import box_iou_matrix

    tcfg = model.config.tracker
    starts = list(range(0, len(frames) - 2, (len(frames) - 2) // LAP_PAIRS))[:LAP_PAIRS]
    geom = model._geometry(FRAME_HW)
    with torch.no_grad():
        dets = {t: model.run_detector(model.upload(frames[t : t + 3], geom), geom, FRAME_HW) for t in starts}

    def extended(tracks, cols):
        rows_ok = (tracks[:, 6] > 0.5) & (tracks[:, 4] > tcfg.track_high_thresh)
        cols_ok = (cols[:, 6] > 0.5) & (cols[:, 4] > tcfg.track_high_thresh)
        cost = (1.0 - box_iou_matrix(tracks[:, :4], cols[:, :4])).contiguous()
        return extended_cost(cost, rows_ok, cols_ok, tcfg.match_thresh)[0]

    t_slots, g_rows = tcfg.max_tracks, LAP_N_GLOBAL // 3
    d0 = dets[starts[0]]
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    return {
        "tracking": torch.stack([extended(dets[t][0, :t_slots], dets[t][1]) for t in starts]),
        "tracking_300": extended(d0[0, :g_rows], torch.cat([d0[1], d0[2, : LAP_N_GLOBAL - g_rows - d0.shape[1]]]))[None],
        "random": torch.from_numpy(rng.uniform(0, 1, (1, LAP_N, LAP_N)).astype(np.float32)).to(dev),
        "random_300": torch.from_numpy(rng.uniform(0, 1, (1, LAP_N_GLOBAL, LAP_N_GLOBAL)).astype(np.float32)).to(dev),
        "random_1025": torch.from_numpy(rng.uniform(0, 1, (1, LAP_N_WIDE, LAP_N_WIDE)).astype(np.float32)).to(dev),
    }


def lap_against_plain(costs) -> tuple[list[int], float]:
    """One launch of the JV kernel over ``costs`` (B, n, n) against
    ``solve_lap_plain`` on a copy moved to the CPU, matrix by matrix: fails
    unless it launched once on the path its size asks for, the indices are
    bit-equal, and each assignment's float64 total equals scipy's
    ``linear_sum_assignment`` optimum and the host JV's (``native.lapjv``)
    within LAP_RTOL.  Returns (the plain version's augmenting steps of
    each matrix, the plain version's host ms over the B matrices)."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from eagle_tpu_torch import native
    from eagle_tpu_torch.ops import assignment as lap

    b, n, _ = costs.shape
    path = lap.kernel_path(n)
    before, on_path = lc.get("lap_jv"), lc.get(f"lap_jv/{path}")
    got = lap.solve_lap(costs if b > 1 else costs[0]).reshape(b, n)
    torch.cuda.synchronize()
    if lc.get("lap_jv") != before + 1 or lc.get(f"lap_jv/{path}") != on_path + 1:
        fail(f"solve_lap on a CUDA ({b}, {n}, {n}) tensor did not launch the kernel once on its {path} path")
    got = got.cpu().numpy()
    steps, plain_s = [], 0.0
    for k in range(b):
        c = costs[k].cpu()
        t0 = time.perf_counter()
        want, st = lap.jv_plain(c)
        plain_s += time.perf_counter() - t0
        steps.append(st)
        if not np.array_equal(got[k], want.numpy()):
            fail(f"the lap_jv kernel ({path} path, n = {n}) differs from the plain version on matrix {k} at rows "
                 f"{np.flatnonzero(got[k] != want.numpy())[:10].tolist()}")
        c64 = c.double().numpy()
        total = c64[np.arange(n), got[k]].sum()
        ri, ci = linear_sum_assignment(c64)
        for who, opt in (("scipy", c64[ri, ci].sum()), ("native.lapjv", native.lapjv(c64)[1])):
            if not abs(total - opt) <= LAP_RTOL * abs(opt) + 1e-9:
                fail(f"the lap_jv kernel's total {total} at n = {n} is not {who}'s optimum {opt}")
    return steps, plain_s * 1e3


def lap_kernel_ms(costs, reps: int = 20) -> tuple[float, str]:
    """Device time of one JV launch over ``costs`` from the profiler's
    trace over ``reps`` calls (:func:`traced_flow`), or by CUDA events
    where no session traced one; fails unless each call launched the
    kernel once and ran no other device operation."""
    from eagle_tpu_torch.ops import assignment as lap

    def call():
        return lap.solve_lap(costs)

    tr = traced_flow(call, reps, kernel="lap_jv", count="lap_jv")
    if tr["launched"] != reps or len(tr["ops"]) != len(tr["flow"]) or len(tr["flow"]) > reps:
        fail(f"{reps} solve_lap calls launched the kernel {tr['launched']} times and traced "
             f"{len(tr['ops']) - len(tr['flow'])} other device operations")
    if tr["flow"]:
        return sum(tr["flow"]) / len(tr["flow"]) / 1e3, f"profiler, {len(tr['flow'])} of {reps} traced"
    return cuda_ms(call, reps=reps), f"CUDA events (no lap_jv kernel traced in {tr['sessions']} sessions)"


def ptxas_lines(log: str, k: int, shared: bool) -> list[str]:
    """The ``-Xptxas -v`` lines (stack frame and spills, registers) of the
    JV kernel's instantiation with ``k`` columns a lane on the shared or
    global path (k = 0: the kernel with the vectors in shared memory) in
    the compiler's output ``log``."""
    name = f"lap_jvILi{k}ELb{int(shared)}E" if k else "lap_jv_wide"
    lines, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = name in line
        elif inside and ("stack frame" in line or "registers" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    return lines


def lap_bound(b: int, n: int, steps: int) -> tuple[float, float, float, str]:
    """(bytes ms, operations ms, bound ms, what bounds it) of a JV solve of
    B (n, n) matrices whose augmenting steps number ``steps`` in all: the
    costs read once and the row -> column indices written once; 5 float32
    instructions a column a step (two subtractions, the strict compare, the
    argmin's compare and one dual update)."""
    nbytes = b * (n * n * 4 + n * 4)
    ops = 5 * (n + 1) * steps
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_INSTR_S * 1e3
    return t_bytes, t_ops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def exact_kernel(model, frames, build_log: str) -> dict:
    """(a) The JV kernel on tracking-like and random matrices at n = 192
    (the shared-memory path) and n = LAP_N_GLOBAL (the global path), and as
    one launch over LAP_PAIRS matrices, against the plain version, scipy and
    the host JV (:func:`lap_against_plain`), with the batched launch equal
    to single launches; device ms a launch, steps, bound, the plain
    version's and scipy's host ms.  Returns the lap_jv entry."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from eagle_tpu_torch.ops import assignment as lap

    saved = lc.snapshot()
    inputs = lap_inputs(model, frames)
    if lap.kernel_path(LAP_N) != "shared" or lap.kernel_path(LAP_N_GLOBAL) != "global":
        fail(f"lap_jv paths: n = {LAP_N} takes {lap.kernel_path(LAP_N)}, n = {LAP_N_GLOBAL} "
             f"{lap.kernel_path(LAP_N_GLOBAL)}; expected shared and global")
    if lap.kernel_columns(LAP_N_WIDE) != 0:
        fail(f"lap_jv at n = {LAP_N_WIDE} keeps {lap.kernel_columns(LAP_N_WIDE)} columns a lane in registers")
    variants = {}
    for n in (LAP_N, LAP_N_GLOBAL, LAP_N_WIDE):
        k, path = lap.kernel_columns(n), lap.kernel_path(n)
        lines = ptxas_lines(build_log, k, path == "shared") or ["library already built: no compiler output"]
        variants[str(n)] = {"columns_a_lane": k, "path": path, "ptxas": lines}
        print(f"exact kernel lap_jv at n = {n}: one warp, K = {k} columns a lane, {path} path; ptxas: "
              f"{'; '.join(lines)}")
    entry = {}
    for name, costs in inputs.items():
        b, n, _ = costs.shape
        cases = [(name, costs[:1])] + ([(f"{name}_batch", costs)] if b > 1 else [])
        for case, c in cases:
            steps, plain_ms = lap_against_plain(c)
            ms, how = lap_kernel_ms(c if len(c) > 1 else c[0])
            t_bytes, t_ops, bound, by = lap_bound(len(c), n, sum(steps))
            host = []
            for k in range(len(c)):
                c64 = c[k].double().cpu().numpy()
                t0 = time.perf_counter()
                linear_sum_assignment(c64)
                host.append(time.perf_counter() - t0)
            scipy_ms = sum(host) * 1e3
            # the B matrices run side by side: a step of the launch is one of its longest solve's
            ns_step = ms * 1e6 / max(steps)
            print(f"exact kernel lap_jv {case}: B={len(c)} n={n} ({lap.kernel_path(n)} path) == plain bit for bit, "
                  f"total == scipy and native.lapjv within {LAP_RTOL}; {ms:.4f} ms device time a launch ({how}); "
                  f"{sum(steps)} augmenting steps ({steps}), {ns_step:.1f} ns a step; plain {plain_ms:.3f} ms (CPU), scipy "
                  f"linear_sum_assignment {scipy_ms:.3f} ms (host, float64); needs {len(c) * (n * n + n) * 4} B = "
                  f"{t_bytes * 1e3:.4f} us and {5 * (n + 1) * sum(steps)} f32 instructions = {t_ops * 1e3:.4f} us "
                  f"-> bound {bound * 1e3:.4f} us by {by}, launch {ms / bound:.0f}x over it")
            entry[case] = {"n": n, "b": len(c), "ms": ms, "steps": sum(steps), "ns_per_step": ns_step,
                           "plain_ms": plain_ms, "scipy_host_ms": scipy_ms, "bound_ms": bound, "bound_by": by}
        if b > 1:
            singles = torch.stack([lap.solve_lap(costs[k]) for k in range(b)])
            if not torch.equal(lap.solve_lap(costs), singles):
                fail(f"the batched lap_jv launch over {b} matrices differs from {b} single launches")
    lc.restore(saved)  # comparison launches are not main-path launches
    main = entry["tracking"]
    return {
        "name": "lap_jv",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/lap_jv.cu",
        "replaces": "eagle_tpu/ops/assignment.py:30 (solve_lap, XLA while_loop)",
        "launches": None,
        "max_abs_err": 0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "host_library": "scipy.optimize.linear_sum_assignment",
        "host_library_ms": main["scipy_host_ms"],
        "n": LAP_N,
        "steps": main["steps"],
        "ns_per_step": main["ns_per_step"],
        "instantiations": variants,
        "cases": {k: v for k, v in entry.items() if k != "tracking"},
    }


def exact_reference(frames, pts) -> None:
    """(b) The 12-frame oracle clip with ``assignment="exact"``, card ==
    the port's CPU path (REF_* tolerances), the card's JV launches 3 a
    temporal step.  EXACT_REF_SLOTS keep the CPU side's plain version
    short (n = 56)."""
    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    clip = frames[:REF_FRAMES]
    t_slots, d_slots = EXACT_REF_SLOTS
    cfg = exact_config(max_tracks=t_slots)
    res = {}
    for dev in ("cuda", "cpu"):
        kp_fn, det_fn, _ = oracle_models(clip, pts)
        model = CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=lambda b, f=det_fn: tuple(
            x[:, :d_slots] for x in f(b)), device=dev)
        launches0 = lc.get("lap_jv")
        res[dev] = model.get_coordinates(clip, FPS, num_keypoint_detection=6)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched, stepped = lc.get("lap_jv") - launches0, model.frames_stepped
    bad = coords_mismatch(res["cuda"], res["cpu"])
    if bad:
        fail(f"the exact solver's oracle clip on the card differs from its plain CPU path: {bad}")
    n_players = min(len(fr["Coordinates"].get("Player", {})) for fr in res["cuda"].values())
    print(f"exact reference: {len(clip)} frames, {t_slots} track and {d_slots} detection slots (n = "
          f"{t_slots + d_slots}), card == plain CPU path; {launched} lap_jv launches for {stepped} temporal steps; "
          f">= {n_players} players tracked per frame")
    if launched != 3 * stepped or stepped < len(clip) or n_players != 6:
        fail("the exact solver's oracle clip did not solve 3 assignments a step on the card or lost players")


def exact_slice(frames, slice_model, slice_res: dict) -> int:
    """(c) The full-width slice with ``assignment="exact"`` on the slice
    model's weights: fps, stage ms, JV launches (3 a temporal step, each on
    the shared path; no auction round), then the slice with each solver
    under the profiler: the temporal step's blocking calls, idle share and
    the JV kernels' device time; the share of frames whose track ids
    differ from the auction slice's (information).  Returns the JV launches
    of the timed run."""
    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel, StageTimer

    model = CoordinateModel(config=exact_config(), seed=SEED, device="cuda")
    model.keypoint_model.load_state_dict(slice_model.keypoint_model.state_dict())
    model.detector_model.load_state_dict(slice_model.detector_model.state_dict())
    model.get_coordinates(frames[:16], FPS, num_keypoint_detection=3)  # warm-up
    torch.cuda.synchronize()

    timer = StageTimer(model.device, sync=True)
    zero_loop_counts()
    stepped0 = model.frames_stepped
    t0 = time.perf_counter()
    res = model.get_coordinates(frames, FPS, num_keypoint_detection=3, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shared, loops, stepped = lc.get("lap_jv"), lc.get("lap_jv/shared"), loop_counts(), \
        model.frames_stepped - stepped0
    if sorted(res) != list(range(len(frames))) or any(
        set(fr) != {"Coordinates", "Time", "Keypoints", "Boundaries"} for fr in res.values()
    ):
        fail("the exact solver's slice did not return one entry per frame with the four keys")
    if launches != 3 * stepped or stepped < len(frames) or shared != launches or loops["auction"] or not loops["nms"]:
        fail(f"the exact solver's slice: {launches} lap_jv launches ({shared} on the shared path) for {stepped} "
             f"temporal steps, {loop_line(loops)}; expected 3 a step, all shared, no auction launch")
    stages = {k: round(v * 1e3, 3) for k, v in timer.seconds.items()}
    print(f"exact slice: {len(frames)} frames (DEFAULT_CONFIG, assignment='exact', n = {LAP_N}) in {wall:.3f} s = "
          f"{len(frames) / wall:.2f} fps; stage ms {json.dumps(stages)}; lap_jv launches {launches} for {stepped} "
          f"temporal steps, {loop_line(loops)}; lk_flow launches {lc.get('lk_flow')}")

    profiled = {}
    for name, m in (("exact", model), ("auction", slice_model)):
        counted, loops, (st, by_kernel, _), _, _ = traced_run(m, frames, f"{name} slice", num_keypoint_detection=3)
        if name == "exact" and counted["lap_jv"] != launches:
            fail(f"the exact slice's traced run counted {counted['lap_jv']} lap_jv launches, the timed run {launches}")
        kernels = {kn: [v for k, v in by_kernel.items() if kn in k] for kn in ("lap_jv", "auction", "nms_suppress")}
        profiled[name] = (st, loops, {kn: (sum(c for c, _ in v), sum(ms for _, ms in v))
                                      for kn, v in kernels.items()})
    for name, (st, loops, kernels) in profiled.items():
        tmp, det = st["temporal"], st["detector"]
        print(f"exact slice, profiled ({name} solver, {len(frames)} frames): temporal {tmp['wall_ms']:.3f} ms, "
              f"{tmp['blocking_calls']} blocking calls, host blocked {tmp['host_blocked_ms']:.3f} ms, device idle "
              f"{tmp['device_idle_share']:.3f}; detector {det['wall_ms']:.3f} ms, {det['blocking_calls']} blocking "
              f"calls, device idle {det['device_idle_share']:.3f}; {loop_line(loops)}; kernels traced (count, device "
              f"ms) {json.dumps({k: [n, round(ms, 3)] for k, (n, ms) in kernels.items()})}")
    differ = sum(
        {c: sorted(o) for c, o in res[i]["Coordinates"].items()}
        != {c: sorted(o) for c, o in slice_res[i]["Coordinates"].items()}
        for i in res
    )
    print(f"exact slice: track ids differ from the auction slice's in {differ} of {len(res)} frames "
          f"({differ / len(res):.3f}; information, not a check)")
    return launches


def phase_exact(frames, pts, slice_model, slice_res: dict, build_log: str) -> dict:
    """The exact assignment solver on the card: (a) the JV kernel, (b) the
    oracle clip, (c) the full-width slice.  Returns the lap_jv entry."""
    t0 = time.perf_counter()
    entry = exact_kernel(slice_model, frames, build_log)
    exact_reference(frames, pts)
    entry["launches"] = exact_slice(frames, slice_model, slice_res)
    print(f"exact: phase wall {time.perf_counter() - t0:.1f} s")
    return entry


def decoder_probe() -> str:
    """Which video decoders and encoders this machine has (information,
    fails nothing): NVDEC's and NVENC's driver libraries, an ``ffmpeg``
    binary, and the Python modules ``torchvision.io``, ``torchcodec``, ``av``
    (PyAV) and ``cv2`` (OpenCV, through which ``eagle_tpu_torch.io`` decodes;
    found, not imported)."""
    import ctypes
    import importlib.util
    import shutil

    found = {}
    for lib in ("libnvcuvid.so.1", "libnvidia-encode.so.1"):
        try:
            ctypes.CDLL(lib)
            found[lib] = True
        except OSError:
            found[lib] = False
    found["ffmpeg"] = shutil.which("ffmpeg")
    for mod in ("torchvision.io", "torchcodec", "av", "cv2"):
        try:
            found[mod] = importlib.util.find_spec(mod) is not None
        except ImportError:  # the parent package is missing
            found[mod] = False
    return "decoders: " + json.dumps(found)


def make_match(frames, seed: int = SEED):
    """A match over the pitch frames of :func:`make_frames`: MATCH_PLAYERS
    outfield players a team in KITS and one goalkeeper a team in GK_KITS,
    on a jittered 6 x 4 grid of the pitch (no two boxes overlap), walking
    up to 0.4 px a frame and panned with the camera, taller nearer the
    camera (30 x 72 px at mid-frame); each is a kit-coloured torso over
    narrow dark shorts under a skin-coloured head, so all four corners of
    its box are grass; plus a ball.  Returns (frames, (boxes (n, P, 4)
    float32 image pixels, classes (P,): 0 player, 1 goalkeeper, 2 ball),
    team (P,) int: 0 or 1, -1 for the ball)."""
    n, h, w, _ = frames.shape
    rng = np.random.default_rng(seed + 1)
    slots = [(x, y) for y in (250.0, 400.0, 550.0, 690.0) for x in (190.0, 390.0, 590.0, 790.0, 990.0, 1190.0)]
    take = rng.permutation(len(slots))[: 2 * MATCH_PLAYERS + 2]
    feet0 = np.array([slots[i] for i in take]) + rng.uniform([-20, -10], [20, 10], (len(take), 2))
    vel = rng.uniform(-0.4, 0.4, (len(take), 2))
    team = np.r_[np.arange(2 * MATCH_PLAYERS) % 2, [0, 1], [-1]]
    cls = np.r_[np.zeros(2 * MATCH_PLAYERS, np.int32), [1, 1], [2]].astype(np.int32)
    kits = [KITS[t] for t in team[: 2 * MATCH_PLAYERS]] + GK_KITS
    offs = np.round(1.5 * np.arange(n))  # make_frames' pan
    out = frames.copy()
    boxes = np.zeros((n, len(cls), 4), np.float32)
    for t in range(n):
        img = out[t]
        for k, (u, v) in enumerate(feet0 + vel * t):
            u -= offs[t]
            scale = 0.4 + 0.9 * v / h
            bw, bh = 30 * scale, 72 * scale
            x1, y1, x2, y2 = (int(round(c)) for c in (u - bw / 2, v - bh, u + bw / 2, v))
            bw, bh = x2 - x1, y2 - y1
            mid, quarter = (x1 + x2) // 2, max(1, bw // 5)
            img[y1 : y1 + bh * 15 // 100, mid - quarter : mid + quarter] = (150, 190, 220)
            img[y1 + bh * 15 // 100 : y1 + bh * 60 // 100, x1 + bw // 10 : x2 - bw // 10] = kits[k]
            img[y1 + bh * 60 // 100 : y2, mid - quarter : mid + quarter] = (30, 30, 30)
            boxes[t, k] = (x1, y1, x2, y2)
        bx, by = 330 + 6.0 * t - offs[t], 330 + 2.0 * t
        yy, xx = np.ogrid[:h, :w]
        img[(xx - bx) ** 2 + (yy - by) ** 2 <= 16] = (250, 250, 250)
        boxes[t, -1] = (bx - 5, by - 5, bx + 5, by + 5)
    return out, (boxes, cls), team


def true_teams(coords, boxes, team) -> dict:
    """{track id: true team} for the reported players: each id's first box
    matched to the drawn box it overlaps most (IoU over 0.5)."""
    first = {}
    for i, fr in coords.items():
        for oid, it in fr["Coordinates"].get("Player", {}).items():
            first.setdefault(oid, (i, it["BBox"]))
    out = {}
    for oid, (i, (x1, y1, x2, y2)) in first.items():
        b = boxes[i]
        iw = np.clip(np.minimum(b[:, 2], x2) - np.maximum(b[:, 0], x1), 0, None)
        ih = np.clip(np.minimum(b[:, 3], y2) - np.maximum(b[:, 1], y1), 0, None)
        inter = iw * ih
        iou = inter / ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) + (x2 - x1) * (y2 - y1) - inter)
        if iou.max() > 0.5:
            out[oid] = int(team[int(iou.argmax())])
    return out


def tables_equal(a, b) -> bool:
    """Two Processor tables with equal columns, index and cells (NaN equal
    to NaN)."""

    def same(x, y):
        if isinstance(x, float) and x != x:
            return isinstance(y, float) and y != y
        return type(x) is type(y) and x == y

    return (
        list(a.columns) == list(b.columns)
        and a.index == b.index
        and all(len(a[c]) == len(b[c]) and all(map(same, a[c], b[c])) for c in a.columns)
    )


def phase_process(frames, pts):
    """The CLI's function on the card, frames to the four JSON files, on
    the match of :func:`make_match` with oracle models: the launch counts
    around it, the run's own votes against the plain CPU votes, the
    mapping, the table and the records against the port's CPU Processor on
    the same coordinates, the mapping against the drawn kits, the files
    parsed back; the Processor's stage milliseconds and the frames-to-files
    rate."""
    import tempfile

    import torch

    from eagle_tpu_torch.io.output import dumps_records
    from eagle_tpu_torch.main import run
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel, StageTimer
    from eagle_tpu_torch.pipeline.processor import Processor

    match, people, team = make_match(frames)
    kp_fn, det_fn, _ = oracle_models(match, pts, people)
    model = CoordinateModel(keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda")
    with tempfile.TemporaryDirectory() as warm:  # the allocator, cuSOLVER's first batched eigh
        run(match[:16], FPS, warm, model, annotated=False)
    torch.cuda.synchronize()
    timer = StageTimer(model.device, sync=True)
    with tempfile.TemporaryDirectory() as out_dir:
        lc.reset()
        t0 = time.perf_counter()
        out = run(match, FPS, out_dir, model, annotated=False, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lc.get("lk_flow")
        files = {}
        for name in ("raw_coordinates.json", "raw_data.json", "metadata.json", "processed_data.json"):
            with open(os.path.join(out_dir, name)) as f:
                files[name] = json.load(f)
    if launches < len(match) - 1:
        fail(f"lk_flow kernel launched {launches} times in the CLI run of {len(match)} frames")

    coords, table, mapping, card = out["coordinates"], out["table"], out["team_mapping"], out["processor"]
    cpu = Processor(coords, match, FPS, filter_ball_detections=False, device="cpu")
    cpu_table, cpu_mapping = cpu.process_data()
    if card.crop_entries != cpu.crop_entries:
        fail("the card run voted on other crops than the CPU Processor")
    if not np.array_equal(card.crop_votes, cpu.crop_votes):
        bad = np.flatnonzero((card.crop_votes != cpu.crop_votes).any(1))
        fail(f"team votes on the card differ from the CPU votes on crops {bad.tolist()[:20]}")
    if mapping != cpu_mapping:
        fail(f"team mapping on the card {mapping} differs from the CPU Processor's {cpu_mapping}")
    if not tables_equal(table, cpu_table):
        fail("the Processor's table on the card differs from the CPU Processor's")
    if out["processed"] != cpu.format_data(cpu_table):
        fail("the formatted records on the card differ from the CPU Processor's")
    if (
        files["raw_data.json"] != json.loads(dumps_records(table.records()))
        or files["processed_data.json"] != json.loads(dumps_records(out["processed"]))
        or files["metadata.json"] != {"fps": FPS, "team_mapping": {str(k): v for k, v in mapping.items()}}
        or sorted(files["raw_coordinates.json"]) != sorted(str(k) for k in coords)
    ):
        fail("the JSON files do not parse back to the run's outputs")
    truth = true_teams(coords, people[0], team)
    pairs = {(mapping[pid], truth.get(pid)) for pid in mapping}
    if (
        len(mapping) < 2 * MATCH_PLAYERS
        or sorted(set(mapping.values())) != [0, 1]
        or len(pairs) != 2
        or len({t for _, t in pairs} - {None}) != 2
    ):
        fail(f"the team mapping {mapping} does not split the {2 * MATCH_PLAYERS} players by kit "
             f"(true teams of the ids: {truth})")

    stages = {k: round(timer.seconds[k] * 1e3, 3) for k in ("crops", "votes", "table", "merge", "format", "json")}
    perception = sum(v for k, v in timer.seconds.items() if k not in stages)
    print(f"process: {len(match)} frames of a match with oracle models to the four JSON files in {wall:.3f} s = "
          f"{len(match) / wall:.2f} fps (get_coordinates {perception * 1e3:.3f} ms, Processor and files "
          f"{sum(stages.values()):.3f} ms); Processor stage ms {json.dumps(stages)}; lk_flow launches {launches}")
    print(f"process: {len(card.crop_entries)} crops voted on the card == CPU votes; {len(mapping)} players in "
          f"{len(set(mapping.values()))} teams, split by kit, mapping == CPU; table {len(table)} rows x "
          f"{len(table.columns)} columns == CPU; {len(out['processed'])} formatted records")
    print("process: frames in memory; the cli phase decodes an .mp4 and writes annotated.mp4")


# ---------------------------------------------------------------------------
# the CLI from an .mp4
# ---------------------------------------------------------------------------


def json_mismatch(got, want, atol: float, path: str = "$") -> str | None:
    """The first difference between two parsed JSON trees: keys, lengths,
    strings, booleans and integers equal; floats within ``atol``."""
    if isinstance(want, float) or isinstance(got, float):
        ok = isinstance(got, (int, float)) and isinstance(want, (int, float)) and (
            abs(got - want) <= atol or (got != got and want != want))
        return None if ok else f"{path}: {got!r} against {want!r}"
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            return f"{path}: keys differ"
        return next((m for k in want if (m := json_mismatch(got[k], want[k], atol, f"{path}.{k}"))), None)
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return f"{path}: lengths differ"
        return next((m for i, (g, w) in enumerate(zip(got, want)) if (m := json_mismatch(g, w, atol, f"{path}[{i}]"))),
                    None)
    return None if type(got) is type(want) and got == want else f"{path}: {got!r} against {want!r}"


JSON_FILES = ("metadata.json", "processed_data.json", "raw_coordinates.json", "raw_data.json")
#: the Processor's and the writers' stages of a run's timer; "decode" and
#: "render" are the CLI's; the rest is get_coordinates
POST_STAGES = ("crops", "votes", "table", "merge", "format", "json")


def json_bytes(out_dir: str) -> dict:
    out = {}
    for name in JSON_FILES:
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def same_files(got: dict, want: dict) -> list[str]:
    """The names of the JSON files whose bytes differ."""
    return [k for k in JSON_FILES if got[k] != want[k]]


def stage_split(seconds: dict, n: int) -> dict:
    """A CLI run's timer as ms a frame: decode, get_coordinates, the
    Processor and the files, render plus encode."""
    post = sum(seconds.get(k, 0.0) for k in POST_STAGES)
    perception = sum(v for k, v in seconds.items() if k not in POST_STAGES + ("decode", "render"))
    return {
        "decode": seconds.get("decode", 0.0) * 1e3 / n,
        "get_coordinates": perception * 1e3 / n,
        "processor_and_files": post * 1e3 / n,
        "render_and_encode": seconds.get("render", 0.0) * 1e3 / n,
    }


def counting_source(counts: dict):
    """A :class:`VideoFrameSource` that counts in ``counts`` the times it
    opens the file to decode ("opens": the first read and each step back)
    and the frames it decodes ("decoded")."""
    from eagle_tpu_torch.io.video import VideoFrameSource

    class Counted(VideoFrameSource):
        def __getitem__(self, i):
            i = int(i) % len(self)
            hit = i == self._cache_idx
            opens = not hit and (self._cap is None or i * self.skip < self._next_raw)
            start = 0 if opens else self._next_raw
            frame = super().__getitem__(i)
            if not hit:
                counts["opens"] += opens
                counts["decoded"] += self._next_raw - start
            return frame

    return Counted


def cli_oracle(frames, pts, d: str):
    """(a) ``eagle_tpu_torch.main.main`` in this process on the match of
    :func:`make_match` written as an mp4, with oracle models keyed on the
    decoded frames: the four files bit-equal to ``main.run`` on the decoded
    frames on the card, and within the REF tolerances of the CPU run;
    annotated.mp4 decoded back; ``--segment_frames`` bit-equal to the whole
    run, with the lazy frame source's opens and decoded frames counted.
    Returns (the mp4's path, its decoded frames)."""
    from unittest import mock

    import torch

    import eagle_tpu_torch.io.video as video
    from eagle_tpu_torch import main as cli
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    match, people, _ = make_match(frames)
    mp4 = os.path.join(d, "match.mp4")
    video.write_video(match, mp4, FPS)
    decoded, _ = video.read_video_array(mp4, FPS)
    if decoded.shape != match.shape:
        fail(f"the match's mp4 decoded to {decoded.shape}, written {match.shape}")

    def oracle(device=None, **_weights):
        kp_fn, det_fn, _ = oracle_models(decoded, pts, people)
        return CoordinateModel(keypoint_fn=kp_fn, detector_fn=det_fn, device=device)

    def main_in(sub: str, *flags):
        os.makedirs(os.path.join(d, sub))
        with contextlib.chdir(os.path.join(d, sub)), mock.patch.object(cli, "CoordinateModel", oracle), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            out = cli.main(["--video_path", mp4, "--fps", str(FPS), *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, wall, os.path.join(d, sub, "output", "match")

    zero_loop_counts()
    whole, wall, whole_dir = main_in("whole")
    launches, loops = lc.get("lk_flow"), loop_counts()
    if sorted(os.listdir(whole_dir)) != sorted((*JSON_FILES, "annotated.mp4")):
        fail(f"the CLI wrote {sorted(os.listdir(whole_dir))}")
    if launches < len(decoded) - 1 or loops["auction"] < len(decoded) - 1:
        fail(f"the CLI run of {len(decoded)} frames: lk_flow launches {launches}, {loop_line(loops)}")
    files = json_bytes(whole_dir)
    rendered, _ = video.read_video_array(os.path.join(whole_dir, "annotated.mp4"), FPS)
    if rendered.shape != match.shape:
        fail(f"annotated.mp4 decoded to {rendered.shape}, want {match.shape}")

    mem_dir = os.path.join(d, "memory")
    cli.run(decoded, FPS, mem_dir, oracle("cuda"), annotated=False)
    bad = same_files(json_bytes(mem_dir), files)
    if bad:
        fail(f"the CLI's {bad} differ from main.run's on the decoded frames on the card")
    cpu_dir = os.path.join(d, "cpu")
    cli.run(decoded, FPS, cpu_dir, oracle("cpu"), annotated=False)
    cpu_files = json_bytes(cpu_dir)
    differ = same_files(cpu_files, files)
    for name in differ:
        bad = json_mismatch(json.loads(files[name]), json.loads(cpu_files[name]), 0.0 if name == "metadata.json" else 1.0)
        if bad:
            fail(f"the CLI's {name} on the card differs from the CPU run's: {bad}")

    counts = {"opens": 0, "decoded": 0}
    with mock.patch.object(video, "VideoFrameSource", counting_source(counts)):
        streamed, stream_wall, stream_dir = main_in("streamed", "--segment_frames", str(CLI_SEGMENT))
    bad = same_files(json_bytes(stream_dir), files)
    if bad:
        fail(f"--segment_frames {CLI_SEGMENT} wrote other {bad} than the whole run")
    if not os.path.exists(os.path.join(stream_dir, "annotated.mp4")):
        fail("the streamed CLI run wrote no annotated.mp4")

    n = len(decoded)
    split = {k: round(v, 4) for k, v in stage_split(whole["timer"].seconds, n).items()}
    print(f"cli (a): main.main --video_path on a {n}-frame {match.shape[2]}x{match.shape[1]} mp4 with oracle "
          f"models on the card: {wall:.3f} s = {n / wall:.2f} fps mp4 to the five files; ms a frame "
          f"{json.dumps(split)}; lk_flow launches {launches}; {loop_line(loops)}")
    print(f"cli (a): the four files == main.run on the decoded frames on the card (bytes); == the CPU run ("
          f"{f'{differ} within 1 px / 1 m, the rest' if differ else 'all four'} bit-equal); annotated.mp4 "
          f"decodes to {len(rendered)} frames of {rendered.shape[2]}x{rendered.shape[1]}; --segment_frames "
          f"{CLI_SEGMENT} == whole (bytes), {stream_wall:.3f} s; its VideoFrameSource opened the file "
          f"{counts['opens']} times and decoded {counts['decoded']} frames for the crops and the render of {n}")
    return mp4, decoded


def child_stage_table(stderr: str) -> dict:
    """The ``--profile`` stage table (the last JSON object) of a CLI run's
    standard error."""
    start = stderr.rindex("\n{\n") + 1
    return json.loads(stderr[start : stderr.index("\n}", start) + 2])


def child_imports(stderr: str) -> list[str]:
    """The modules a process imported, from ``python -X importtime``."""
    names = []
    for line in stderr.splitlines():
        fields = line[len("import time:"):].split("|") if line.startswith("import time:") else []
        if len(fields) == 3 and fields[0].strip().isdigit():  # not the header
            names.append(fields[2].strip())
    return names


def cli_full_width(model, mp4: str, decoded, d: str) -> None:
    """(b) The CLI as users start it, a process of its own, at full width:
    the slice model's weights saved as ``.msgpack`` files, then ``python -m
    eagle_tpu_torch.main --video_path --keypoint_weights --detector_weights
    --profile`` from an empty working directory with this checkout on
    ``PYTHONPATH`` (``-X importtime`` lists what it imports: no JAX), whole
    and with ``--segment_frames``; each run's four files bit-equal to
    ``main.run`` / ``main.run_streamed`` in this process with a model built
    from the same two files (under the process's default TF32 settings, as
    the child has them).  The kernels are built: the child must rebuild
    none."""
    import glob

    import torch

    from eagle_tpu_torch import main as cli
    from eagle_tpu_torch.io.video import VideoFrameSource, iter_video
    from eagle_tpu_torch.models.bridge import params_from_module
    from eagle_tpu_torch.models.checkpoint import save_params
    from eagle_tpu_torch.ops import optical_flow
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    kp_path, det_path = os.path.join(d, "keypoints.msgpack"), os.path.join(d, "detector.msgpack")
    save_params(params_from_module(model.keypoint_model), kp_path)
    save_params(params_from_module(model.detector_model), det_path)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    libs = sorted(glob.glob(os.path.join(optical_flow.BUILD_DIR, "*.so")))
    stamp = {f: os.stat(f).st_mtime_ns for f in libs}
    n = len(decoded)

    def child(sub: str, *flags):
        cwd = os.path.join(d, sub)
        os.makedirs(cwd)
        cmd = [sys.executable, "-X", "importtime", "-m", "eagle_tpu_torch.main", "--video_path", mp4, "--fps",
               str(FPS), "--keypoint_weights", kp_path, "--detector_weights", det_path, "--num_homography",
               str(CLI_HOMOGRAPHIES), "--profile", *flags]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"python -m eagle_tpu_torch.main {' '.join(flags)} exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                 f"{r.stderr[-6000:]}")
        out_dir = os.path.join(cwd, "output", "match")
        if sorted(os.listdir(out_dir)) != sorted((*JSON_FILES, "annotated.mp4")):
            fail(f"the CLI process wrote {sorted(os.listdir(out_dir))}")
        bad = sorted({m for m in child_imports(r.stderr) if m.split(".")[0] in ("jax", "jaxlib", "flax", "eagle_tpu")})
        if bad:
            fail(f"the CLI process imported {bad[:10]}")
        return wall, child_stage_table(r.stderr), json_bytes(out_dir), len(child_imports(r.stderr))

    wall, stages, files, n_imports = child("process_whole")
    s_wall, s_stages, s_files, _ = child("process_streamed", "--segment_frames", str(CLI_SEGMENT))
    rebuilt = [f for f in libs if os.stat(f).st_mtime_ns != stamp[f]]
    if not libs or rebuilt:
        fail(f"the CLI process rebuilt {rebuilt} of the built kernels {libs}")

    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = DEFAULT_TF32
    try:
        ref = CoordinateModel(keypoint_checkpoint=kp_path, detector_checkpoint=det_path, device="cuda")
        zero_loop_counts()
        whole = cli.run(decoded, FPS, os.path.join(d, "ref_whole"), ref, num_homography=CLI_HOMOGRAPHIES,
                        annotated=False)
        launches, loops = lc.get("lk_flow"), loop_counts()
        cli.run_streamed(iter_video(mp4, FPS, CLI_SEGMENT), FPS, os.path.join(d, "ref_streamed"), ref,
                         lambda k: VideoFrameSource(mp4, FPS, length=k), num_homography=CLI_HOMOGRAPHIES,
                         annotated=False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    for got, sub in ((files, "ref_whole"), (s_files, "ref_streamed")):
        bad = same_files(got, json_bytes(os.path.join(d, sub)))
        if bad:
            fail(f"the CLI process's {bad} differ from {sub} in this process with the same checkpoints")
    if launches < n - 1 or loops["auction"] < n - 1 or loops["nms"] != -(-n // 16):
        fail(f"the full-width run of {n} frames: lk_flow launches {launches}, {loop_line(loops)}")
    coords = whole["coordinates"]
    traffic = {
        "boundaries": sum(fr["Boundaries"][0] is not None for fr in coords.values()),
        "players": float(np.mean([len(fr["Coordinates"].get("Player", {})) for fr in coords.values()])),
        "ball": sum(bool(fr["Coordinates"].get("Ball")) for fr in coords.values()),
        "table": [len(whole["table"]), len(whole["table"].columns)],
        "records": len(whole["processed"]),
        "teams": len(set(whole["team_mapping"].values())),
    }
    total = sum(stages.values()) / 1e3
    split = {k: round(v, 4) for k, v in stage_split({k: v / 1e3 for k, v in stages.items()}, n).items()}
    print(f"cli (b): python -m eagle_tpu_torch.main --video_path ({n} frames of 1280x720, 24 fps) --keypoint_weights "
          f"--detector_weights (.msgpack, {os.path.getsize(kp_path)} + {os.path.getsize(det_path)} B) "
          f"--num_homography {CLI_HOMOGRAPHIES} --profile, a "
          f"process on the card: rc 0, five files, {n_imports} modules imported, none of JAX; wall {wall:.3f} s = "
          f"{n / wall:.2f} fps mp4 to files with the process start, {n / total:.2f} fps over its stages "
          f"({total:.3f} s, decode to annotated.mp4); ms a frame {json.dumps(split)}; no kernel rebuilt "
          f"({len(libs)} libraries)")
    print(f"cli (b): --profile stage ms {json.dumps(stages)}")
    print(f"cli (b): --segment_frames {CLI_SEGMENT}: wall {s_wall:.3f} s = {n / s_wall:.2f} fps; stage ms "
          f"{json.dumps(s_stages)}")
    print(f"cli (b): both processes' four files == main.run / main.run_streamed in this process with the same "
          f"checkpoints (bytes); in-process run: lk_flow launches {launches}, {loop_line(loops)}; frames with "
          f"boundaries, players a frame, frames with a ball, table, records, teams {json.dumps(traffic)}")


def phase_cli(frames, pts, model) -> None:
    """The CLI from an .mp4 on the card, where OpenCV imports: (a)
    :func:`cli_oracle`, (b) :func:`cli_full_width`."""
    import gc
    import importlib.util
    import tempfile

    if importlib.util.find_spec("cv2") is None:
        print("cli: no OpenCV on this machine: the CLI from an .mp4 not run")
        return
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp4, decoded = cli_oracle(frames, pts, d)
        cli_full_width(model, mp4, decoded, d)
    # the phase's runs leave reference cycles that hold device tensors (a
    # second full-width model among them): free them now, or the stream
    # phase's peak-memory readings count them
    gc.collect()
    print(f"cli: phase wall {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# streaming, serving and the checkpoint loaders
# ---------------------------------------------------------------------------


def stream_run(model, segments, **kw) -> tuple[dict, list[int]]:
    """``model.stream_coordinates`` over ``segments``: (its blocks joined,
    the block lengths)."""
    blocks = list(model.stream_coordinates(segments, FPS, **kw))
    return {k: v for b in blocks for k, v in b.items()}, [len(b) for b in blocks]


def stream_oracle(frames, pts) -> None:
    """(a) The oracle clip streamed in ragged segments (7 + 12 + 5 frames,
    blocks of 16 + 8): on the card it equals the card's one-shot exactly
    and the port's CPU stream by coords_mismatch, and stages no frame."""
    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

    clip = frames[:STREAM_REF_FRAMES]
    segments = [clip[:7], clip[7:19], clip[19:]]
    cfg = DEFAULT_CONFIG.replace(chunk_frames=16)

    def model(dev):
        kp_fn, det_fn, _ = oracle_models(clip, pts)
        return CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device=dev)

    one = model("cuda").get_coordinates(clip, FPS, num_keypoint_detection=6)
    lc.reset()
    card, blocks = stream_run(model("cuda"), segments, num_keypoint_detection=6)
    launches, staged = lc.get("lk_flow"), lc.get("lk_flow/staged")
    cpu, _ = stream_run(model("cpu"), segments, num_keypoint_detection=6)
    if blocks != [16, 8]:
        fail(f"the oracle stream ran blocks of {blocks}, expected [16, 8]")
    if card != one:
        fail("the oracle clip streamed on the card differs from its one-shot run on the card")
    bad = coords_mismatch(card, cpu)
    if bad:
        fail(f"the oracle clip streamed on the card differs from the CPU stream: {bad}")
    if staged or launches < len(clip) - 1:
        fail(f"the oracle stream staged {staged} frames and launched the flow kernel {launches} times")
    print(f"stream (a): oracle clip of {len(clip)} frames in blocks {blocks}: card stream == card one-shot, "
          f"== CPU stream; lk_flow launches {launches}, frames staged {staged}")


def stream_slice(model, frames, one_shot: dict) -> tuple[dict, dict]:
    """(b) The full-width slice streamed in segments 10 + 23 + 15 (blocks
    32 + 16) with the slice model's weights: equal to the slice phase's
    one-shot, no frame staged; fps, stage ms, launches, on-demand rounds.
    (c) Its peak device memory over 96 frames in blocks of 32 against 48
    frames, beside the 48-frame one-shot's.  Returns (the kernel line's
    stream fields, printed readings)."""
    import copy

    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import StageTimer

    streamer = copy.copy(model)  # the same modules, blocks cut at 16-frame multiples
    streamer.config = model.config.replace(chunk_frames=16)
    streamer.ondemand_rounds = 0
    stream_run(streamer, [frames[:16]], num_keypoint_detection=3)  # warm-up
    torch.cuda.synchronize()
    timer = StageTimer(streamer.device, sync=True)
    streamer.ondemand_rounds = 0
    zero_loop_counts()
    t0 = time.perf_counter()
    res, blocks = stream_run(streamer, [frames[:10], frames[10:33], frames[33:]], num_keypoint_detection=3,
                             timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, staged, rounds, loops = lc.get("lk_flow"), lc.get("lk_flow/staged"), streamer.ondemand_rounds, loop_counts()
    if blocks != [32, 16]:
        fail(f"the slice streamed in blocks of {blocks}, expected [32, 16]")
    if res != one_shot:
        bad = [i for i in one_shot if res.get(i) != one_shot[i]]
        fail(f"the streamed full-width slice differs from its one-shot run at frames {bad[:10]}")
    if staged or launches < len(frames) - 1:
        fail(f"the streamed slice staged {staged} frames and launched the flow kernel {launches} times")
    if loops["auction"] < len(frames) or not loops["nms"]:
        fail(f"the streamed slice: {loop_line(loops)}")
    model.ondemand_rounds = 0
    model.get_coordinates(frames, FPS, num_keypoint_detection=3)
    one_rounds = model.ondemand_rounds
    stages = {k: round(v * 1e3, 3) for k, v in timer.seconds.items()}
    print(f"stream (b): full-width slice, {len(frames)} frames in blocks {blocks} = {len(frames) / wall:.2f} fps "
          f"({wall:.3f} s); == the one-shot slice; stage ms {json.dumps(stages)}; lk_flow launches {launches}; "
          f"{loop_line(loops)}; frames staged {staged}; on-demand rounds {rounds} streamed, {one_rounds} one-shot")

    def peak(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    long, _ = make_frames(2 * len(frames))
    peaks = {
        "one_shot_48": peak(lambda: model.get_coordinates(frames, FPS, num_keypoint_detection=3)),
        "one_shot_96": peak(lambda: model.get_coordinates(long, FPS, num_keypoint_detection=3)),
        "stream_48": peak(lambda: stream_run(streamer, [frames[:32], frames[32:]], num_keypoint_detection=3)),
        "stream_96": peak(lambda: stream_run(streamer, [long[i : i + 32] for i in range(0, len(long), 32)],
                                             num_keypoint_detection=3)),
    }
    gib = {k: round(v / 2**30, 4) for k, v in peaks.items()}
    grow = peaks["one_shot_96"] - peaks["one_shot_48"]
    print(f"stream (c): peak device memory (GiB, max_memory_allocated) one-shot 48 frames {gib['one_shot_48']}, "
          f"one-shot 96 frames {gib['one_shot_96']} (+{grow} B for 48 frames, the 48 canvases are "
          f"{48 * CANVAS_BYTES} B), stream 48 frames {gib['stream_48']}, stream 96 frames {gib['stream_96']} "
          f"(blocks of 32)")
    if peaks["stream_96"] > 1.1 * peaks["stream_48"]:
        fail("the 96-frame stream's peak device memory is more than 10% over the 48-frame stream's")
    if grow > 1.05 * 48 * CANVAS_BYTES:
        fail("the one-shot peak grew from 48 to 96 frames by more than the 48 canvases plus 5%")
    return {"stream_launches": launches, "stream_staged": staged, "stream_loops": loops}, {
        "fps": len(frames) / wall, "peaks": gib}


def stream_serve(frames, pts) -> None:
    """(d) ``serve_clips(overlap=True)`` over three 16-frame clips of the
    process phase's match with oracle models on the card: each result
    equals a sequential ``get_coordinates`` + ``Processor`` of its clip on
    the card; clips a second of both orders."""
    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from eagle_tpu_torch.pipeline.processor import Processor
    from eagle_tpu_torch.pipeline.serve import serve_clips

    match, people, _ = make_match(frames)
    clips = [match[i : i + SERVE_CLIP] for i in range(0, len(match), SERVE_CLIP)]

    def model():
        kp_fn, det_fn, _ = oracle_models(match, pts, people)
        return CoordinateModel(keypoint_fn=kp_fn, detector_fn=det_fn, device="cuda")

    seq_model = model()
    t0 = time.perf_counter()
    want = []
    for clip in clips:
        coords = seq_model.get_coordinates(clip, FPS, num_keypoint_detection=3)
        proc = Processor(coords, clip, FPS, device="cuda")
        table, mapping = proc.process_data()
        want.append((coords, table, mapping, proc.format_data(table)))
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = list(serve_clips(model(), clips, FPS, num_keypoint_detection=3, overlap=True))
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    if len(got) != len(clips):
        fail(f"serve_clips yielded {len(got)} results for {len(clips)} clips")
    for k, (res, (coords, table, mapping, records)) in enumerate(zip(got, want)):
        if res.coordinates != coords or not tables_equal(res.table, table) or res.team_mapping != mapping or (
            res.formatted != records
        ):
            fail(f"served clip {k} differs from its sequential run on the card")
    print(f"stream (d): serve_clips(overlap=True) over {len(clips)} clips of {SERVE_CLIP} frames == sequential on "
          f"the card; {len(clips) / seq_wall:.3f} clips/s sequential, {len(clips) / serve_wall:.3f} clips/s served")


def stream_loaders(model, frames) -> None:
    """(e) The slice's full-width HRNet-W48 and YOLOv8-l written as the
    reference's ``.pth`` and an ultralytics ``.pt`` (tests/torch_parity.py,
    torch and numpy only), loaded back by ``CoordinateModel(*_checkpoint=)``
    on the card: state dicts bit-equal, ``get_coordinates`` on 16 frames
    equal to the slice model's."""
    import tempfile

    import torch

    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from tests.torch_parity import hrnet_reference_state_dict, yolov8_ultralytics_state_dict

    with tempfile.TemporaryDirectory() as d:
        kp_path, det_path = os.path.join(d, "keypoints_main.pth"), os.path.join(d, "detector.pt")
        torch.save(hrnet_reference_state_dict(model.keypoint_model), kp_path)
        torch.save(yolov8_ultralytics_state_dict(model.detector_model), det_path)
        sizes = os.path.getsize(kp_path), os.path.getsize(det_path)
        loaded = CoordinateModel(config=model.config, keypoint_checkpoint=kp_path, detector_checkpoint=det_path,
                                 device="cuda")
    for name in ("keypoint_model", "detector_model"):
        got, want = getattr(loaded, name).state_dict(), getattr(model, name).state_dict()
        if list(got) != list(want) or not all(torch.equal(got[k], want[k]) for k in want):
            fail(f"the {name} loaded from its checkpoint differs from the slice model's weights")
    clip = frames[:16]
    if loaded.get_coordinates(clip, FPS, num_keypoint_detection=3) != model.get_coordinates(
        clip, FPS, num_keypoint_detection=3
    ):
        fail("get_coordinates with the loaded checkpoints differs from the slice model's")
    print(f"stream (e): HRNet-W48 .pth ({sizes[0]} B) and YOLOv8-{loaded.detector_model.variant} ultralytics .pt "
          f"({sizes[1]} B) load back bit-equal on the card; get_coordinates on {len(clip)} frames == the slice model's")


def phase_stream(frames, pts, model, one_shot: dict) -> dict:
    """Streaming, serving and the loaders on the card: (a) the oracle
    stream, (b) the full-width slice streamed, (c) its peak memory,
    (d) serve_clips, (e) the checkpoints.  Returns the kernel line's
    stream fields."""
    stream_oracle(frames, pts)
    fields, _ = stream_slice(model, frames, one_shot)
    stream_serve(frames, pts)
    stream_loaders(model, frames)
    return fields


# ---------------------------------------------------------------------------
# multi-clip runs and the prescale paths
# ---------------------------------------------------------------------------


def clip_pairs(frames, pts, k: int):
    """MC_PAIRS pairs of consecutive raw 1280x720 frames (2c, 2c + 1), in
    one buffer of ``upload_frames`` viewed as (C, 2, H, W, 3) as the
    clip-batched path holds its clips, and each pair's K points: at K = 57
    the line intersections in view of frame 2c and random points, at K =
    240 the grid corners of frame 2c.  Returns (prev, curr, pts (C, K, 2),
    valid (C, K))."""
    import torch

    from eagle_tpu_torch.ops.corners import grid_corners
    from eagle_tpu_torch.ops.optical_flow import upload_frames

    dev = torch.device("cuda")
    buf = upload_frames(frames[: 2 * MC_PAIRS], dev).unflatten(0, (MC_PAIRS, 2))
    prev, curr = buf[:, 0], buf[:, 1]
    if k == 240:
        grids = [grid_corners(prev[c]) for c in range(MC_PAIRS)]
        return prev, curr, torch.stack([g[0] for g in grids]), torch.stack([g[1] for g in grids])
    rng = np.random.default_rng(SEED + 2)
    h, w = FRAME_HW
    rows = []
    for c in range(MC_PAIRS):
        inter = pts[2 * c][(pts[2 * c][:, 0] > 0) & (pts[2 * c][:, 0] < w - 1)]
        rows.append(np.concatenate([inter, rng.uniform([0, 0], [w - 1, h - 1], (k - len(inter), 2))]))
    p = torch.from_numpy(np.stack(rows).astype(np.float32)).to(dev)
    valid = torch.ones(MC_PAIRS, k, dtype=torch.bool, device=dev)
    valid[1, 3] = False
    return prev, curr, p, valid


def flow_kernel_ms(call, reps: int = 20) -> float:
    """Device time of the flow kernels one ``call()`` launches, from the
    profiler's trace over ``reps`` calls (:func:`traced_flow`): the mean
    traced launch times the launches a call.  Fails if a call ran any other
    device operation.  Where no session traced a flow kernel, the call's
    time by CUDA events, and says so."""
    import torch

    call()
    torch.cuda.synchronize()
    tr = traced_flow(call, reps)
    flow = tr["flow"]
    if len(tr["ops"]) != len(flow) or len(flow) > tr["launched"]:
        fail(f"flow calls ran {len(tr['ops']) - len(flow)} device operations other than the flow kernel")
    if not flow:
        print(f"multi-clip (a): no flow kernel traced in {tr['sessions']} profiler sessions; timed by CUDA events")
        return cuda_ms(call, reps=reps)
    return sum(flow) / len(flow) * tr["launched"] / reps / 1e3


def multiclip_kernel(frames, pts) -> dict:
    """(a) The clip-batched launch: MC_PAIRS frame pairs in one launch at
    K = 57 and K = 240, against the plain version clip by clip (status
    bit-equal, positions within FLOW_ATOL) and against MC_PAIRS single
    launches (bit-equal); the device time of a batched launch, of the
    single launches summed, the plain version's, and the bound (the sum of
    each pair's :func:`lk_flow_work`).  Returns the lk_flow_clips entry's
    fields."""
    import torch

    from eagle_tpu_torch.ops import optical_flow as of

    saved = lc.snapshot()
    out = {}
    for k in (57, 240):
        prev, curr, p, valid = clip_pairs(frames, pts, k)
        before = lc.get(f"lk_flow/C={MC_PAIRS},K={k}")
        g, s = of.lk_flow_clips(prev, curr, p, valid)
        torch.cuda.synchronize()
        if lc.get(f"lk_flow/C={MC_PAIRS},K={k}") != before + 1:
            fail(f"lk_flow_clips on CUDA tensors did not launch the kernel once at C = {MC_PAIRS}, K = {k}")
        err, nbytes, ops = 0.0, 0, 0
        h, w = FRAME_HW
        side = of.roi_side(h, w)
        for c in range(MC_PAIRS):
            g1, s1 = of.lk_flow(prev[c], curr[c], p[c], valid[c])
            if not (torch.equal(g[c], g1) and torch.equal(s[c], s1)):
                fail(f"the batched launch differs from the single launch on pair {c} at K = {k}")
            gp, sp = of.lk_flow_plain(prev[c], curr[c], p[c], valid[c])
            sp = sp.cpu().numpy()
            if not np.array_equal(s[c].cpu().numpy(), sp):
                fail(f"the batched launch's status differs from the plain version on pair {c} at K = {k}")
            err = max(err, float(np.abs(g[c].cpu().numpy() - gp.cpu().numpy())[sp].max()) if sp.any() else 0.0)
            origin = of.roi_origins(p[c], h, w, side, 2)
            record: list = []
            of.engine_plain(of.roi_pyramids(prev[c], curr[c], origin, side, 2), origin, p[c], side, 2, record=record)
            b, o, _ = lk_flow_work(origin, (h, w), side, record)
            nbytes, ops = nbytes + b, ops + o
        if not err <= FLOW_ATOL:
            fail(f"the batched launch's positions differ from the plain version by {err} > {FLOW_ATOL} at K = {k}")
        ms = flow_kernel_ms(lambda: of.lk_flow_clips(prev, curr, p, valid))
        singles = flow_kernel_ms(lambda: [of.lk_flow(prev[c], curr[c], p[c], valid[c]) for c in range(MC_PAIRS)])
        plain = cuda_ms(lambda: [of.lk_flow_plain(prev[c], curr[c], p[c], valid[c]) for c in range(MC_PAIRS)], reps=3)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_INSTR_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"multi-clip (a) lk_flow_clips: C={MC_PAIRS} K={k} one launch == {MC_PAIRS} single launches (bit-equal), "
              f"max |kernel - plain| = {err:.3e} px; {ms:.4f} ms device time a launch, {MC_PAIRS} single launches "
              f"{singles:.4f} ms, plain {plain:.3f} ms; needs {nbytes} B = {t_bytes * 1e3:.4f} us and {ops} f32 "
              f"instructions = {t_ops * 1e3:.4f} us -> bound {bound * 1e3:.4f} us by {by}, launch {ms / bound:.1f}x "
              f"over it")
        suffix = "" if k == 57 else "_k240"
        out.update({f"max_abs_err{suffix}": err, f"ms{suffix}": ms, f"plain_ms{suffix}": plain,
                    f"bound_ms{suffix}": bound, f"bound_by{suffix}": by, f"singles_ms{suffix}": singles})
    lc.restore(saved)  # comparison launches are not main-path launches
    return out


def multiclip_flattened(model, frames96) -> None:
    """(b) ``MultiClipRunner`` on the flattened path at full width with the
    slice's weights: make_frames(96) split as MC_SPLITS; each clip equals
    its own ``get_coordinates`` on the card exactly; the flow kernel ran
    (counters zeroed just before, read just after); fps against the
    sequential runs."""
    import torch

    from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner

    singles: dict = {}  # (first frame, length) -> (the clip's own result, its wall seconds)

    def single(a: int, n: int):
        if (a, n) not in singles:
            t0 = time.perf_counter()
            res = model.get_coordinates(frames96[a : a + n], FPS, num_keypoint_detection=3)
            torch.cuda.synchronize()
            singles[a, n] = res, time.perf_counter() - t0
        return singles[a, n]

    for split in MC_SPLITS:
        spans = [(0, split[0]), (split[0], split[1])]
        torch.cuda.synchronize()
        zero_loop_counts()
        t0 = time.perf_counter()
        res = MultiClipRunner(model).run([frames96[a : a + n] for a, n in spans], FPS, num_keypoint_detection=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, loops = lc.get("lk_flow"), loop_counts()
        seq = 0.0
        for ci, (a, n) in enumerate(spans):
            want, secs = single(a, n)
            seq += secs
            if res[ci] != want:
                bad = [i for i in want if res[ci].get(i) != want[i]]
                fail(f"flattened multi-clip run {split}: clip {ci} differs from its single-clip run at frames {bad[:10]}")
        n = sum(split)
        if launches < n - len(split):
            fail(f"the flattened multi-clip run launched the flow kernel {launches} times for {n} frames")
        if loops["auction"] < n or not loops["nms"]:
            fail(f"the flattened multi-clip run over {n} frames: {loop_line(loops)}")
        print(f"multi-clip (b) flattened, clips {split} at full width: each clip == its single-clip run on the card; "
              f"{n} frames in {wall:.3f} s = {n / wall:.2f} fps, sequential {n / seq:.2f} fps; lk_flow launches "
              f"{launches}; {loop_line(loops)}")


def multiclip_batched(frames96, pts96) -> dict:
    """(c) ``MultiClipRunner`` on the clip-batched path: oracle models on
    raw 1280x720 frames, clips MC_LENS of make_frames(96), the default
    tracker and the features GMC; each clip equals its single-clip run on
    the card, the card run equals the port's CPU run (REF_* tolerances);
    the flow kernel launched once a step for all clips at K = 57 (and at
    K = 240 with the features GMC), counters zeroed just before and read
    just after; fps against the sequential runs.  Returns the
    lk_flow_clips entry's launch fields."""
    import dataclasses

    import torch

    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner

    starts = np.cumsum([0] + MC_LENS[:-1])
    used = frames96[: sum(MC_LENS)]
    clips = [used[a : a + n] for a, n in zip(starts, MC_LENS)]
    C, L = len(clips), max(MC_LENS)
    fields = {"launches": 0}
    for gmc in ("affine", "features"):
        cfg = DEFAULT_CONFIG.replace(tracker=dataclasses.replace(DEFAULT_CONFIG.tracker, gmc=gmc))

        def model(dev):
            kp_fn, det_fn, _ = oracle_models(used, pts96[: len(used)])
            return CoordinateModel(config=cfg, keypoint_fn=kp_fn, detector_fn=det_fn, device=dev)

        card_model = model("cuda")
        torch.cuda.synchronize()
        zero_loop_counts()
        t0 = time.perf_counter()
        card = MultiClipRunner(card_model).run(clips, FPS, num_keypoint_detection=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_ck = {tuple(int(x[2:]) for x in d.split(",")): v for d, v in lc.details("lk_flow").items() if d.startswith("C=")}
        rounds, loops = card_model.ondemand_rounds, loop_counts()
        if loops["auction"] < L or loops["nms"]:
            fail(f"clip-batched run ({gmc} GMC, oracle detections): {loop_line(loops)}; expected auction launches "
                 f"every step and no nms launch")
        t0 = time.perf_counter()
        for ci, clip in enumerate(clips):
            if model("cuda").get_coordinates(clip, FPS, num_keypoint_detection=6) != card[ci]:
                fail(f"clip-batched multi-clip run ({gmc} GMC): clip {ci} differs from its single-clip run on the card")
        torch.cuda.synchronize()
        seq = time.perf_counter() - t0
        cpu = MultiClipRunner(model("cpu")).run(clips, FPS, num_keypoint_detection=6)
        for ci in range(C):
            bad = coords_mismatch(card[ci], cpu[ci])
            if bad:
                fail(f"clip-batched multi-clip run ({gmc} GMC): clip {ci} on the card differs from the CPU run: {bad}")
        n57, n240 = by_ck.get((C, 57), 0), by_ck.get((C, 240), 0)
        if n57 < L or (gmc == "features" and n240 != n57) or (gmc != "features" and n240):
            fail(f"clip-batched run ({gmc} GMC): batched flow launches {by_ck}, expected one a step at K = 57 "
                 f"(and at K = 240 with the features GMC) for {L} steps")
        n = sum(MC_LENS)
        print(f"multi-clip (c) clip-batched, {gmc} GMC, oracle models, clips {MC_LENS}: each clip == its single-clip "
              f"run on the card, card == CPU; {n} frames in {wall:.3f} s = {n / wall:.2f} fps, sequential "
              f"{n / seq:.2f} fps; batched launches {json.dumps({f'C={c},K={k}': v for (c, k), v in by_ck.items()})}, "
              f"on-demand rounds {rounds}; {loop_line(loops)}")
        fields["launches"] += n57 + n240
        fields[f"launches_{gmc}"] = {f"C={c},K={k}": v for (c, k), v in by_ck.items()}
    return fields


def phase_multiclip(frames, pts, model) -> dict:
    """Multi-clip runs on the card: (a) the clip-batched launch, (b) the
    flattened path, (c) the clip-batched path.  Returns the lk_flow_clips
    entry."""
    t0 = time.perf_counter()
    entry = {
        "name": "lk_flow_clips",
        "route": "cuda",
        "source": "eagle_tpu_torch/csrc/lk_flow.cu",
        "replaces": "eagle_tpu/ops/pallas_flow2.py:272",
        "launches": None,
        "library_ms": None,
        "clips": MC_PAIRS,
    }
    entry.update(multiclip_kernel(frames, pts))
    frames96, pts96 = make_frames(96)
    multiclip_flattened(model, frames96)
    entry.update(multiclip_batched(frames96, pts96))
    print(f"multi-clip: phase wall {time.perf_counter() - t0:.1f} s")
    return entry


def md_scan_inputs(frames, pts, dev):
    """Time-stacked ``FrameInputs`` of ``frames`` on ``dev`` for the
    time-sharded scan: the oracle keypoints on every MD_KP_EVERY-th frame, a
    homography every MD_H_EVERY-th, the oracle players as detections, ``t``
    global; no previous frames (the caller's halo or shift)."""
    import torch

    from eagle_tpu_torch.ops.optical_flow import upload_frames
    from eagle_tpu_torch.pipeline import temporal

    n = len(frames)
    kp_fn, det_fn, _ = oracle_models(frames, pts)
    kp, valid = kp_fn(frames)
    kp_frame = np.arange(n) % MD_KP_EVERY == 0
    boxes, conf, cls, dvalid = det_fn(frames)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return temporal.FrameInputs(
        frame_bgr=upload_frames(frames, dev), prev_frame_bgr=None, model_kp=on(kp),
        model_kp_valid=on(valid & kp_frame[:, None]), is_kp_frame=kp_frame, is_h_frame=np.arange(n) % MD_H_EVERY == 0,
        det_boxes=on(boxes), det_conf=on(conf), det_cls=on(cls.astype(np.int64)), det_valid=on(dvalid), t=np.arange(n),
    )


def md_sequential(xs, cfg):
    """``scan_chunk`` of the whole clip: (kp_xy, kp_valid, H, H_ok) tensors."""
    from eagle_tpu_torch.pipeline import temporal

    prev = xs.frame_bgr[np.maximum(np.arange(len(xs.t)) - 1, 0)]
    _, out = temporal.scan_chunk(temporal.init_carry(cfg, xs.frame_bgr.device), xs._replace(prev_frame_bgr=prev),
                                 cfg, SEED)
    return out.kp_xy, out.kp_valid, out.H, out.H_ok


def multidevice_nccl(model, frames96, frames, pts, work: str) -> dict:
    """(a) One NCCL rank: the runner over ``make_mesh()`` against the runner
    without a process group, and the time-sharded scan over the rank
    against ``scan_chunk`` (at size 1 no message is sent and the rank runs
    one cold pass: an identity that checks the plumbing, not the ring).  Returns the flow launches of the runner's run
    and the scan's outputs (numpy), which (b) is held to."""
    import torch
    import torch.distributed as dist

    from eagle_tpu_torch.parallel.mesh import gather_batch, make_mesh
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev, timesharded_keypoint_scan
    from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner

    starts = np.cumsum([0] + MD_CLIPS_A[:-1])
    clips = [frames96[a : a + n] for a, n in zip(starts, MD_CLIPS_A)]
    want = MultiClipRunner(model).run(clips, FPS, num_keypoint_detection=3)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl_store", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        if (mesh.size, mesh.backend, mesh.device.type) != (1, "nccl", "cuda"):
            fail(f"make_mesh under a one-rank NCCL group gave {mesh}")
        torch.cuda.synchronize()
        zero_loop_counts()
        t0 = time.perf_counter()
        got = MultiClipRunner(model, mesh=mesh).run(clips, FPS, num_keypoint_detection=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, loops = lc.get("lk_flow"), loop_counts()
        if not (loops["auction"] and loops["nms"]):
            fail(f"the runner over a one-rank NCCL mesh: {loop_line(loops)}")
        for ci in range(len(clips)):
            if got[ci] != want[ci]:
                bad = [i for i in want[ci] if got[ci].get(i) != want[ci][i]]
                fail(f"multi-device (a): clip {ci} over the one NCCL rank differs from the runner without a process "
                     f"group at frames {bad[:10]}")
        if launches < sum(MD_CLIPS_A) - len(MD_CLIPS_A):
            fail(f"multi-device (a): the flow kernel launched {launches} times for {sum(MD_CLIPS_A)} frames")
        xs = md_scan_inputs(frames, pts, mesh.device)
        seq = md_sequential(xs, model.config)
        local = xs._replace(prev_frame_bgr=halo_exchange_prev(xs.frame_bgr, mesh))
        ts = [gather_batch(a, mesh) for a in timesharded_keypoint_scan(mesh, model.config, SEED, local)]
        for name, a, b in zip(("kp_xy", "kp_valid", "H", "H_ok"), ts, seq):
            if not torch.equal(a, b):
                fail(f"multi-device (a): the time-sharded scan over one rank differs from scan_chunk in {name}")
        if not bool(seq[3].any()):
            fail("multi-device (a): scan_chunk of the slice's frames found no homography: RANSAC was not exercised")
    finally:
        dist.destroy_process_group()
    n = sum(MD_CLIPS_A)
    print(f"multi-device (a) one NCCL rank: MultiClipRunner over make_mesh(), clips {MD_CLIPS_A} at full width, == the "
          f"runner without a process group; {n} frames in {wall:.3f} s = {n / wall:.2f} fps, lk_flow launches "
          f"{launches}, {loop_line(loops)}; the time-sharded scan of {len(frames)} frames over the rank == scan_chunk "
          f"({int(seq[1].sum())} valid keypoints, {int(seq[3].sum())} frames with a homography; the one-rank "
          f"identity: no message sent, one cold pass)")
    return {"launches": launches, "seq": [a.cpu().numpy() for a in seq]}


def md_rank(rank: int, size: int, work: str) -> None:
    """(b) One gloo rank on the card (spawned): the slice's weights from
    ``work/weights.pt``; ``MultiClipRunner`` over the ranks' mesh on clips
    MD_CLIPS_B of make_frames(96); the halo exchange of the slice's frames;
    the time-sharded scan.  Writes ``work/rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev, timesharded_keypoint_scan
    from eagle_tpu_torch.pipeline import temporal
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner

    global DEFAULT_TF32
    DEFAULT_TF32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{work}/gloo_store", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=600))
    with lc.counting():  # a spawned rank reads its captured steps' launch counts
        try:
            mesh = make_mesh()
            model = CoordinateModel(config=DEFAULT_CONFIG, seed=SEED, device=mesh.device)
            weights = torch.load(f"{work}/weights.pt", map_location=mesh.device)
            model.keypoint_model.load_state_dict(weights["keypoint"])
            model.detector_model.load_state_dict(weights["detector"])
            frames96, _ = make_frames(96)
            starts = np.cumsum([0] + MD_CLIPS_B[:-1])
            clips = [frames96[a : a + n] for a, n in zip(starts, MD_CLIPS_B)]
            model.get_coordinates(frames96[:16], FPS, num_keypoint_detection=3)  # warm-up, as the slice's
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            lc.reset()
            t0 = time.perf_counter()
            res = MultiClipRunner(model, mesh=mesh).run(clips, FPS, num_keypoint_detection=3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = lc.get("lk_flow")
            frames, pts = make_frames(N_FRAMES)
            xs = md_scan_inputs(frames, pts, mesh.device)
            halo = gather_batch(halo_exchange_prev(shard_batch(xs.frame_bgr, mesh), mesh), mesh)
            local = temporal.FrameInputs(*(None if v is None else shard_batch(v, mesh) for v in xs))
            local = local._replace(prev_frame_bgr=halo_exchange_prev(local.frame_bgr, mesh))
            lc.reset()
            ts = [gather_batch(a, mesh).cpu() for a in timesharded_keypoint_scan(mesh, model.config, SEED, local)]
            torch.save({"res": res, "wall": wall, "launches": launches, "scan_launches": lc.get("lk_flow"),
                        "halo": bool(torch.equal(halo[1:], xs.frame_bgr[:-1]) and torch.equal(halo[0], xs.frame_bgr[0])),
                        "ts": ts, "peak": torch.cuda.max_memory_allocated(), "device": str(mesh.device)},
                       f"{work}/rank{rank}.pt")
        finally:
            dist.destroy_process_group()


def multidevice_gloo(model, frames96, seq, work: str) -> list[int]:
    """(b) Two gloo ranks spawned on the card.  Returns each rank's flow
    launches in its runner's run."""
    import torch

    starts = np.cumsum([0] + MD_CLIPS_B[:-1])
    singles = [model.get_coordinates(frames96[a : a + n], FPS, num_keypoint_detection=3)
               for a, n in zip(starts, MD_CLIPS_B)]
    torch.save({"keypoint": model.keypoint_model.state_dict(), "detector": model.detector_model.state_dict()},
               f"{work}/weights.pt")
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(md_rank, args=(MD_RANKS, work), nprocs=MD_RANKS, join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False) for r in range(MD_RANKS)]
    for r, got in enumerate(ranks):
        for ci, want in enumerate(singles):
            if got["res"][ci] != want:
                bad = [i for i in want if got["res"][ci].get(i) != want[i]]
                fail(f"multi-device (b): rank {r}'s clip {ci} differs from the clip's own run at frames {bad[:10]}")
        if not got["halo"]:
            fail(f"multi-device (b): rank {r}'s halo exchange is not the frames shifted by one")
        for name, a, b in zip(("kp_xy", "kp_valid", "H", "H_ok"), got["ts"], seq):
            if not np.array_equal(a.numpy(), b):
                fail(f"multi-device (b): rank {r}'s time-sharded scan differs from scan_chunk in {name}")
        if got["launches"] <= 0 or got["scan_launches"] <= 0:
            fail(f"multi-device (b): rank {r} launched the flow kernel {got['launches']} + {got['scan_launches']} times")
    n = sum(MD_CLIPS_B)
    per_rank = "; ".join(
        f"rank {r} on {g['device']}: its clip in {g['wall']:.3f} s ({MD_CLIPS_B[r] / g['wall']:.2f} fps), lk_flow "
        f"launches {g['launches']} (runner) + {g['scan_launches']} (scan), peak device memory "
        f"{g['peak'] / 2**30:.4f} GiB" for r, g in enumerate(ranks))
    print(f"multi-device (b) {MD_RANKS} gloo ranks sharing one card [{card_line()}]: clips {MD_CLIPS_B}, each == its "
          f"own run; the halo == the frames shifted; the time-sharded scan over {MD_RANKS} x {MD_SEGMENT} frames == "
          f"scan_chunk; {per_rank}; phase wall {wall:.3f} s from spawn to join ({n} frames over the ranks: "
          f"{n / max(g['wall'] for g in ranks):.2f} fps of two processes contending for one card, not a scaling "
          f"figure)")
    return [g["launches"] for g in ranks]


def phase_multidevice(model, frames, pts) -> dict:
    """(a) one NCCL rank, (b) two gloo ranks on the card.  Returns the flow
    entry's multi-device launch fields."""
    import tempfile

    t0 = time.perf_counter()
    frames96, _ = make_frames(96)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        a = multidevice_nccl(model, frames96, frames, pts, work)
        b = multidevice_gloo(model, frames96, a["seq"], work)
    print(f"multi-device: phase wall {time.perf_counter() - t0:.1f} s")
    return {"launches_multidevice": {"nccl_rank": a["launches"], "gloo_ranks": b}}


def phase_prescale(model, frames) -> None:
    """The prescale paths: the slice model on 640x360 and 854x480 frames
    (the 4:2:0 letterbox outside the fused kernel's envelope, upscaling),
    their canvases equal to the CPU host path's bytes; ``prescale="device"``
    on the slice's 1280x720 frames within PRESCALE_LSB of the host canvas,
    and run to its end; prescale ms a frame, host path against device path
    (host prescale, upload and decode or device letterbox, synchronised)."""
    import copy

    import torch

    from eagle_tpu_torch.ops.preprocess import host_letterbox_i420, i420_to_bgr

    t0 = time.perf_counter()
    for hw in ((360, 640), (480, 854)):
        f, _ = make_frames(16, hw=hw)
        geom = model._geometry(hw)
        plan = model._prescale_plan(geom, hw)
        card = model.upload(f, geom).cpu()
        cpu = i420_to_bgr(torch.from_numpy(host_letterbox_i420(f, geom)))
        if plan != ("canvas_planes", True) or not torch.equal(card, cpu):
            fail(f"the {hw[1]}x{hw[0]} canvas on the card ({plan}) differs from the CPU host path's bytes")
        res = model.get_coordinates(f, FPS, num_keypoint_detection=3)
        if sorted(res) != list(range(len(f))) or any(
            set(fr) != {"Coordinates", "Time", "Keypoints", "Boundaries"} for fr in res.values()
        ):
            fail(f"get_coordinates on {hw[1]}x{hw[0]} frames did not return one entry per frame with the four keys")
        print(f"prescale: {hw[1]}x{hw[0]} -> image {geom.img_h}x{geom.img_w} in canvas {geom.canvas_h}x{geom.canvas_w} "
              f"({plan[0]}, outside the fused envelope): card canvas == CPU host path bytes; the slice model ran "
              f"{len(res)} frames")
    device = copy.copy(model)
    device.config = model.config.replace(prescale="device")
    geom = model._geometry(FRAME_HW)
    if device._prescale_plan(geom, FRAME_HW) != ("raw_planes", True):
        fail("prescale='device' on 1280x720 does not take the device letterbox")
    host_canvas = model.upload(frames, geom)
    dev_canvas = device.upload(frames, geom)
    diff = int((host_canvas.int() - dev_canvas.int()).abs().max())
    equal = float((host_canvas == dev_canvas).float().mean())
    if diff > PRESCALE_LSB:
        fail(f"the device prescale differs from the host canvas by {diff} > {PRESCALE_LSB} LSB")
    res = device.get_coordinates(frames[:16], FPS, num_keypoint_detection=3)
    if sorted(res) != list(range(16)):
        fail("get_coordinates with prescale='device' did not return one entry per frame")

    def per_frame_ms(m):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.upload(frames, geom)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / len(frames)

    ms = {"host": [], "device": []}
    for _ in range(3):
        ms["host"].append(per_frame_ms(model))
        ms["device"].append(per_frame_ms(device))
    print(f"prescale: device letterbox (prescale='device') within {diff} LSB of the host canvas ({equal:.4%} of bytes "
          f"equal; bound {PRESCALE_LSB}), ran {len(res)} frames; prescale ms a frame over {len(frames)} 1280x720 "
          f"frames, host path {[round(v, 3) for v in ms['host']]}, device path {[round(v, 3) for v in ms['device']]}; "
          f"phase wall {time.perf_counter() - t0:.1f} s")


def eval_oracle_runners(truth):
    """Runners that return a scene's truth (``evaluate.synthetic_truth``)
    as the eval CLI masks it: the landmarks in the frame and on the pitch
    plane, every player's box with class 0, confidence 1 and valid
    (float64, so that matched pairs are exact)."""
    gt_kp, gt_valid, gt_boxes, _ = truth

    def keypoints(frames):
        b = len(frames)
        return np.concatenate([gt_kp[:b], np.ones((b, 57, 1))], -1), gt_valid[:b]

    def detections(frames):
        b, p = len(frames), gt_boxes.shape[1]
        return gt_boxes[:b], np.ones((b, p)), np.zeros((b, p), np.int32), np.ones((b, p), bool)

    return keypoints, detections


def results_mismatch(got: dict, want: dict) -> str | None:
    """The first metric of two ``results.json`` dicts that differs by more
    than 1e-12 (``time`` aside), or a key tree that differs."""

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}{key}/").items()}
        return {prefix[:-1]: tree}

    g, w = flat(got), flat(want)
    if g.keys() != w.keys():
        return f"keys {sorted(g.keys() ^ w.keys())}"
    for k in w:
        if not k.endswith("/time") and abs(g[k] - w[k]) > 1e-12:
            return f"{k}: {g[k]} against {w[k]}"
    return None


def eval_video(scene, truth) -> None:
    """The eval CLI's ``--video`` / ``--labels`` mode on the card, where
    OpenCV imports: the scene written as an mp4 by ``io.write_video`` (25
    fps, every frame kept), labels from its truth, ``evaluate.main`` with
    the default model built on the card; the decoded frames' shape and
    their mean difference from the drawn ones (a lossy codec), the
    results' keys, one NMS launch."""
    import tempfile

    from eagle_tpu_torch import evaluate
    from eagle_tpu_torch.io.video import read_video_array, write_video

    gt_kp, gt_valid, gt_boxes, _ = truth
    labels = {
        str(t): {
            "keypoints": [[float(x), float(y), int(i)] for i, (x, y) in enumerate(gt_kp[t]) if gt_valid[t, i]],
            "boxes": [[*map(float, b), 0] for b in gt_boxes[t]],
        }
        for t in range(len(scene.frames))
    }
    with tempfile.TemporaryDirectory() as d:
        video, labels_path, out = (os.path.join(d, f) for f in ("scene.mp4", "labels.json", "results.json"))
        write_video(scene.frames, video, 25)
        with open(labels_path, "w") as f:
            json.dump(labels, f)
        decoded, _ = read_video_array(video, fps=25)
        lc.reset()
        with contextlib.redirect_stdout(io.StringIO()):
            res = evaluate.main(["--video", video, "--labels", labels_path, "--frames", str(len(scene.frames)),
                                 "--out", out])
        launches = lc.get("nms")
    if decoded.shape != scene.frames.shape:
        fail(f"the mp4 decoded to {decoded.shape}, drawn {scene.frames.shape}")
    diff = float(np.abs(decoded.astype(np.int16) - scene.frames).mean())
    if diff > 8.0:
        fail(f"the decoded frames differ from the drawn ones by {diff:.2f} levels on average")
    if launches != 1 or sorted(res) != ["HRNet", "YOLO"] or "boxes" not in res["YOLO"]:
        fail(f"evaluate --video: {launches} NMS launches, sections {sorted(res)}")
    print(f"eval: --video/--labels on the card (OpenCV found): {len(decoded)} frames of an mp4 decoded "
          f"(mean |decoded - drawn| {diff:.3f} levels), the default model built on the card, results.json "
          f"written; YOLO.time {res['YOLO']['time'] * 1e3:.4f} ms a frame, HRNet.time "
          f"{res['HRNet']['time'] * 1e3:.4f} ms a frame (first calls of a new model)")


def phase_eval(model) -> None:
    """The eval CLI's body and the acceptance runner on the card: (a)
    ``evaluate.run`` with the slice model (full-width YOLOv8-l and
    HRNet-W48, bf16, seeded) on EVAL_FRAMES frames of the port's synthetic
    scene at 1280x720, twice: the results' keys against the artifact's
    schema, one NMS launch a detector call, and the metrics of the card's
    predictions equal to those of the same predictions as host numpy
    arrays; ms a frame of each model, the first call with its cuDNN
    set-up; (b) oracle runners (the scene's truth): perfect metrics; (c)
    ``validate_acceptance`` in dry-run on the card: four PASS gates, gate C
    against cv2 where OpenCV imports, else the float64 DLT; and gate C with
    OpenCV hidden, against the float64 DLT; (d) where OpenCV imports,
    :func:`eval_video`."""
    import copy
    import importlib.util
    import tempfile

    from eagle_tpu_torch import evaluate, validate_acceptance
    from eagle_tpu_torch.utils.synthetic import make_scene

    t0 = time.perf_counter()
    scene = make_scene(num_frames=EVAL_FRAMES, width=1280, height=720, num_players=10)
    truth = evaluate.synthetic_truth(scene)
    schema = validate_acceptance.FALLBACK_SCHEMA
    seen = {}
    recorder = copy.copy(model)
    recorder._keypoint_fn = lambda f: seen.setdefault("kp", model._keypoint_fn(f))
    recorder._detector_fn = lambda f: seen.setdefault("det", model._detector_fn(f))
    ms = []
    for _ in range(2):
        seen.clear()
        lc.reset()
        res = evaluate.run(recorder, scene.frames, *truth)
        if lc.get("nms") != 1:
            fail(f"evaluate.run made {lc.get('nms')} NMS launches for its one detector call")
        for name in ("YOLO", "HRNet"):
            if sorted(res[name]["metrics"]) != sorted(schema["metrics"]) or sorted(
                res[name]["classification"]
            ) != sorted(schema["classification"]):
                fail(f"results.json's {name} keys differ from the reference artifact's schema")
        if sorted(res) != ["HRNet", "YOLO"] or "boxes" not in res["YOLO"]:
            fail(f"results.json has the sections {sorted(res)}")
        kp, kp_valid = seen["kp"]
        if kp.device.type != "cuda":
            fail("the default keypoint runner's output is not on the card")
        host = copy.copy(model)
        host._keypoint_fn = lambda f: (kp.cpu().numpy(), kp_valid.cpu().numpy())
        host._detector_fn = lambda f: seen["det"]
        bad = results_mismatch(res, evaluate.run(host, scene.frames, *truth))
        if bad:
            fail(f"the metrics of the card's predictions differ from those of their host copies: {bad}")
        ms.append((res["YOLO"]["time"] * 1e3, res["HRNet"]["time"] * 1e3))
    n_pred = res["YOLO"]["boxes"]["num_pred"]
    print(f"eval: {EVAL_FRAMES} frames of 1280x720 (utils/synthetic.py), YOLOv8-{model.detector_model.variant} @ "
          f"{model.config.detector.image_size} and HRNet-W48 @ {model.config.keypoint.input_hw[0]}x"
          f"{model.config.keypoint.input_hw[1]}, {'bf16' if model.config.keypoint.use_bf16 else 'float32'}, one "
          f"runner call each over all frames: ms a frame "
          f"YOLO.time {ms[0][0]:.4f} then {ms[1][0]:.4f}, HRNet.time {ms[0][1]:.4f} then {ms[1][1]:.4f} "
          f"(first call with cuDNN's set-up); 1 NMS launch a detector call; {n_pred} person boxes scored; "
          f"metrics on card tensors == on host numpy within 1e-12; {card_line()}")

    keypoints, detections = eval_oracle_runners(truth)
    oracle = copy.copy(model)
    oracle._keypoint_fn, oracle._detector_fn = keypoints, detections
    res = evaluate.run(oracle, scene.frames, *truth)
    for name in ("YOLO", "HRNet"):
        if res[name]["metrics"]["2"] != 1.0 or res[name]["classification"]["f1_2"] != 1.0:
            fail(f"evaluate.run with oracle runners: {name} acc@2px {res[name]['metrics']['2']}, "
                 f"F1@2 {res[name]['classification']['f1_2']} (want 1.0)")
    if res["YOLO"]["boxes"]["mean_iou"] != 1.0:
        fail(f"evaluate.run with oracle runners: box IoU {res['YOLO']['boxes']['mean_iou']} (want 1.0)")
    print("eval: oracle runners: acc@2px 1.0 and F1@2 1.0 for both models, box IoU 1.0")

    opencv = importlib.util.find_spec("cv2") is not None
    if opencv:
        eval_video(scene, truth)
    # the runner as this machine has it (gate C against cv2 where OpenCV
    # imports), then gate C again with OpenCV hidden (the float64 DLT)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "acceptance.json")
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = validate_acceptance.main(["--dry-run", "--frames", "2", "--out", out])
        with open(out) as f:
            gates = json.load(f)["gates"]
        hidden = {"gates": {}}
        saved = sys.modules.get("cv2")
        sys.modules["cv2"] = None  # import cv2 raises ImportError
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                validate_acceptance.gate_c_pitch_rmse(validate_acceptance.Gate(hidden), d, 2, True, model.device)
        finally:
            if saved is None:
                del sys.modules["cv2"]
            else:
                sys.modules["cv2"] = saved
    status = {k: g["status"] for k, g in gates.items()}
    if rc != 0 or set(status.values()) != {"PASS"} or len(status) != 4:
        fail(f"validate_acceptance --dry-run on the card: exit {rc}, gates {status}\n{log.getvalue()}")
    want = "cv2" if opencv else "numpy_dlt"
    if gates["pitch_rmse"]["reference"] != want:
        fail(f"gate C's reference is {gates['pitch_rmse']['reference']!r}, want {want!r} (OpenCV found: {opencv})")
    dlt = hidden["gates"]["pitch_rmse"]
    if dlt["status"] != "PASS" or dlt["reference"] != "numpy_dlt":
        fail(f"gate C with OpenCV hidden: {dlt}")
    print(f"eval: validate_acceptance --dry-run on the card: {status}; gate B mean IoU "
          f"{gates['detector_iou']['mean_iou']}, gate C max RMSE {gates['pitch_rmse']['max_rmse_m']} m against "
          f"{want} (OpenCV found: {opencv}); gate C with OpenCV hidden: {dlt['status']}, max RMSE "
          f"{dlt['max_rmse_m']} m against numpy_dlt; phase wall {time.perf_counter() - t0:.1f} s")


def phase_bench() -> None:
    """The bench, ``python -m eagle_tpu_torch.bench --reps BENCH_REPS``, as
    a child process from this checkout: exit 0, a JSON headline as its last
    stdout line with every key of ``bench.KEYS``, ``status`` "ok", the
    card's name in ``device``, and on every path the flow, auction, NMS,
    keys and eigen-solve kernels launched and the JV kernel not.  Prints
    the headline."""
    import torch

    from eagle_tpu_torch import bench

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "eagle_tpu_torch.bench", "--reps", str(BENCH_REPS), "--budget-s", str(BENCH_BUDGET_S)],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)), timeout=BENCH_BUDGET_S + 120,
    )
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    try:
        head = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"the bench printed no headline (exit {r.returncode}):\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    if r.returncode != 0 or head.get("status") != "ok":
        fail(f"the bench: exit {r.returncode}, status {head.get('status')!r}\n{r.stderr[-4000:]}")
    missing = [k for k in bench.KEYS if k not in head]
    if missing or any(head[m] is None or head[f"{m}_spread"] is None for m in bench.METRICS):
        fail(f"the bench's headline lacks {missing} or a metric: {lines[-1]}")
    if not isinstance(head["device"], dict) or head["device"]["kind"] != torch.cuda.get_device_name(0):
        fail(f"the bench's device {head['device']!r} is not this card ({torch.cuda.get_device_name(0)})")
    for path, counts in head["launches"].items():
        if any(counts[k] <= 0 for k in bench.LAUNCHED) or any(counts[k] != 0 for k in bench.NOT_LAUNCHED):
            fail(f"the bench's {path} path launched {counts}")
    if sorted(head["launches"]) != sorted(bench.PATHS):
        fail(f"the bench counted launches on {sorted(head['launches'])}, not {sorted(bench.PATHS)}")
    if head["traced_kernels"] is not None:
        traced = {k: head["traced_kernels"][k] for k in bench.TRACED}
        print(f"bench: its traced run: device kernels in the trace {json.dumps(traced)}, launches counted "
              f"{json.dumps(head['traced_run_launches'])} (information: the profiler may miss a launch)")
    print(f"bench: python -m eagle_tpu_torch.bench --reps {BENCH_REPS}: exit 0 in {wall:.1f} s of wall; its headline:")
    print(f"bench: {lines[-1]}")


def phase_profile(model, frames, out_path: str) -> None:
    """One more run of the slice under ``torch.profiler``
    (``utils/profiling.py::profile_stages``).  Writes ``out_path`` (JSON)
    and prints one summary line."""
    from eagle_tpu_torch.utils.profiling import profile_stages

    stages, by_kernel, _ = profile_stages(model, frames, FPS, num_keypoint_detection=3)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    summary = {
        "frames": len(frames),
        "card": card_line(),
        "stages": stages,
        "top_device_ops": [{"name": k[:120], "count": n, "ms": ms} for k, (n, ms) in top],
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print("profile: " + json.dumps({k: {m: round(v, 3) if isinstance(v, float) else v for m, v in st.items()}
                                    for k, st in stages.items()}) + f" (details in {out_path})")
    print(f"profile: blocking calls in {len(frames)} frames: temporal step {stages['temporal']['blocking_calls']}, "
          f"detector stage {stages['detector']['blocking_calls']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="JSON", default=None,
                    help="also profile one run of the slice (and of the tracker's slice, to the same name "
                         "with _tracker appended) and write a per-stage summary here")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        import eagle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: eagle_tpu_torch not importable ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    global DEFAULT_TF32
    DEFAULT_TF32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    card = card_line()

    # every phase reads the captured steps' launch counts
    with lc.counting():
        t0 = time.perf_counter()
        build_log = phase_build()
        frames, pts = make_frames(N_FRAMES)
        flow = phase_kernel(frames, pts)
        phase_reference(frames, pts)
        flow["launches"], model, slice_res, slice_loops, slice_traced = phase_slice(frames)
        auction_entry, nms_entry = phase_loops(model, frames)
        auction_entry["launches"], nms_entry["launches"] = slice_loops["auction"], slice_loops["nms"]
        keys_entry, eigh_entry = phase_graph(frames, pts, model, slice_traced)
        keys_entry["launches"], eigh_entry["launches"] = slice_loops["keys"], slice_loops["eigh9"]
        auction_entry["rounds"] = slice_loops["rounds"]
        tracker_fields, tracker = phase_tracker(frames, pts, model)
        flow.update(tracker_fields)
        lap_entry = phase_exact(frames, pts, model, slice_res, build_log)
        phase_process(frames, pts)
        phase_cli(frames, pts, model)
        flow.update(phase_stream(frames, pts, model, slice_res))
        clips_entry = phase_multiclip(frames, pts, model)
        flow.update(phase_multidevice(model, frames, pts))
        phase_prescale(model, frames)
        phase_eval(model)
        phase_bench()
        if args.profile:
            phase_profile(model, frames[:PROFILE_FRAMES], args.profile)
            phase_profile(tracker, frames[:PROFILE_FRAMES], os.path.splitext(args.profile)[0] + "_tracker.json")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(decoder_probe())
    print(json.dumps({"kernels": [flow, clips_entry, lap_entry, auction_entry, nms_entry, keys_entry, eigh_entry]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
