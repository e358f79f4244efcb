"""Typed configuration tree for the PyTorch pipeline (a copy of the JAX
package's ``eagle_tpu/config.py``, kept separate so that this package
imports nothing of it).

The reference scatters its knobs across constructor kwargs and module
constants (CoordinateModel(keypoint_conf, detector_conf)
coordinate_model.py:49; get_coordinates(num_homography,
num_keypoint_detection, verbose, calibration) :188; Processor(debug,
filter_ball_detections) processor.py:65; BATCH=4 :20).  Here everything
lives in one frozen dataclass tree so a pipeline run is fully described by
a single hashable value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DetectorConfig:
    """Player/goalkeeper/ball detector (YOLOv8-family) settings.

    Mirrors the reference's detector behavior: confidence floor of 0.15 fed
    to the network, final keep threshold ``conf`` (coordinate_model.py:567,
    :590), 5 classes (:61).
    """

    variant: str = "large_hd"  # "medium" | "large" | "large_hd"
    #: square inference resolution (640 for medium/large, 960 for large_hd,
    #: reference README.md:108-111)
    image_size: int = 960
    conf: float = 0.35
    low_conf: float = 0.15
    #: class-aware NMS IoU threshold (ultralytics default)
    nms_iou: float = 0.7
    #: fixed detection-slot count for shape-stable XLA outputs
    max_detections: int = 128
    #: candidate count entering NMS (confidence top-k pre-selection)
    nms_pre_topk: int = 512
    num_classes: int = 5
    class_names: tuple[str, ...] = ("Player", "Goalkeeper", "Ball", "Referee", "Staff members")
    #: run the forward pass in bfloat16 on the MXU
    use_bf16: bool = True

    @property
    def input_hw(self) -> tuple[int, int]:
        return (self.image_size, self.image_size)


@dataclass(frozen=True)
class KeypointConfig:
    """Pitch-landmark model (HRNet-W48) settings (reference
    coordinate_model.py:58-64, keypoint_hrnet.py:505-563)."""

    num_keypoints: int = 57
    #: model input resolution (reference albumentations Resize(540, 960))
    input_hw: tuple[int, int] = (540, 960)
    #: keep threshold applied to heatmap peak scores (reference default 0.3)
    conf: float = 0.3
    #: hard floor applied inside decode (keypoint_hrnet.py:592)
    score_floor: float = 0.01
    #: HRNet width (stage channel multiplier base)
    width: int = 48
    use_bf16: bool = True


@dataclass(frozen=True)
class WorkGeometry:
    """Working-resolution geometry for the device pipeline.

    When enabled, the host prescales every frame once to the detector's
    rectangular letterbox canvas (ultralytics LetterBox(auto=True)
    semantics: scale to fit ``DetectorConfig.image_size``, pad each side up
    to a /32 multiple with gray 114).  All device stages consume that one
    buffer: the detector reads it directly (no device letterbox), the
    keypoint model slices/reads its 540x960 input out of the image region,
    and the temporal scan samples flow ROIs / hue windows from it with
    coordinates mapped by ``gain``/``pad``.  Keypoint, box and homography
    coordinates stay in ORIGINAL image space everywhere else.

    Identity (``enabled=False``) reproduces the full-resolution round-1
    path; it is forced whenever custom model callables are injected.
    """

    enabled: bool = False
    #: original -> working scale (min(size/h, size/w), ultralytics gain)
    gain: float = 1.0
    #: letterbox padding of the image region inside the canvas, pixels
    pad_x: int = 0
    pad_y: int = 0
    #: scaled image size inside the canvas
    img_h: int = 0
    img_w: int = 0
    #: canvas (= uploaded frame) size, /32-padded
    canvas_h: int = 0
    canvas_w: int = 0
    #: original frame size
    orig_h: int = 0
    orig_w: int = 0


@dataclass(frozen=True)
class FlowConfig:
    """Lucas-Kanade optical-flow settings (reference lk_params,
    coordinate_model.py:65) plus the propagation filters (:448-474)."""

    window: int = 15
    pyramid_levels: int = 2  # maxLevel=2 -> 3 levels total (0,1,2)
    iterations: int = 10
    #: iteration engine.  The JAX package's two names, "xla" and
    #: "pallas2", are synonyms here: both mean "the flow step", which
    #: runs the hand-written CUDA kernel (csrc/lk_flow.cu) on a CUDA
    #: tensor and its plain PyTorch version on a CPU tensor.  Any other
    #: value raises.
    backend: str = "xla"

    #: per-point iteration stop: once a Newton step falls below this the
    #: point is frozen (cv2 TERM_CRITERIA_EPS semantics, vectorized)
    epsilon: float = 0.03
    #: reject keypoints whose movement z-score exceeds this (:451)
    zscore_max: float = 2.0
    #: reject keypoints whose 3x3 mean hue changed by more than this (:473)
    hue_delta_max: float = 25.0


@dataclass(frozen=True)
class HomographyConfig:
    """DLT + RANSAC homography estimation (reference
    coordinate_model.py:354-357: RANSAC reproj 5.0 with RHO/LMEDS
    fallbacks; here a fixed-iteration vectorized RANSAC)."""

    ransac_iters: int = 512
    reproj_threshold: float = 5.0
    #: Gauss-Newton refinement steps on the inlier set
    refine_steps: int = 4
    min_points: int = 4
    #: when RANSAC finds < 4 inliers at ``reproj_threshold``, fall back to
    #: least-median-of-squares selection over the same hypothesis set (the
    #: role of the reference's LMEDS fallback, coordinate_model.py:354-357;
    #: branchless -- the median scoring reuses the already-computed errors)
    lmeds_fallback: bool = True


@dataclass(frozen=True)
class TrackerConfig:
    """BoTSORT-style tracker: batched Kalman + two-stage Hungarian
    association over a fixed track budget (reference uses boxmot BotSort,
    coordinate_model.py:68-72)."""

    max_tracks: int = 64
    #: high-confidence association threshold (first stage)
    track_high_thresh: float = 0.5
    #: low-confidence floor (second stage)
    track_low_thresh: float = 0.1
    #: threshold for spawning new tracks
    new_track_thresh: float = 0.6
    #: IoU gate for matching
    match_thresh: float = 0.8
    #: frames a lost track is kept before removal
    track_buffer: int = 30
    #: fuse detection scores into the first-stage cost (boxmot BotSort
    #: ships fuse_first_associate=False; the unconfirmed stage always fuses)
    fuse_first_associate: bool = False
    #: appearance costs are ignored where IoU distance exceeds this
    #: (boxmot proximity_thresh)
    proximity_thresh: float = 0.5
    #: association solver: "auction" (vectorized, scan-friendly) or
    #: "exact" (JV shortest augmenting path)
    assignment: str = "auction"
    #: camera-motion compensation (BoT-SORT's GMC role): "affine"
    #: (least-squares warp fitted to the pitch-keypoint flow -- documented
    #: deviation #5), "translation" (median keypoint shift), "features"
    #: (boxmot-style full-frame sparse features: grid corners + LK +
    #: robust partial-affine, `ops/corners.py`; keypoint-flow fallback
    #: when few features survive), "off"
    gmc: str = "affine"
    #: gmc="features": fall back to the keypoint-flow warp when fewer
    #: than this many feature tracks survive the robust fit
    gmc_min_features: int = 12
    #: appearance embeddings: fuse cosine distance into the first
    #: association stage (BoT-SORT's ReID role).  The reference runs
    #: BotSort with OSNet-x0.25 ReID on by default
    #: (coordinate_model.py:68-72); eagle-tpu defaults appearance to
    #: "auto" (None): ON exactly when ReID weights are supplied to
    #: ``CoordinateModel(reid_checkpoint=...)`` / ``reid_params=``
    #: (matching the reference's weights-present-implies-ReID behavior),
    #: OFF otherwise (documented deviation #10, docs/parity.md, with the
    #: measured ID-switch/throughput trade).  Explicit True/False always
    #: wins.  Outside ``CoordinateModel`` (direct ``track.botsort`` use)
    #: None behaves as False.
    use_appearance: bool | None = None
    #: built-in embedding network when ``use_appearance``: "osnet"
    #: (OSNet-x0.25, the reference's ReID model -- pass converted
    #: weights via CoordinateModel(reid_checkpoint=...)) or "histogram"
    #: (64-bin HSV, no weights needed; set embed_dim=64)
    embedder: str = "osnet"
    #: appearance embedding dimension (512 = OSNet feature head)
    embed_dim: int = 512
    #: embed only the first K confidence-sorted detection slots (NMS
    #: compacts kept boxes score-descending, ops/nms.py); slots beyond K
    #: get a zero embedding, which the appearance gate ignores (cosine
    #: distance 0.5 > appearance_thresh -> IoU-only cost, exactly the
    #: gate-miss fallback).  64 >= any realistic on-pitch detection count.
    #: Custom detector_fn callables must front-compact valid detections
    #: into the leading slots for appearance to see them.
    reid_slots: int = 64
    #: EMA smoothing for track embeddings (BoT-SORT default 0.9)
    embed_momentum: float = 0.9
    #: appearance-distance gate (BoT-SORT proximity/appearance thresh)
    appearance_thresh: float = 0.25


@dataclass(frozen=True)
class SynthesisConfig:
    """Geometric keypoint synthesis via line fitting + intersection
    (reference coordinate_model.py:140-186)."""

    enabled: bool = True
    min_points_per_line: int = 2
    max_new_points: int = 30
    #: minimum detected keypoints before synthesis kicks in (:326)
    min_keypoints: int = 2


@dataclass(frozen=True)
class ProcessorConfig:
    """Post-processing settings (reference processor.py)."""

    debug: bool = False
    filter_ball_detections: bool = False
    smooth: bool = False
    #: ball Kalman init window (processor.py:321)
    ball_kalman_init: int = 5
    #: column coverage floor: drop ids seen in <1% of frames (:202)
    min_coverage: float = 0.01
    #: track-merge gap limit in seconds (TEMPORAL_THRESHOLD = fps*1.1, :219)
    merge_gap_seconds: float = 1.1
    #: track-merge spatial limit in px per frame of gap (:272)
    merge_px_per_frame: float = 10.0
    #: skip team-vote crops with more overlap than this (:434)
    max_crop_overlap: float = 0.35
    #: merge temporally-disjoint track fragments (the reference's intended
    #: behavior; its own overlap test is a tautology and never merges --
    #: set False for bug-compatible output)
    enable_fragment_merge: bool = True
    #: fixed crop size for batched KMeans team assignment (TPU path);
    #: (32, 16) keeps the vote partition identical to the host backend on
    #: every pinned scene while cutting the crop upload 4x (the upload is
    #: the dominant Processor cost when the host link degrades)
    crop_hw: tuple[int, int] = (32, 16)
    #: Lloyd iterations for the batched k=2 KMeans
    kmeans_iters: int = 10
    #: team-color voting backend: "host" (per-crop sklearn KMeans, exact
    #: reference parity) or "device" (single batched clustering pass over
    #: resampled crops -- the fast path for the reference's slowest stage)
    team_assign: str = "device"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding settings.  ``data`` shards the frame/clip
    batch axis over ICI (SURVEY.md section 2.4).  ``hosts > 1`` makes the
    mesh hierarchical ``(hosts, per_host)`` with the batch axis sharded
    over BOTH axes, host-major -- consecutive shards land on one host, so
    the pipeline's pure data parallelism needs no DCN collectives and the
    slower inter-host links carry nothing in the steady state."""

    data_axis: str = "data"
    #: number of devices on the data axis; None = all available
    data_parallel: int | None = None
    #: process/host count for a multi-host (DCN) deployment; 1 = single host
    hosts: int = 1
    dcn_axis: str = "dcn"


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration (reference main.py +
    CoordinateModel/get_coordinates kwargs)."""

    detector: DetectorConfig = field(default_factory=DetectorConfig)
    keypoint: KeypointConfig = field(default_factory=KeypointConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    homography: HomographyConfig = field(default_factory=HomographyConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    synthesis: SynthesisConfig = field(default_factory=SynthesisConfig)
    processor: ProcessorConfig = field(default_factory=ProcessorConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    work: WorkGeometry = field(default_factory=WorkGeometry)

    #: homography recomputations per second (reference num_homography=1)
    num_homography: int = 1
    #: keypoint-model invocations per second (reference num_keypoint_detection=3)
    num_keypoint_detection: int = 3
    #: brightness-snap keypoint calibration (reference calibration=False)
    calibration: bool = False
    #: frames processed per device step (temporal chunk for the scan stage)
    chunk_frames: int = 96
    #: host->device frame encoding: "auto" uploads 4:2:0 YUV planes (half
    #: the bytes of BGR; broadcast video is natively 4:2:0, so the BGR the
    #: reference feeds its models is itself a chroma upsample) whenever the
    #: working-resolution prescale is active and the canvas dims are even,
    #: falling back to raw BGR otherwise; "bgr" forces raw BGR; "yuv420"
    #: forces planes (requires even canvas dims)
    upload_format: str = "auto"
    #: where the working-canvas letterbox runs: "host" (cv2 plane resize,
    #: default; fewest link bytes) or "device" (upload RAW-resolution
    #: 4:2:0 planes, resize + pad on TPU via interp matmuls) -- "device"
    #: cuts the per-frame host cost ~1.5x (only the BGR->I420 conversion
    #: remains: 1.08 vs 1.59 ms/frame measured) at ~1.8x the link bytes:
    #: the right trade on production PCIe hosts where the host CPU, not
    #: the link, bounds throughput (docs/architecture.md extrapolation).
    #: Falls back to host prescale when the 4:2:0 geometry does not apply.
    prescale: str = "host"

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = PipelineConfig()
