"""CoordinateModel: the public perception API (PyTorch counterpart of
``eagle_tpu/pipeline/coordinate_model.py``).

``CoordinateModel(...).get_coordinates(frames, fps)`` returns, per frame,
the tracked players with pitch coordinates, the ball, the pitch keypoints
and the visible-pitch boundaries, with the reference's output schema.
``stream_coordinates(segments, fps)`` gives the same for a stream of
segments in bounded memory, one block at a time.  The path, for a clip or a
block:

- host prescale: every frame is letterboxed once on the host to the
  detector's working canvas (544x960 for 720p) as packed 4:2:0 planes
  (native C++; :meth:`CoordinateModel.prescale_clip` runs it alone, with no
  device work, so a worker thread can), uploaded and rebuilt as BGR on the
  card (BT.601 inverse) ``PIECE`` frames at a time into one uint8 frame
  buffer; ``PipelineConfig.prescale`` / ``upload_format`` choose the JAX
  package's other modes (:meth:`CoordinateModel._prescale_plan`);
- the detector (YOLOv8 + class-aware NMS) on every frame, in batches of
  ``PIECE``, and with ``TrackerConfig.use_appearance`` the appearance
  embeddings of the first ``reid_slots`` detections of each frame (OSNet
  or the HSV histogram); the keypoint model (HRNet-W48 + heatmap decode)
  on the cadence frames, in batches of ``KP_BATCH``;
- first-frame seeding by backward flow, then the temporal step
  (:mod:`eagle_tpu_torch.pipeline.temporal`) with the reference's
  on-demand keypoint rounds (at most 3): on the card as the JAX package
  runs it, one device program a ``chunk_frames`` chunk (a captured CUDA
  graph of the step, :mod:`eagle_tpu_torch.pipeline.step_graph`), on the
  CPU (and with ``gmc="features"``) a loop frame by frame;
- the float64 host assembly of the output dicts.

Models: the built-in HRNet / YOLOv8 (seeded random weights, checkpoint
files through ``keypoint_checkpoint=`` / ``detector_checkpoint=``, or the
JAX package's parameter pytrees through ``keypoint_params=`` /
``detector_params=``), or injected callables ``keypoint_fn`` /
``detector_fn``, which receive original-resolution frames (and force the
identity geometry).  The ReID OSNet-x0.25: a checkpoint
(``reid_checkpoint=``), a JAX pytree (``reid_params=``), or a seeded random
init (with a warning).  ``TrackerConfig.use_appearance=None`` means on
exactly when ReID weights are given.  Checkpoint formats: ``.msgpack``
(the JAX package's ``save_params``, any model), ``.onnx`` (the detector),
else a torch state dict -- the reference's ``KeypointModel`` for HRNet,
ultralytics' for YOLOv8, torchreid's for OSNet.

``get_coordinates(_clip_lens=)`` runs several clips as one flattened
stream (:class:`eagle_tpu_torch.pipeline.multiclip.MultiClipRunner`).

The entry point runs on the CUDA card unless the caller passes
``device="cpu"``; with no card it raises.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from eagle_tpu_torch import pitch
from eagle_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig, WorkGeometry
from eagle_tpu_torch.models.bridge import hrnet_from_jax, osnet_from_jax, yolov8_from_jax
from eagle_tpu_torch.models.checkpoint import load_params
from eagle_tpu_torch.models.convert import load_hrnet_checkpoint, yolov8_from_torch
from eagle_tpu_torch.models.hrnet import init_hrnet
from eagle_tpu_torch.models.onnx_import import load_yolov8_onnx
from eagle_tpu_torch.models.osnet import OSNet, embed_boxes, init_osnet, osnet_from_torch
from eagle_tpu_torch.models.yolov8 import CONFIG_VARIANTS, init_yolov8
from eagle_tpu_torch.ops.embed import HIST_BINS, histogram_embeddings
from eagle_tpu_torch.ops.heatmap import decode_heatmaps
from eagle_tpu_torch.ops.nms import batched_nms
from eagle_tpu_torch.ops.optical_flow import alloc_frames, carry_frame, upload_frames
from eagle_tpu_torch.ops.preprocess import (
    compute_work_geometry,
    device_letterbox_i420,
    host_letterbox,
    host_letterbox_i420,
    host_to_i420,
    i420_geometry_ok,
    i420_to_bgr,
    i420_to_bgr_exact,
    letterbox,
    normalize_imagenet,
    preprocess_keypoint,
    resize_bilinear,
    resolve_upload_format,
)
from eagle_tpu_torch.pipeline import temporal
from eagle_tpu_torch.pipeline.transfer import drain_together
from eagle_tpu_torch.utils import device_constant
from eagle_tpu_torch.utils.logging import log_event

PITCH_WIDTH = 105
PITCH_HEIGHT = 68

#: frames per detector batch
PIECE = 16
#: keypoint-model batch
KP_BATCH = 8
#: on-demand keypoint rounds (the reference's cap)
ONDEMAND_ROUNDS = 3


class PrescaledClip(NamedTuple):
    """A clip's host prescale (:meth:`CoordinateModel.prescale_clip`), for
    ``get_coordinates(prescaled=...)``: ``n`` frames and ``mode``, the JAX
    package's upload modes, which say what ``host`` holds:

    - "canvas_planes": the packed 4:2:0 working canvases, (N,
      canvas_h*3/2, canvas_w) uint8, decoded on the device;
    - "raw_planes" (``prescale="device"``): the frames' own packed 4:2:0
      planes, (N, H*3/2, W), letterboxed on the device;
    - "canvas_bgr": the BGR working canvases (N, canvas_h, canvas_w, 3);
    - "raw_bgr": the frames themselves, contiguous.

    ``yuv``: the BGR modes cross to the device as 4:2:0 planes (the
    configuration's transport, :meth:`CoordinateModel._prescale_plan`)."""

    mode: str
    n: int
    host: np.ndarray
    yuv: bool = False


def load_keypoint_params(path: str):
    """An HRNet checkpoint -> its parameter tree: ``.msgpack`` (the JAX
    package's ``save_params``), else a ``.pth`` state dict of the
    reference's ``KeypointModel``."""
    return load_params(path) if path.endswith(".msgpack") else load_hrnet_checkpoint(path)


def load_detector_params(path: str):
    """A YOLOv8 checkpoint -> its parameter tree: ``.msgpack``, ``.onnx``
    (an ultralytics export, fused or not), else an ultralytics state dict
    (``torch.load(weights_only=True)``)."""
    if path.endswith(".msgpack"):
        return load_params(path)
    if path.endswith(".onnx"):
        return load_yolov8_onnx(path)
    return yolov8_from_torch(torch.load(path, map_location="cpu", weights_only=True))


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The card unless the caller asks for the CPU; no quiet fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port's entry points (CoordinateModel, Processor) run on the CUDA card by "
            'default and none is available; pass device="cpu" to run the plain CPU path'
        )
    return dev


def find_x_at_y(pt1, pt2, y_target):
    """Line solve used for the visible-pitch boundary clamp, with Python
    division semantics (raises on vertical or horizontal lines)."""
    x1, y1 = pt1
    x2, y2 = pt2
    m = (y2 - y1) / (x2 - x1)
    c = y1 - m * x1
    return (y_target - c) / m


class StageTimer:
    """Wall-clock seconds per stage; ``sync`` makes each stage end with a
    device synchronisation so the time lands where the work is.  Each span
    is also a ``torch.profiler`` range named ``stage:<name>``, so a trace
    can attribute device time to the stages.  ``counts``: the spans each
    stage has closed."""

    def __init__(self, device: torch.device, sync: bool = False):
        self.device = device
        self.sync = sync
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def __call__(self, name: str):
        timer = self

        class _Span:
            def __enter__(self):
                self.range = torch.profiler.record_function(f"stage:{name}")
                self.range.__enter__()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                if timer.sync and timer.device.type == "cuda":
                    torch.cuda.synchronize(timer.device)
                timer.seconds[name] = timer.seconds.get(name, 0.0) + time.perf_counter() - self.t0
                timer.counts[name] = timer.counts.get(name, 0) + 1
                self.range.__exit__(*exc)

        return _Span()

    def summary(self) -> dict:
        """{stage: {"total_s", "calls", "mean_ms"}}, largest total first
        (the JAX package's ``StageTimer.summary``)."""
        return {
            name: {
                "total_s": round(self.seconds[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.seconds[name] / max(1, self.counts[name]), 3),
            }
            for name in sorted(self.seconds, key=self.seconds.get, reverse=True)
        }

    def report(self) -> str:
        """JSON of the stages' milliseconds, in the order they first ran."""
        return json.dumps({k: round(v * 1e3, 3) for k, v in self.seconds.items()}, indent=2)


def _reid_model(cfg: PipelineConfig, reid_params=None, reid_checkpoint: str | None = None, seed: int = 0):
    """The appearance slot's OSNet (on the CPU), or None when the config
    embeds nothing or with the histogram.  Checks the embedder, that given
    weights will be used, and that the feature width is ``embed_dim``.
    Weights: a checkpoint (``.msgpack``, else a torchreid state dict,
    ``.pt`` / ``.pth``), a JAX pytree, or a seeded random init with a
    warning."""
    tcfg = cfg.tracker
    if tcfg.use_appearance and tcfg.embedder not in ("osnet", "histogram"):
        raise ValueError(
            f"TrackerConfig.embedder must be 'osnet' or 'histogram' when use_appearance=True, got {tcfg.embedder!r}"
        )
    osnet = bool(tcfg.use_appearance) and tcfg.embedder == "osnet"
    if (reid_checkpoint is not None or reid_params is not None) and not osnet:
        raise ValueError(
            "reid_checkpoint/reid_params given but the tracker would not use them: set "
            'TrackerConfig(use_appearance=True, embedder="osnet")'
        )
    bins = int(np.prod(HIST_BINS))
    if tcfg.use_appearance and tcfg.embedder == "histogram" and tcfg.embed_dim != bins:
        raise ValueError(
            f"the histogram embedder is a fixed {bins}-bin HSV histogram; set TrackerConfig.embed_dim={bins} "
            "(or use embedder='osnet')"
        )
    if not osnet:
        return None
    bf16 = cfg.detector.use_bf16
    if reid_checkpoint is not None and reid_checkpoint.endswith(".msgpack"):
        model = osnet_from_jax(load_params(reid_checkpoint), use_bf16=bf16)
    elif reid_checkpoint is not None:
        sd = torch.load(reid_checkpoint, map_location="cpu", weights_only=True)
        model = osnet_from_torch(sd, use_bf16=bf16)
    elif reid_params is not None:
        model = osnet_from_jax(reid_params, use_bf16=bf16)
    else:
        warnings.warn(
            "OSNet ReID enabled without weights: appearance embeddings are RANDOM (association falls back "
            "to its IoU behaviour at best); pass reid_checkpoint= (osnet_x0_25_msmt17.pt) for the "
            "reference's ReID",
            stacklevel=3,
        )
        model = init_osnet(seed + 2, "x0_25", feature_dim=tcfg.embed_dim, use_bf16=bf16)
    feat_dim = int(model.fc.w.shape[1])
    if feat_dim != tcfg.embed_dim:
        raise ValueError(
            f"ReID checkpoint feature dim {feat_dim} != TrackerConfig.embed_dim {tcfg.embed_dim}: the "
            "detection rows and the track-embedding carry are sized by embed_dim "
            "(osnet_x0_25_msmt17.pt is 512-d)"
        )
    return model


class CoordinateModel:
    def __init__(
        self,
        keypoint_conf: float = 0.3,
        detector_conf: float = 0.35,
        *,
        config: PipelineConfig | None = None,
        keypoint_params=None,
        detector_params=None,
        keypoint_checkpoint: str | None = None,
        detector_checkpoint: str | None = None,
        keypoint_fn: Callable | None = None,
        detector_fn: Callable | None = None,
        reid_params=None,
        reid_checkpoint: str | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        verbose_init: bool = False,
    ):
        """``verbose_init`` (the JAX package's keyword, default True there):
        when true, prints ``Using <device> for inference`` once the device
        is resolved, as the JAX package prints its backend; the default
        prints nothing."""
        cfg = config or DEFAULT_CONFIG
        if cfg.tracker.use_appearance is None:
            # "follow the weights": ReID is on exactly when weights are given
            given = reid_checkpoint is not None or reid_params is not None
            cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, use_appearance=given))
        temporal.check_config(cfg)
        reid = _reid_model(cfg, reid_params, reid_checkpoint, seed)
        self.config = cfg
        self.device = resolve_device(device)
        if verbose_init:
            print(f"Using {self.device} for inference")
        #: the appearance slot's OSNet (None with the histogram or no ReID)
        self.reid_model: OSNet | None = None if reid is None else reid.to(self.device).eval()
        self.keypoint_conf = keypoint_conf
        self.detector_conf = detector_conf
        self.seed = seed
        #: temporal steps run, and on-demand keypoint rounds run (observability)
        self.frames_stepped = 0
        self.ondemand_rounds = 0
        #: the captured temporal steps, one a configuration (:meth:`_step_graph`)
        self._step_graphs: dict = {}

        # the default runners are bound as the JAX package binds them; every
        # path of get_coordinates branches on the _custom_* flags instead
        self._custom_kp = keypoint_fn is not None
        self._keypoint_fn = self._default_keypoint_fn if keypoint_fn is None else keypoint_fn
        self.keypoint_model = None
        if keypoint_fn is None:
            kcfg = cfg.keypoint
            if keypoint_checkpoint is not None:
                keypoint_params = load_keypoint_params(keypoint_checkpoint)
            if keypoint_params is not None:
                model = hrnet_from_jax(keypoint_params, use_bf16=kcfg.use_bf16)
            else:
                model = init_hrnet(seed, kcfg.num_keypoints, use_bf16=kcfg.use_bf16)
            self.keypoint_model = model.to(self.device).eval()

        self._custom_det = detector_fn is not None
        self._detector_fn = self._default_detector_fn if detector_fn is None else detector_fn
        self.detector_model = None
        if detector_fn is None:
            dcfg = cfg.detector
            if detector_checkpoint is not None:
                detector_params = load_detector_params(detector_checkpoint)
            if detector_params is not None:
                model = yolov8_from_jax(detector_params, use_bf16=dcfg.use_bf16)
            else:
                model = init_yolov8(
                    seed + 1, CONFIG_VARIANTS[dcfg.variant], dcfg.num_classes, use_bf16=dcfg.use_bf16
                )
            self.detector_model = model.to(self.device).eval()

    # ------------------------------------------------------------------

    def _geometry(self, img_hw: tuple[int, int]) -> WorkGeometry:
        """Working-canvas geometry, or identity when custom callables are
        injected or the canvas image would be smaller than the keypoint
        input."""
        if self._custom_kp or self._custom_det:
            return WorkGeometry()
        g = compute_work_geometry(img_hw, self.config.detector.image_size)
        kh, kw = self.config.keypoint.input_hw
        if g.img_h < kh or g.img_w < kw:
            return WorkGeometry()
        return g

    def upload(self, frames: np.ndarray, geom: WorkGeometry) -> torch.Tensor:
        """Host prescale + upload: (N, H, W, 3) uint8 BGR -> the device
        frames every stage consumes ((N, canvas_h, canvas_w, 3) uint8 BGR
        on the working path, the raw frames otherwise, their rows padded to
        16 bytes on the card: :func:`alloc_frames`)."""
        return self._upload(self._prescale(frames, geom), geom)

    def _prescale_plan(self, geom: WorkGeometry, img_hw: tuple[int, int]) -> tuple[str, bool]:
        """(mode, yuv): the upload mode (see :class:`PrescaledClip`) and
        whether frames cross to the device as 4:2:0 planes, by the JAX
        package's rule (``_DevicePieces._host_plan``): 4:2:0 when the
        resolved ``upload_format`` is "yuv420" and what is uploaded (the
        canvas, or the raw frames) has H % 4 == 0 and an even W; the 4:2:0
        letterbox when that holds and :func:`i420_geometry_ok`, on the
        device with ``prescale="device"``, else on the host; the BGR
        letterbox with any other working geometry; the raw frames
        without one."""
        cfg = self.config
        if cfg.prescale not in ("host", "device"):
            raise ValueError(f"PipelineConfig.prescale must be 'host' or 'device', got {cfg.prescale!r}")
        fmt = resolve_upload_format(cfg.upload_format, geom.enabled)
        h, w = (geom.canvas_h, geom.canvas_w) if geom.enabled else img_hw
        yuv = fmt == "yuv420" and h % 4 == 0 and w % 2 == 0
        if yuv and geom.enabled and i420_geometry_ok(geom, img_hw):
            return ("raw_planes" if cfg.prescale == "device" else "canvas_planes"), yuv
        return ("canvas_bgr" if geom.enabled else "raw_bgr"), yuv

    def _prescale(self, frames, geom: WorkGeometry) -> PrescaledClip:
        """The host prescale of ``frames``, an (N, H, W, 3) array or a list
        of such clips prescaled one after another into one flat clip."""
        if isinstance(frames, (list, tuple)):
            parts = [self._prescale(np.asarray(c), geom) for c in frames]
            host = parts[0].host if len(parts) == 1 else np.concatenate([p.host for p in parts])
            return parts[0]._replace(n=len(host), host=host)
        frames = np.asarray(frames)
        mode, yuv = self._prescale_plan(geom, (int(frames.shape[1]), int(frames.shape[2])))
        host = {
            "canvas_planes": lambda: host_letterbox_i420(frames, geom),
            "raw_planes": lambda: host_to_i420(frames),
            "canvas_bgr": lambda: host_letterbox(frames, geom),
            "raw_bgr": lambda: np.ascontiguousarray(frames),
        }[mode]()
        return PrescaledClip(mode, len(frames), host, yuv)

    def prescale_clip(self, frames) -> PrescaledClip:
        """The host prescale of a clip alone, as :meth:`get_coordinates`
        would make it: no device work, so a worker thread can run it while
        the previous clip's device phase runs (the native prescale releases
        the GIL).  Pass the result as ``get_coordinates(...,
        prescaled=...)``."""
        frames = np.asarray(frames)
        return self._prescale(frames, self._geometry((int(frames.shape[1]), int(frames.shape[2]))))

    def _upload(self, pre: PrescaledClip, geom: WorkGeometry) -> torch.Tensor:
        """The device frames of a prescaled clip: uploaded ``PIECE`` frames
        at a time and decoded (4:2:0 planes), letterboxed ("raw_planes") or
        copied into one uint8 frame buffer in the layout of
        :func:`alloc_frames` (rows padded to 16 bytes on the card), so that
        the decode's temporaries are one piece's and the flow kernel reads
        every frame in place."""
        dev = self.device
        h, w = (geom.canvas_h, geom.canvas_w) if pre.mode != "raw_bgr" else pre.host.shape[1:3]
        out = alloc_frames(pre.n, h, w, dev)
        for i in range(0, pre.n, PIECE):
            part = pre.host[i : i + PIECE]
            if pre.mode == "canvas_planes":
                x = i420_to_bgr(torch.from_numpy(part).to(dev))
            elif pre.mode == "raw_planes":
                x = device_letterbox_i420(torch.from_numpy(part).to(dev), geom)
            elif pre.yuv:
                x = i420_to_bgr(torch.from_numpy(host_to_i420(part)).to(dev))
            else:
                x = torch.from_numpy(part).to(dev)
            out[i : i + len(part)].copy_(x)
        return out

    def _seed_frames(self, pre: PrescaledClip, geom: WorkGeometry, dev_frames, lo: int, hi: int) -> torch.Tensor:
        """Frames ``lo:hi`` for the backward seed, on the device, as the JAX
        package seeds over its host copies (``_DevicePieces.host_range``):
        OpenCV's decode of the 4:2:0 canvases, OpenCV's decode of the raw
        planes letterboxed on the host ("raw_planes"), the host's BGR
        frames otherwise (the device frames themselves when they crossed
        as BGR)."""
        dev = self.device
        part = pre.host[lo:hi]
        if pre.mode == "canvas_planes":
            return i420_to_bgr_exact(torch.from_numpy(part).to(dev))
        if pre.mode == "raw_planes":
            return upload_frames(host_letterbox(i420_to_bgr_exact(torch.from_numpy(part)).numpy(), geom), dev)
        return upload_frames(part, dev) if pre.yuv else dev_frames[lo:hi]

    @torch.no_grad()
    def run_keypoints(self, x: torch.Tensor, geom: WorkGeometry, img_hw) -> torch.Tensor:
        """Keypoint forward on a (B, H, W, 3) uint8 BGR device batch ->
        (B, 57, 4) [x, y, score, valid] in ORIGINAL image coordinates."""
        kcfg = self.config.keypoint
        if geom.enabled:
            img = x[:, geom.pad_y : geom.pad_y + geom.img_h, geom.pad_x : geom.pad_x + geom.img_w]
            img = img.flip(-1).to(torch.float32)
            if (geom.img_h, geom.img_w) != tuple(kcfg.input_hw):
                img = resize_bilinear(img, tuple(kcfg.input_hw))
            pre = normalize_imagenet(img)
        else:
            pre = preprocess_keypoint(x, out_hw=tuple(kcfg.input_hw))
        hm = self.keypoint_model(pre.permute(0, 3, 1, 2).contiguous())
        kp, valid = decode_heatmaps(hm, self.keypoint_conf, img_hw, kcfg.score_floor)
        return torch.cat([kp, valid.to(torch.float32)[..., None]], dim=-1)

    @torch.no_grad()
    def run_detector(self, x: torch.Tensor, geom: WorkGeometry, img_hw, timer: StageTimer | None = None) -> torch.Tensor:
        """Detector + NMS on a (B, H, W, 3) uint8 BGR device batch ->
        (B, D, 7) [x1, y1, x2, y2, conf, cls, valid] in ORIGINAL pixels,
        and with appearance on (B, D, 7 + E): the embeddings of the boxes,
        cropped from ``x`` (on the working path with the boxes mapped to
        canvas pixels).  ``timer`` takes the stages "detector" and
        "reid"."""
        timer = timer or StageTimer(self.device)
        dcfg = self.config.detector
        with timer("detector"):
            if geom.enabled:
                imgs = x.flip(-1).to(torch.float32) / 255.0
                gain = geom.gain
                pad = (geom.pad_x, geom.pad_y)
            else:
                imgs, gain, pad = letterbox(x, size=dcfg.image_size)
            boxes, scores = self.detector_model(imgs.permute(0, 3, 1, 2).contiguous())
            b, s, c, v = batched_nms(
                boxes,
                scores,
                conf_threshold=min(self.detector_conf, dcfg.low_conf),
                iou_threshold=dcfg.nms_iou,
                max_det=dcfg.max_detections,
                pre_topk=dcfg.nms_pre_topk,
            )
            wmap, hi = self._box_map(b.device, gain, pad, img_hw)
            nb, d = b.shape[:2]
            b = torch.minimum(torch.clamp(wmap.to_orig(b.view(nb, d, 2, 2)).view(nb, d, 4), min=0.0), hi)
            rows = torch.cat(
                [b, s[..., None], c.to(torch.float32)[..., None], v.to(torch.float32)[..., None]], dim=-1
            )
        if self.config.tracker.use_appearance:
            with timer("reid"):
                crop = wmap.to_frame(b.view(nb, d, 2, 2)).view(nb, d, 4) if geom.enabled else b
                rows = torch.cat([rows, self.embed(x, crop)], dim=-1)
        return rows

    def _box_map(self, dev, gain: float, pad, img_hw) -> tuple[temporal._WorkMap, torch.Tensor]:
        """(the map between the detector's letterbox and original pixels,
        the clamp's upper corner (4,) float32) on ``dev``, made once a
        device and geometry.  The JAX program divides the boxes by a
        compile-time gain, which XLA compiles as a product with its float32
        reciprocal, and maps them back to the canvas as one multiply-add:
        ``temporal._WorkMap``'s arithmetic."""
        g = np.float32(gain)
        h, w = img_hw
        return device_constant(("box_map", str(dev), float(gain), tuple(pad), tuple(img_hw)), lambda: (
            temporal._WorkMap(
                torch.tensor(g, device=dev),
                torch.tensor(np.float32(1.0) / g, device=dev),
                torch.tensor([pad[0], pad[1]], dtype=torch.float32, device=dev),
            ),
            torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32, device=dev),
        ))

    @torch.no_grad()
    def embed(self, x: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Appearance embeddings: (B, H, W, 3) uint8 frames + (B, D, 4) xyxy
        boxes in the same pixels -> (B, D, E).  Only the first
        ``TrackerConfig.reid_slots`` slots (NMS compacts kept boxes score-
        descending; a custom ``detector_fn`` must front-compact its valid
        ones) are embedded; the others get zeros, which the appearance gate
        treats as a miss."""
        tcfg = self.config.tracker
        nb, d = boxes.shape[:2]
        k = min(tcfg.reid_slots, d)
        if self.reid_model is not None:
            emb = embed_boxes(self.reid_model, x, boxes[:, :k])
        else:
            fi = torch.arange(nb, device=x.device).repeat_interleave(k)
            emb = histogram_embeddings(x, fi, boxes[:, :k].reshape(-1, 4)).reshape(nb, k, -1)
        return torch.cat([emb, emb.new_zeros(nb, d - k, emb.shape[-1])], dim=1)

    def _seed_clips(self, spans, sampled, mem_kp, mem_valid, cfg, frames_of) -> None:
        """First-frame seeding (the reference's backward flow), in place on
        the memos: for each clip span (first index, real length) whose
        first frame has under 4 keypoints, flow backward from the span's
        first sampled frame that has 4 or more, over ``frames_of(lo, hi)``
        (device frames lo..hi-1); memoized entries win per label."""
        dev = self.device
        for base, clip_n in spans:
            if mem_valid[base].sum() >= 4:
                continue
            found = next((j - base for j in sampled if base <= j < base + clip_n and mem_valid[j].sum() >= 4), None)
            if not found:
                continue
            seed_xy, seed_ok = temporal.backward_seed(
                frames_of(base, base + found + 1),
                torch.from_numpy(mem_kp[base + found, :, :2]).to(dev),
                torch.from_numpy(mem_valid[base + found]).to(dev),
                cfg,
            )
            seed_xy, seed_ok = seed_xy.cpu().numpy(), seed_ok.cpu().numpy()
            for j in range(found):
                take = seed_ok[j] & ~mem_valid[base + j]
                mem_kp[base + j, take, :2] = seed_xy[j, take]
                mem_valid[base + j] |= seed_ok[j]

    def _captured_scan(self, cfg: PipelineConfig) -> bool:
        """Whether the temporal stage runs as captured chunks
        (:meth:`_scan_chunks`): on a CUDA device unless the configuration
        takes ``gmc="features"`` (its corners and robust fit run in the
        eager loop).  ``_temporal_path`` ("chunks" or "frames") overrides
        the choice: a private switch for comparisons and tests."""
        path = getattr(self, "_temporal_path", None)
        if path is not None:
            return path == "chunks"
        return self.device.type == "cuda" and cfg.tracker.gmc != "features"

    def _step_graph(self, cfg: PipelineConfig, frame_hw, det_rows: int, det_width: int, reset_on_t0: bool):
        """The :class:`~eagle_tpu_torch.pipeline.step_graph.StepGraph` of
        this configuration, made once (its graph is captured at its first
        step)."""
        from eagle_tpu_torch.pipeline.step_graph import StepGraph

        key = (cfg, tuple(frame_hw), det_rows, det_width, reset_on_t0, str(self.device))
        if key not in self._step_graphs:
            self._step_graphs[key] = StepGraph(cfg, frame_hw, det_rows, det_width, self.seed, reset_on_t0, self.device)
        return self._step_graphs[key]

    def _scan_frames(self, cfg, dev_frames, prev0, carry0, det, tt, kp_interval, h_interval, mem_kp, mem_valid,
                     mem_attempted, keypoints_at, timer, reset_on_t0):
        """The temporal stage as a loop of :func:`temporal.temporal_step`
        frame by frame, with per-frame carry checkpoints: when the
        reference's on-demand keypoint detection would fire (flow collapse
        on a non-cadence frame with no memo), the flagged frames get model
        keypoints (``keypoints_at``) and the loop resumes at the first of
        them.  Returns (``drain()``, which gives the outputs and the
        detector rows on the host in one copy, the last carry)."""
        dev = self.device
        n = len(tt)
        keys_fn = self._ransac_draws(cfg)
        carries = [carry0] + [None] * n
        outs: list = [None] * n
        start = 0
        for _round in range(ONDEMAND_ROUNDS):
            with timer("temporal"):
                mk = torch.from_numpy(mem_kp).to(dev)
                mv = torch.from_numpy(mem_valid).to(dev)
                for t in range(start, n):
                    tg = int(tt[t])
                    carry = carries[t]
                    if reset_on_t0 and tg == 0 and t > 0:
                        carry = temporal.init_carry(cfg, dev)
                    xs = temporal.FrameInputs(
                        frame_bgr=dev_frames[t],
                        prev_frame_bgr=dev_frames[t - 1] if t > 0 else prev0,
                        model_kp=mk[t],
                        model_kp_valid=mv[t],
                        is_kp_frame=tg % kp_interval == 0,
                        is_h_frame=tg % h_interval == 0,
                        det_boxes=det[t, :, :4],
                        det_conf=det[t, :, 4],
                        det_cls=det[t, :, 5].to(torch.int64),
                        det_valid=det[t, :, 6] > 0.5,
                        t=tg,
                        det_embed=det[t, :, 7:] if cfg.tracker.use_appearance else None,
                    )
                    carries[t + 1], outs[t] = temporal.temporal_step(carry, xs, cfg, keys_fn)
                    self.frames_stepped += 1
                need = torch.stack([o.need_kp for o in outs]).cpu().numpy()
            flagged = np.flatnonzero(need & ~mem_attempted)
            if len(flagged) == 0:
                break
            self._ondemand(flagged, mem_kp, mem_valid, mem_attempted, keypoints_at, timer)
            start = int(flagged[0])

        def drain():
            # the outputs and the detector rows in one device-to-host copy
            *leaves, det_np = drain_together(
                *(torch.stack([o[i] for o in outs]) for i in range(len(outs[0]))), det[..., :7]
            )
            return temporal.FrameOutputs(*leaves), det_np

        return drain, carries[n]

    def _scan_chunks(self, cfg, dev_frames, prev0, carry0, det, tt, kp_interval, h_interval, mem_kp, mem_valid,
                     mem_attempted, keypoints_at, timer, reset_on_t0):
        """The temporal stage as the JAX package runs it: one device program
        a ``chunk_frames`` chunk (its ``_run_chunk``), here a captured CUDA
        graph of :func:`temporal.temporal_step_static` replayed frame by
        frame (:class:`~eagle_tpu_torch.pipeline.step_graph.StepGraph`;
        the eager step on the CPU), with a carry checkpoint a chunk.  A
        round uploads the memos once and drains its outputs and the
        detector rows in one copy; when frames are flagged for on-demand
        keypoints, the next round resumes at the first flagged frame's
        chunk.  Returns what :meth:`_scan_frames` returns (the last round's
        drain, already made)."""
        dev = self.device
        n = len(tt)
        chunk = cfg.chunk_frames
        n_chunks = -(-n // chunk)
        sg = self._step_graph(cfg, dev_frames.shape[1:3], det.shape[1], det.shape[2], reset_on_t0)
        with timer("temporal"):
            steps = torch.from_numpy(np.stack([tt, tt % kp_interval == 0, tt % h_interval == 0])).to(dev)
            t_dev, is_kp, is_h = steps[0], steps[1] > 0, steps[2] > 0
        carries = [carry0] + [None] * n_chunks
        outs: list = [None] * n_chunks
        start = 0
        for _round in range(ONDEMAND_ROUNDS):
            with timer("temporal"):
                memo = torch.from_numpy(np.concatenate([mem_kp, mem_valid[..., None].astype(np.float32)], -1)).to(dev)
                for k in range(start, n_chunks):
                    lo, hi = k * chunk, min(n, (k + 1) * chunk)

                    def pair(i, lo=lo):
                        t = lo + i
                        return (dev_frames[t - 1] if t > 0 else prev0), dev_frames[t]

                    carries[k + 1], outs[k] = sg.run_chunk(
                        carries[k], pair, memo[lo:hi, :, :3], memo[lo:hi, :, 3] > 0.5, det[lo:hi], t_dev[lo:hi],
                        is_kp[lo:hi], is_h[lo:hi],
                    )
                    self.frames_stepped += hi - lo
                packed, det_np = drain_together(torch.cat(outs), det[..., :7])
            out = temporal.unpack_outputs(packed, cfg.tracker.max_tracks)
            flagged = np.flatnonzero(out.need_kp & ~mem_attempted)
            if len(flagged) == 0:
                break
            self._ondemand(flagged, mem_kp, mem_valid, mem_attempted, keypoints_at, timer)
            start = int(flagged[0]) // chunk
        return (lambda: (out, det_np)), carries[n_chunks]

    def _ondemand(self, flagged, mem_kp, mem_valid, mem_attempted, keypoints_at, timer) -> None:
        """An on-demand keypoint round: the flagged frames' model keypoints
        memoized in place."""
        self.ondemand_rounds += 1
        with timer("keypoints"):
            packed = keypoints_at(flagged.tolist())
            mem_kp[flagged] = packed[..., :3]
            mem_valid[flagged] = packed[..., 3] > 0.5
            mem_attempted[flagged] = True

    def _ransac_draws(self, cfg: PipelineConfig):
        """``keys_fn(t)``: frame t's RANSAC keys under the model's seed, on
        its device (:func:`temporal.ransac_draws`)."""
        return temporal.ransac_draws(self.seed, cfg, self.device)

    def _default_keypoint_fn(self, frames_bgr):
        """Compatibility entry (the eval CLI, direct callers), as the JAX
        package's: (B, H, W, 3) uint8 BGR at ORIGINAL resolution ->
        ((B, 57, 3) [x, y, score], (B, 57) valid), tensors on the model's
        device; one :meth:`run_keypoints` call with the identity geometry."""
        frames = np.asarray(frames_bgr)
        h, w = frames.shape[1:3]
        packed = self.run_keypoints(upload_frames(frames, self.device), WorkGeometry(), (int(h), int(w)))
        return packed[..., :3], packed[..., 3] > 0.5

    def _default_detector_fn(self, frames_bgr):
        """Compatibility entry (the eval CLI, direct callers), as the JAX
        package's: (B, H, W, 3) uint8 BGR at ORIGINAL resolution -> numpy
        (boxes (B, D, 4), conf (B, D), cls (B, D) int32, valid (B, D) bool);
        one :meth:`run_detector` call with the identity geometry (one NMS
        launch on the card) and one copy to the host."""
        frames = np.asarray(frames_bgr)
        h, w = frames.shape[1:3]
        rows = self.run_detector(upload_frames(frames, self.device), WorkGeometry(), (int(h), int(w)))
        packed = rows[..., :7].cpu().numpy()
        return packed[..., :4], packed[..., 4], packed[..., 5].astype(np.int32), packed[..., 6] > 0.5

    def _custom_keypoints(self, frames: np.ndarray) -> np.ndarray:
        kp, valid = self._keypoint_fn(frames)
        return np.concatenate([np.asarray(kp, np.float32), np.asarray(valid, np.float32)[..., None]], -1)

    def _custom_detections(self, frames: np.ndarray) -> np.ndarray:
        b, s, c, v = (np.asarray(a) for a in self._detector_fn(frames))
        return np.concatenate(
            [
                b.astype(np.float32),
                s.astype(np.float32)[..., None],
                c.astype(np.float32)[..., None],
                v.astype(np.float32)[..., None],
            ],
            axis=-1,
        )

    def _keypoints_at(self, idx: list[int], frames, dev_frames, geom, img_hw) -> np.ndarray:
        """(len(idx), 57, 4) keypoint rows for the frames ``idx``, in
        batches of ``KP_BATCH`` with a short batch padded by repeating its
        last frame, as the JAX package pads them: the model sees one batch
        shape whatever the clip's length, so a frame's heatmaps do not
        depend on how a stream cuts its blocks."""
        rows = []
        for i in range(0, len(idx), KP_BATCH):
            sel = list(idx[i : i + KP_BATCH])
            real = len(sel)
            sel += sel[-1:] * (KP_BATCH - real)
            if self._custom_kp:
                rows.append(self._custom_keypoints(frames[sel])[:real])
            else:
                rows.append(self.run_keypoints(dev_frames[sel], geom, img_hw)[:real].cpu().numpy())
        return np.concatenate(rows) if rows else np.zeros((0, 57, 4), np.float32)

    # ------------------------------------------------------------------

    def get_coordinates(
        self,
        frames,
        fps: int,
        num_homography: int = 1,
        num_keypoint_detection: int = 1,
        verbose: bool = False,
        calibration: bool = False,
        profile: StageTimer | None = None,
        timer: StageTimer | None = None,
        prescaled: PrescaledClip | None = None,
        _clip_lens: list[int] | None = None,
        _stream_in: dict | None = None,
        _stream_out: bool = False,
    ):
        """{frame_idx: {"Coordinates", "Time", "Keypoints", "Boundaries"}}
        for BGR uint8 frames (N, H, W, 3).  ``calibration`` replaces the
        configuration's ``calibration`` (the JAX package's rule: the
        argument wins, and it defaults to off).  ``profile`` (the JAX
        package's keyword) or ``timer``, not both: a :class:`StageTimer`
        that collects per-stage wall-clock seconds (prescale, detector,
        reid when appearance is on, keypoints, temporal, assembly).
        ``prescaled``: this clip's :meth:`prescale_clip`, made beforehand.

        ``_clip_lens`` is for :class:`~eagle_tpu_torch.pipeline.multiclip.MultiClipRunner`
        with the built-in models: ``frames`` is a list of C clips padded to
        one length L (their last frame repeated), ``_clip_lens`` their real
        lengths, run as one flattened stream: ``t`` counts within the clip
        (the cadences, RANSAC's draws), the carry resets at every clip's
        first frame, pad frames are never sampled, flagged for an
        on-demand round or seeded from, and each clip seeds within its real
        length.  Returns a list of per-clip dicts, each equal to the clip's
        own run.

        ``_stream_in`` / ``_stream_out`` are for :meth:`stream_coordinates`:
        the clip continues a stream whose state ``_stream_in`` holds --
        {"carry": the temporal carry after the previous block, "prev_frame":
        its last device frame, "t": the global index of this clip's first
        frame, "img_hw"} -- and with ``_stream_out`` the call returns
        ``(result, state)``.  Every index the block sees is global: the
        result's keys and "Time", the keypoint and homography cadences and
        each frame's RANSAC draws."""
        if profile is not None and timer is not None:
            raise ValueError("pass profile= or timer=, not both (they are the same StageTimer)")
        timer = profile or timer or StageTimer(self.device)
        t0 = 0 if _stream_in is None else int(_stream_in["t"])
        if _clip_lens is not None:
            if self._custom_kp or self._custom_det:
                raise ValueError("_clip_lens runs the built-in models' path; custom models take MultiClipRunner's clip-batched step")
            if _stream_in is not None or _stream_out or prescaled is not None:
                raise ValueError("streaming and prescaled= are single-clip")
            frames = [np.asarray(c) for c in frames]
            n_clips, L = len(frames), len(frames[0])
            if any(len(c) != L for c in frames) or len(_clip_lens) != n_clips:
                raise ValueError("_clip_lens needs one padded length for every clip and one real length a clip")
            n = n_clips * L
            tt = np.tile(np.arange(L, dtype=np.int64), n_clips)
            first = frames[0]
        else:
            frames = np.asarray(frames)
            n = len(frames)
            tt = np.arange(t0, t0 + n, dtype=np.int64)
            first = frames
        if n == 0:
            empty = {} if _clip_lens is None else []
            return (empty, _stream_in) if _stream_out else empty
        cfg = self.config
        if calibration != cfg.calibration:
            cfg = cfg.replace(calibration=calibration)
        temporal.check_config(cfg)
        img_hw = (int(first.shape[1]), int(first.shape[2]))
        if _stream_in is not None and tuple(_stream_in["img_hw"]) != img_hw:
            raise ValueError(
                f"a stream's blocks must share one resolution: this block is {img_hw[0]}x{img_hw[1]}, "
                f"the stream's {_stream_in['img_hw'][0]}x{_stream_in['img_hw'][1]}"
            )
        geom = self._geometry(img_hw)
        cfg = cfg.replace(work=geom)
        dev = self.device
        kp_interval = max(1, int(fps / max(1, num_keypoint_detection)))
        h_interval = max(1, int(fps / max(1, num_homography)))

        appearance = bool(cfg.tracker.use_appearance)
        with timer("prescale"):
            want = self._prescale_plan(geom, img_hw)
            if prescaled is None:
                prescaled = self._prescale(frames, geom)
            elif (prescaled.mode, prescaled.yuv, prescaled.n) != (*want, n):
                raise ValueError(
                    f"prescaled clip of {prescaled.n} frames as {prescaled.mode!r} (4:2:0 transport "
                    f"{prescaled.yuv}), but this clip needs {n} frames as {want[0]!r} (4:2:0 transport {want[1]})"
                )
            dev_frames = self._upload(prescaled, geom)

        # detections, and their embeddings, a piece at a time (a piece of
        # 1024 ReID crops of 256x128 is ~400 MB in float32)
        det_rows = []
        for i in range(0, n, PIECE):
            if self._custom_det:
                with timer("detector"):
                    rows = torch.from_numpy(self._custom_detections(frames[i : i + PIECE])).to(dev)
                if appearance:
                    with timer("reid"):
                        rows = torch.cat([rows, self.embed(dev_frames[i : i + PIECE], rows[..., :4])], dim=-1)
            else:
                rows = self.run_detector(dev_frames[i : i + PIECE], geom, img_hw, timer)
            det_rows.append(rows)
        det = torch.cat(det_rows)

        sampled = [j for j in range(n) if tt[j] % kp_interval == 0]
        # every attempted frame is memoized, found or not, so a barren
        # frame is never re-detected; pad frames (short clips repeated to
        # L) are never sampled and never flagged for an on-demand round
        mem_attempted = np.zeros((n,), bool)
        if _clip_lens is not None:
            sampled = [j for j in sampled if j % L < _clip_lens[j // L]]
            for ci, ln in enumerate(_clip_lens):
                mem_attempted[ci * L + ln : (ci + 1) * L] = True
        mem_kp = np.zeros((n, 57, 3), np.float32)
        mem_valid = np.zeros((n, 57), bool)
        with timer("keypoints"):
            packed = self._keypoints_at(sampled, frames, dev_frames, geom, img_hw)
            mem_kp[sampled] = packed[..., :3]
            mem_valid[sampled] = packed[..., 3] > 0.5
            mem_attempted[sampled] = True

        # first-frame seeding, per clip: backward flow from the first
        # sampled frame with >= 4 keypoints, searched within the clip's real
        # length, over the frames the JAX package seeds over (on the 4:2:0
        # path OpenCV's decode of the planes, not the device canvas).  A
        # stream's later blocks arrive with a warm carry: only its first
        # block seeds
        if _stream_in is not None:
            spans = []
        elif _clip_lens is None:
            spans = [(0, n)]
        else:
            spans = [(ci * L, ln) for ci, ln in enumerate(_clip_lens)]
        with timer("temporal"):
            self._seed_clips(spans, sampled, mem_kp, mem_valid, cfg,
                             lambda lo, hi: self._seed_frames(prescaled, geom, dev_frames, lo, hi))
            prescaled = None  # seeding was the host copy's last reader
        # the temporal stage with the reference's on-demand keypoint rounds.
        # A stream's block starts from the previous block's carry, and its
        # first frame flows from that block's last frame; the rounds stay
        # inside the block.  Flattened clips restart from init_carry at each
        # clip's first frame, whose previous frame is the stream's previous
        # frame (the JAX package's flattened scan)
        prev0 = dev_frames[0] if _stream_in is None else _stream_in["prev_frame"]
        carry0 = temporal.init_carry(cfg, dev) if _stream_in is None else _stream_in["carry"]
        scan = self._scan_chunks if self._captured_scan(cfg) else self._scan_frames
        drain, carry_n = scan(
            cfg, dev_frames, prev0, carry0, det, tt, kp_interval, h_interval, mem_kp, mem_valid, mem_attempted,
            lambda idx: self._keypoints_at(idx, frames, dev_frames, geom, img_hw), timer, _clip_lens is not None,
        )

        with timer("assembly"):
            out, det_np = drain()
            parts = [(0, n, t0)] if _clip_lens is None else [(ci * L, ln, 0) for ci, ln in enumerate(_clip_lens)]
            res = [
                self._assemble(
                    temporal.FrameOutputs(*(leaf[base : base + ln] for leaf in out)),
                    det_np[base : base + ln, :, :4],
                    det_np[base : base + ln, :, 4],
                    det_np[base : base + ln, :, 5].astype(np.int32),
                    det_np[base : base + ln, :, 6] > 0.5,
                    fps,
                    img_hw,
                    t_offset=off,
                )
                for base, ln, off in parts
            ]
        # the stage totals in seconds, largest first, as the JAX package logs them
        totals = sorted(timer.seconds.items(), key=lambda kv: kv[1], reverse=True)
        log_event("get_coordinates", frames=n, **{k: round(v, 4) for k, v in totals})
        if _clip_lens is not None:
            return res
        if _stream_out:
            # the last frame in a buffer of its own (its clip's buffer is
            # freed), with the clip's row stride: the next block's first
            # flow step reads it in place
            state = {"carry": carry_n, "prev_frame": carry_frame(dev_frames[n - 1]), "t": t0 + n, "img_hw": img_hw}
            return res[0], state
        return res[0]

    def stream_coordinates(
        self,
        segments,
        fps: int,
        num_homography: int = 1,
        num_keypoint_detection: int = 1,
        verbose: bool = False,
        calibration: bool = False,
        prefetch: bool | str = "auto",
        profile: StageTimer | None = None,
        timer: StageTimer | None = None,
    ):
        """:meth:`get_coordinates` of a long stream in bounded memory (e.g.
        :func:`eagle_tpu_torch.io.video.iter_video` over a whole match): one
        block of frames is resident at a time.

        ``segments``: an iterable of (N_i, H, W, 3) uint8 BGR arrays of any
        lengths and one resolution.  Yields ``{global frame index: frame
        dict}`` blocks whose union equals ``get_coordinates`` on the whole
        stream: the temporal carry (keypoints, homography, retry state, the
        tracker) and the previous frame for the flow pass from block to
        block on the device, and the cadences run on the global index.
        Segments are cut and joined into blocks of whole ``chunk_frames``
        multiples, the last block excepted, where the JAX package cuts them.

        Two horizons, as in the JAX package: the backward seed searches the
        first block only, and the on-demand keypoint rounds stay inside the
        block that flags them.

        ``prefetch="auto"``: with a spare CPU core, a worker thread pulls
        the next block from ``segments`` (the decode) and prescales it on
        the host while this block runs on the device.  ``profile`` or
        ``timer`` (not both) accumulates the stages over the blocks."""
        if profile is not None and timer is not None:
            raise ValueError("pass profile= or timer=, not both (they are the same StageTimer)")
        chunk = self.config.chunk_frames
        state: dict | None = None
        buf: np.ndarray | None = None
        timer = profile or timer or StageTimer(self.device)

        def run(block, prescaled=None):
            nonlocal state
            res, state = self.get_coordinates(
                block,
                fps,
                num_homography=num_homography,
                num_keypoint_detection=num_keypoint_detection,
                verbose=verbose,
                calibration=calibration,
                timer=timer,
                prescaled=prescaled,
                _stream_in=state,
                _stream_out=True,
            )
            return res

        def blocks():
            nonlocal buf
            for seg in segments:
                seg = np.asarray(seg)
                if len(seg) == 0:
                    continue
                if buf is not None:
                    seg = np.concatenate([buf, seg])
                    buf = None
                keep = len(seg) % chunk
                if keep == len(seg):
                    buf = seg
                    continue
                if keep:
                    buf = seg[len(seg) - keep :].copy()  # detached from the block
                    seg = seg[: len(seg) - keep]
                yield seg
            if buf is not None and len(buf):
                yield buf

        if prefetch == "auto":
            from eagle_tpu_torch.utils import available_cpus

            prefetch = available_cpus() > 1
        if not prefetch:
            for seg in blocks():
                yield run(seg)
            return

        from concurrent.futures import ThreadPoolExecutor

        it = blocks()

        def pull_next():
            """The next block and its host prescale (the decode runs as the
            worker advances ``segments`` inside ``blocks()``)."""
            nxt = next(it, None)
            return None if nxt is None else (nxt, self.prescale_clip(nxt))

        with ThreadPoolExecutor(max_workers=1) as ex:
            cur = pull_next()
            while cur is not None:
                fut = ex.submit(pull_next)
                seg, pre = cur
                yield run(seg, prescaled=pre)
                cur = fut.result()

    # ------------------------------------------------------------------

    def _assemble(self, out, det_boxes, det_conf, det_cls, det_valid, fps, img_hw, t_offset=0):
        """Per-frame dict assembly in host float64, matching the reference
        output schema (a copy of the JAX package's ``_assemble``)."""
        h_img, w_img = img_hw
        n = len(out.kp_xy)
        class_names = dict(enumerate(self.config.detector.class_names))
        res = {}

        clip_hi = np.array([w_img - 1, h_img - 1, w_img - 1, h_img - 1], np.float32)
        tb_list = np.clip(np.asarray(out.track_boxes), 0.0, clip_hi).astype(int).tolist()
        tid_list = np.asarray(out.track_id).astype(int).tolist()
        tcls_list = np.asarray(out.track_cls).astype(int).tolist()
        tconf_list = np.asarray(out.track_conf).tolist()
        tvalid = np.asarray(out.track_valid, bool)
        db_int = np.asarray(det_boxes).astype(int)  # reference casts pre-clip
        db_list = db_int.tolist()
        db_clipped_list = np.clip(db_int, 0, clip_hi.astype(int)).tolist()
        dconf_list = np.asarray(det_conf).tolist()
        dcls_list = np.asarray(det_cls).tolist()
        det_valid = np.asarray(det_valid, bool)
        ball_mask = det_valid & (np.asarray(det_cls) == 2)
        det_any = det_valid.any(axis=1)
        kp_list = np.asarray(out.kp_xy).astype(int).tolist()
        kp_valid = np.asarray(out.kp_valid, bool)
        H_rows = np.asarray(out.H, np.float64).reshape(n, 9).tolist()
        H_ok_list = np.asarray(out.H_ok, bool).tolist()
        conf_floor = self.detector_conf

        for i in range(n):
            H_ok = H_ok_list[i]
            h00, h01, h02, h10, h11, h12, h20, h21, h22 = H_rows[i]

            def project(x, y):
                d = h20 * x + h21 * y + h22
                return int((h00 * x + h01 * y + h02) / d), int((h10 * x + h11 * y + h12) / d)

            objects = {"Player": {}, "Goalkeeper": {}}
            for k in np.flatnonzero(tvalid[i]):
                cls_name = class_names.get(tcls_list[i][k])
                if cls_name not in objects:
                    continue
                conf = tconf_list[i][k]
                if conf < conf_floor:
                    continue
                x1, y1, x2, y2 = tb_list[i][k]
                objects[cls_name][tid_list[i][k]] = {
                    "BBox": [x1, y1, x2, y2],
                    "Confidence": conf,
                    "Bottom_center": [int((x1 + x2) / 2), y2],
                }

            if not objects["Player"] and not objects["Goalkeeper"] and det_any[i]:
                for d in np.flatnonzero(det_valid[i]):
                    cls_name = class_names.get(dcls_list[i][d])
                    if cls_name not in objects:
                        continue
                    if dconf_list[i][d] < conf_floor:
                        continue
                    x1, y1, x2, y2 = db_clipped_list[i][d]
                    objects[cls_name][int(d)] = {
                        "BBox": [x1, y1, x2, y2],
                        "Confidence": dconf_list[i][d],
                        "Bottom_center": [int((x1 + x2) / 2), y2],
                    }

            ball_idx = np.flatnonzero(ball_mask[i])
            if len(ball_idx) > 0:
                objects["Ball"] = {}
                for bi, d in enumerate(ball_idx):
                    if dconf_list[i][d] < conf_floor:
                        continue
                    box = db_list[i][d]
                    objects["Ball"][bi] = {
                        "BBox": box,
                        "Confidence": dconf_list[i][d],
                        "Bottom_center": [int((box[0] + box[2]) / 2), box[3]],
                    }

            indiv = {}
            for class_name, class_dict in objects.items():
                for obj_id, obj in class_dict.items():
                    bottom_center = obj["Bottom_center"]
                    bbox_coords = [v & 0xFFFF for v in obj["BBox"]]  # uint16 cast
                    conf = obj["Confidence"]
                    if not H_ok:
                        curr = {
                            int(obj_id): {
                                "BBox": bbox_coords,
                                "Confidence": conf,
                                "Transformed_Coordinates": None,
                                "Image_Bottom_center": bottom_center,
                            }
                        }
                    else:
                        tx, ty = project(bottom_center[0], bottom_center[1])
                        if tx < 0 or tx > PITCH_WIDTH or ty < 0 or ty > PITCH_HEIGHT:
                            curr = {
                                int(obj_id): {
                                    "BBox": bbox_coords,
                                    "Confidence": conf,
                                    "Transformed_Coordinates": None,
                                    "Image_Bottom_center": bottom_center,
                                }
                            }
                        else:
                            curr = {
                                int(obj_id): {
                                    "BBox": bbox_coords,
                                    "Confidence": conf,
                                    "Transformed_Coordinates": [tx, ty],
                                }
                            }
                    indiv.setdefault(class_name, {}).update(curr)

            boundaries = [None, None, None, None]
            if H_ok:
                tl = list(project(0, 0))
                tr = list(project(w_img, 0))
                bl = list(project(0, h_img))
                br = list(project(w_img, h_img))
                try:
                    tl2 = (find_x_at_y(tl, bl, PITCH_HEIGHT), PITCH_HEIGHT)
                    tr2 = (find_x_at_y(tr, br, PITCH_HEIGHT), PITCH_HEIGHT)
                    bl2 = (find_x_at_y(bl, tl2, 0), 0)
                    br2 = (find_x_at_y(br, tr2, 0), 0)
                    boundaries = [bl2, tl2, tr2, br2]
                except ZeroDivisionError:
                    pass

            kp_row = kp_list[i]
            kps = {
                pitch.KEYPOINT_NAMES[k]: (kp_row[k][0], kp_row[k][1])
                for k in np.flatnonzero(kp_valid[i])
            }

            gi = t_offset + i
            res[gi] = {
                "Coordinates": indiv,
                "Time": f"{gi // fps // 60:02d}:{gi // fps % 60:02d}",
                "Keypoints": kps,
                "Boundaries": boundaries,
            }
        return res
