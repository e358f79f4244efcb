"""CoordinateModel: the public perception API (PyTorch counterpart of
``eagle_tpu/pipeline/coordinate_model.py``).

``CoordinateModel(...).get_coordinates(frames, fps)`` returns, per frame,
the tracked players with pitch coordinates, the ball, the pitch keypoints
and the visible-pitch boundaries, with the reference's output schema.  The
path, one-shot and single-clip:

- host prescale: every frame is letterboxed once on the host to the
  detector's working canvas (544x960 for 720p) as packed 4:2:0 planes
  (native C++), uploaded, and rebuilt as BGR on the card (BT.601 inverse);
- the detector (YOLOv8 + class-aware NMS) on every frame, in batches of
  ``PIECE``, and with ``TrackerConfig.use_appearance`` the appearance
  embeddings of the first ``reid_slots`` detections of each frame (OSNet
  or the HSV histogram); the keypoint model (HRNet-W48 + heatmap decode)
  on the cadence frames, in batches of ``KP_BATCH``;
- first-frame seeding by backward flow, then the temporal step frame by
  frame (:mod:`eagle_tpu_torch.pipeline.temporal`), with the reference's
  on-demand keypoint rounds (at most 3);
- the float64 host assembly of the output dicts.

Models: the built-in HRNet / YOLOv8 (seeded random weights, or the JAX
package's parameter pytrees through ``keypoint_params=`` /
``detector_params=``), or injected callables ``keypoint_fn`` /
``detector_fn``, which receive original-resolution frames (and force the
identity geometry).  The ReID OSNet-x0.25: a torchreid state dict
(``reid_checkpoint=``, ``.pt`` / ``.pth``), a JAX pytree
(``reid_params=``), or a seeded random init (with a warning).
``TrackerConfig.use_appearance=None`` means on exactly when ReID weights
are given.

The entry point runs on the CUDA card unless the caller passes
``device="cpu"``; with no card it raises.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Callable

import numpy as np
import torch

from eagle_tpu_torch import pitch
from eagle_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig, WorkGeometry
from eagle_tpu_torch.models.bridge import hrnet_from_jax, osnet_from_jax, yolov8_from_jax
from eagle_tpu_torch.models.hrnet import init_hrnet
from eagle_tpu_torch.models.osnet import OSNet, embed_boxes, init_osnet, osnet_from_torch
from eagle_tpu_torch.models.yolov8 import CONFIG_VARIANTS, init_yolov8
from eagle_tpu_torch.ops.embed import HIST_BINS, histogram_embeddings
from eagle_tpu_torch.ops.heatmap import decode_heatmaps
from eagle_tpu_torch.ops.homography import ransac_gumbel
from eagle_tpu_torch.ops.nms import batched_nms
from eagle_tpu_torch.ops.optical_flow import upload_frames
from eagle_tpu_torch.ops.preprocess import (
    compute_work_geometry,
    host_letterbox_i420,
    i420_to_bgr,
    i420_to_bgr_exact,
    letterbox,
    normalize_imagenet,
    preprocess_keypoint,
    resize_bilinear,
    resolve_upload_format,
)
from eagle_tpu_torch.pipeline import temporal

PITCH_WIDTH = 105
PITCH_HEIGHT = 68

#: frames per detector batch
PIECE = 16
#: keypoint-model batch
KP_BATCH = 8
#: on-demand keypoint rounds (the reference's cap)
ONDEMAND_ROUNDS = 3


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
    can attribute device time to the stages."""

    def __init__(self, device: torch.device, sync: bool = False):
        self.device = device
        self.sync = sync
        self.seconds: dict[str, float] = {}

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
                self.range.__exit__(*exc)

        return _Span()

    def report(self) -> str:
        """JSON of the stages' milliseconds, in the order they first ran."""
        return json.dumps({k: round(v * 1e3, 3) for k, v in self.seconds.items()}, indent=2)


def _reid_model(cfg: PipelineConfig, reid_params=None, reid_checkpoint: str | None = None, seed: int = 0):
    """The appearance slot's OSNet (on the CPU), or None when the config
    embeds nothing or with the histogram.  Checks the embedder, that given
    weights will be used, and that the feature width is ``embed_dim``.
    Weights: a torchreid state dict (``.pt`` / ``.pth``), a JAX pytree, or a
    seeded random init with a warning."""
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
    if reid_checkpoint is not None:
        if reid_checkpoint.endswith(".msgpack"):
            raise NotImplementedError(
                "reid_checkpoint: .msgpack checkpoints are not loadable yet (ROADMAP.md Queue 1, item 3, "
                "checkpoint loaders); pass a torchreid .pt / .pth state dict"
            )
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
        keypoint_fn: Callable | None = None,
        detector_fn: Callable | None = None,
        reid_params=None,
        reid_checkpoint: str | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        cfg = config or DEFAULT_CONFIG
        if cfg.tracker.use_appearance is None:
            # "follow the weights": ReID is on exactly when weights are given
            given = reid_checkpoint is not None or reid_params is not None
            cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, use_appearance=given))
        temporal.check_config(cfg)
        reid = _reid_model(cfg, reid_params, reid_checkpoint, seed)
        self.config = cfg
        self.device = resolve_device(device)
        #: the appearance slot's OSNet (None with the histogram or no ReID)
        self.reid_model: OSNet | None = None if reid is None else reid.to(self.device).eval()
        self.keypoint_conf = keypoint_conf
        self.detector_conf = detector_conf
        self.seed = seed
        #: temporal steps run (observability and tests)
        self.frames_stepped = 0

        self._custom_kp = keypoint_fn is not None
        self._keypoint_fn = keypoint_fn
        self.keypoint_model = None
        if keypoint_fn is None:
            kcfg = cfg.keypoint
            if keypoint_params is not None:
                model = hrnet_from_jax(keypoint_params, use_bf16=kcfg.use_bf16)
            else:
                model = init_hrnet(seed, kcfg.num_keypoints, use_bf16=kcfg.use_bf16)
            self.keypoint_model = model.to(self.device).eval()

        self._custom_det = detector_fn is not None
        self._detector_fn = detector_fn
        self.detector_model = None
        if detector_fn is None:
            dcfg = cfg.detector
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
        16 bytes on the card: :func:`upload_frames`)."""
        return self._upload(frames, geom)[0]

    def _upload(self, frames: np.ndarray, geom: WorkGeometry) -> tuple[torch.Tensor, torch.Tensor | None]:
        """:meth:`upload`, plus the uploaded packed 4:2:0 planes on the
        working path (None otherwise)."""
        fmt = resolve_upload_format(self.config.upload_format, geom.enabled)
        if self.config.prescale != "host":
            raise NotImplementedError("only the host prescale is ported (PipelineConfig.prescale)")
        if geom.enabled:
            if fmt != "yuv420":
                raise NotImplementedError(
                    "the working-resolution path ships 4:2:0 planes; upload_format='bgr' "
                    "with a working geometry (a cv2 letterbox) is not ported"
                )
            planes = torch.from_numpy(host_letterbox_i420(frames, geom)).to(self.device)
            return i420_to_bgr(planes), planes
        if fmt == "yuv420":
            raise NotImplementedError("4:2:0 transport of raw-resolution frames is not ported")
        return upload_frames(frames, self.device), None

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
        h, w = img_hw
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
            dev = b.device
            pad4 = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=torch.float32, device=dev)
            gain_t = torch.tensor(gain, dtype=torch.float32, device=dev)
            b = (b - pad4) / gain_t
            hi = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32, device=dev)
            b = torch.minimum(torch.clamp(b, min=0.0), hi)
            rows = torch.cat(
                [b, s[..., None], c.to(torch.float32)[..., None], v.to(torch.float32)[..., None]], dim=-1
            )
        if self.config.tracker.use_appearance:
            with timer("reid"):
                rows = torch.cat([rows, self.embed(x, b * gain_t + pad4 if geom.enabled else b)], dim=-1)
        return rows

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
        """(len(idx), 57, 4) keypoint rows for the frames ``idx``."""
        rows = []
        for i in range(0, len(idx), KP_BATCH):
            sel = idx[i : i + KP_BATCH]
            if self._custom_kp:
                rows.append(self._custom_keypoints(frames[sel]))
            else:
                rows.append(self.run_keypoints(dev_frames[sel], geom, img_hw).cpu().numpy())
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
        timer: StageTimer | None = None,
    ) -> dict:
        """{frame_idx: {"Coordinates", "Time", "Keypoints", "Boundaries"}}
        for BGR uint8 frames (N, H, W, 3).  ``timer`` (optional) collects
        per-stage wall-clock seconds (prescale, detector, reid when
        appearance is on, keypoints, temporal, assembly)."""
        timer = timer or StageTimer(self.device)
        frames = np.asarray(frames)
        n = len(frames)
        if n == 0:
            return {}
        cfg = self.config
        if calibration:
            cfg = cfg.replace(calibration=True)
        temporal.check_config(cfg)
        img_hw = (int(frames.shape[1]), int(frames.shape[2]))
        geom = self._geometry(img_hw)
        cfg = cfg.replace(work=geom)
        dev = self.device
        kp_interval = max(1, int(fps / max(1, num_keypoint_detection)))
        h_interval = max(1, int(fps / max(1, num_homography)))

        appearance = bool(cfg.tracker.use_appearance)
        with timer("prescale"):
            dev_frames = planes = None
            if not (self._custom_kp and self._custom_det) or appearance:
                dev_frames, planes = self._upload(frames, geom)

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

        sampled = list(range(0, n, kp_interval))
        mem_kp = np.zeros((n, 57, 3), np.float32)
        mem_valid = np.zeros((n, 57), bool)
        # every attempted frame is memoized, found or not, so a barren
        # frame is never re-detected
        mem_attempted = np.zeros((n,), bool)
        with timer("keypoints"):
            packed = self._keypoints_at(sampled, frames, dev_frames, geom, img_hw)
            mem_kp[sampled] = packed[..., :3]
            mem_valid[sampled] = packed[..., 3] > 0.5
            mem_attempted[sampled] = True

        # canvas frames for the temporal step (the raw frames on the
        # identity geometry, uploaded here when both models are injected)
        with timer("prescale"):
            if dev_frames is None:
                dev_frames = upload_frames(frames, dev)

        # first-frame seeding: backward flow from the first sampled frame
        # with >= 4 keypoints.  On the 4:2:0 path the reference flows over
        # OpenCV's decode of the planes (its host copies), not over the
        # device canvas, so the planes are decoded here as OpenCV does
        with timer("temporal"):
            if mem_valid[0].sum() < 4:
                found = next((j for j in sampled if mem_valid[j].sum() >= 4), None)
                if found:
                    seed_frames = dev_frames[: found + 1]
                    if planes is not None:
                        seed_frames = i420_to_bgr_exact(planes[: found + 1])
                    seed_xy, seed_ok = temporal.backward_seed(
                        seed_frames,
                        torch.from_numpy(mem_kp[found, :, :2]).to(dev),
                        torch.from_numpy(mem_valid[found]).to(dev),
                        cfg,
                    )
                    seed_xy, seed_ok = seed_xy.cpu().numpy(), seed_ok.cpu().numpy()
                    for j in range(found):  # memoized entries win per label
                        take = seed_ok[j] & ~mem_valid[j]
                        mem_kp[j, take, :2] = seed_xy[j, take]
                        mem_valid[j] |= seed_ok[j]
            planes = None  # seeding was the planes' last reader

        gumbel_cache: dict[int, torch.Tensor] = {}

        def gumbel_fn(t: int) -> torch.Tensor:
            if t not in gumbel_cache:
                g = ransac_gumbel(self.seed, t, cfg.homography.ransac_iters, 57)
                gumbel_cache[t] = torch.from_numpy(g).to(dev)
            return gumbel_cache[t]

        # the temporal step, frame by frame, with per-frame carry
        # checkpoints: when the reference's on-demand keypoint detection
        # would fire (flow collapse on a non-cadence frame with no memo),
        # the flagged frames get model keypoints and the loop resumes at the
        # first of them
        carries = [temporal.init_carry(cfg, dev)] + [None] * n
        outs: list = [None] * n
        start = 0
        for _round in range(ONDEMAND_ROUNDS):
            with timer("temporal"):
                mk = torch.from_numpy(mem_kp).to(dev)
                mv = torch.from_numpy(mem_valid).to(dev)
                for t in range(start, n):
                    xs = temporal.FrameInputs(
                        frame_bgr=dev_frames[t],
                        prev_frame_bgr=dev_frames[max(t - 1, 0)],
                        model_kp=mk[t],
                        model_kp_valid=mv[t],
                        is_kp_frame=t % kp_interval == 0,
                        is_h_frame=t % h_interval == 0,
                        det_boxes=det[t, :, :4],
                        det_conf=det[t, :, 4],
                        det_cls=det[t, :, 5].to(torch.int64),
                        det_valid=det[t, :, 6] > 0.5,
                        t=t,
                        det_embed=det[t, :, 7:] if appearance else None,
                    )
                    carries[t + 1], outs[t] = temporal.temporal_step(carries[t], xs, cfg, gumbel_fn)
                    self.frames_stepped += 1
                need = torch.stack([o.need_kp for o in outs]).cpu().numpy()
            flagged = np.flatnonzero(need & ~mem_attempted)
            if len(flagged) == 0:
                break
            with timer("keypoints"):
                packed = self._keypoints_at(flagged.tolist(), frames, dev_frames, geom, img_hw)
                mem_kp[flagged] = packed[..., :3]
                mem_valid[flagged] = packed[..., 3] > 0.5
                mem_attempted[flagged] = True
            start = int(flagged[0])

        with timer("assembly"):
            out = temporal.FrameOutputs(
                *(torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(len(outs[0])))
            )
            det_np = det[..., :7].cpu().numpy()
            res = self._assemble(
                out,
                det_np[..., :4],
                det_np[..., 4],
                det_np[..., 5].astype(np.int32),
                det_np[..., 6] > 0.5,
                fps,
                img_hw,
            )
        return res

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
