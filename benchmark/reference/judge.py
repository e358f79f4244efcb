"""The comparisons that decide ``correct`` (plain PyTorch and NumPy; imports
nothing of the program).

- ``detector_gap`` / ``keypoint_gap``: the program's real bfloat16
  forwards, sampled from the window, against the float32 reference (TF32
  off) on the same raw frames and weights, each input worked out again by
  :mod:`benchmark.reference.preprocess`.  A gap is the RMS of the
  difference over the RMS spread of the reference's output: for the
  detector the larger of its box sides (each box minus its anchor centre,
  the part the network computes) and its class scores; for the keypoint
  network its heatmaps.
- ``reid_gap`` (configurations with an appearance network): the
  program's real embeddings of the sampled embed calls, each slot it
  embedded, against the float32 OSNet (TF32 off) on the crops of the same
  boxes, the crops worked out again from the raw frames
  (:func:`benchmark.reference.preprocess.reid_input`); the gap over the
  spread of the reference's embeddings.
- ``pitch_gap_mean_m``: every tracked object's pitch position the entry
  yielded in the window, judged against the homography that the injected
  keypoints determine (:func:`fit_homography`, float64): the distance in
  metres from that homography's projection of the object's own image foot
  point (its box's bottom centre) to the set of points that truncate to
  the integer metres the program printed (for an object printed off the
  pitch, to the set that truncates off it), averaged over the objects.
  The largest such distance is printed beside it; between fresh keypoint
  frames the program flows the keypoints, and the drift moves a few
  frames' homography by up to ~0.2 m, so the largest gap does not stand
  three times clear of the control's.
- ``track_miss_share``: the share of tracked players whose box overlaps no
  true player's box of its frame at IoU 0.5 or more (precision).
- ``object_miss_share``: the share of the true players and balls in view
  in every frame handed in whose box no printed box of its kind matches at
  IoU 0.5 or more, one to one, largest overlap first; a frame missing from
  the program's output counts all of its objects as missed (recall).
- ``table_miss_share`` (cells that run the Processor): the same over the
  Processor's long-format records (``format_data``) of each segment, each
  row placed at its frame by the table's index: a true object is found
  when one record of its kind lies within ``TOL_PX`` pixels of its image
  foot point and, on the pitch, within ``TOL_M`` metres of its true pitch
  position; a frame with no record counts all of its objects as missed.
- ``team_error_share`` (the same cells): each tracked player id of a
  segment stands for the true player its boxes match in most frames; the
  share of those ids (seen in at least half the segment's frames) whose
  team in ``team_mapping`` differs from the truth's, under the better of
  the two ways to name the teams.  An id with no team counts as wrong when
  the Processor's rule gave it a crop to vote with (:func:`votable`); one
  hidden behind another player in every frame gets no team by that rule.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import hrnet, osnet, preprocess, yolov8
from benchmark.reference.ops import Ops

#: frames a reference forward takes at once (memory, not arithmetic)
CHUNK = 4
PITCH_LENGTH, PITCH_WIDTH = 105, 68
IOU_MATCH = 0.5
#: a record's image foot point against the truth's: a few pixels of the
#: tracker's smoothing, far under a player's width
TOL_PX = 8.0
#: a record's pitch position against the truth's: the truncation to whole
#: metres (up to 1 m an axis) and the smoothing's pixels
TOL_M = 2.0
#: the Processor's published rule for a team-vote crop (reference
#: ``processor.py``): a player box covered by another player's box by at
#: most this share of its area, and at least ``MIN_CROP_AREA`` px
MAX_CROP_OVERLAP = 0.35
MIN_CROP_AREA = 4


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's convolutions and products."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    spread = (ref - ref.mean()).pow(2).mean().sqrt()
    return float((prog.double() - ref).pow(2).mean().sqrt() / spread)


class Networks:
    """The plain networks of a configuration on ``device`` (the appearance
    network where ``reid_sd`` is given), fed raw frames; ``precision``
    "fp32" is the reference, "fp8" the control."""

    def __init__(self, cfg: dict, det_sd: dict, kp_sd: dict, frame_hw, device, precision: str = "fp32",
                 reid_sd: dict | None = None):
        ops = Ops(precision)
        self.det_cfg, self.kp_cfg, self.reid_cfg = cfg["detector"], cfg["keypoints"], cfg.get("reid")
        self.size = cfg["program"]["detector"]["image_size"]
        self.geom = preprocess.geometry(frame_hw, self.size, self.kp_cfg["input_hw"])
        self.det = yolov8.YOLOv8({k: v.to(device) for k, v in det_sd.items()}, self.det_cfg, ops)
        self.kp = hrnet.HRNet({k: v.to(device) for k, v in kp_sd.items()}, self.kp_cfg, ops)
        self.reid = None
        if reid_sd is not None:
            self.reid = osnet.OSNet({k: v.to(device) for k, v in reid_sd.items()}, self.reid_cfg, ops)
        self.device = device

    def detector_input_hw(self) -> tuple[int, int]:
        g = self.geom
        return (g["canvas_h"], g["canvas_w"]) if g is not None else (self.size, self.size)

    @torch.no_grad()
    def detect(self, frames: np.ndarray):
        outs = []
        with float32_exact():
            for i in range(0, len(frames), CHUNK):
                x = torch.from_numpy(np.ascontiguousarray(frames[i : i + CHUNK])).to(self.device)
                outs.append(self.det(preprocess.detector_input(x, self.size, self.geom)))
        return torch.cat([b for b, _ in outs]), torch.cat([s for _, s in outs])

    @torch.no_grad()
    def heatmaps(self, frames: np.ndarray):
        outs = []
        with float32_exact():
            for i in range(0, len(frames), CHUNK):
                x = torch.from_numpy(np.ascontiguousarray(frames[i : i + CHUNK])).to(self.device)
                outs.append(self.kp(preprocess.keypoint_input(x, self.kp_cfg["input_hw"], self.geom)))
        return torch.cat(outs)

    @torch.no_grad()
    def embed(self, frames: np.ndarray, boxes: torch.Tensor) -> torch.Tensor:
        """(N, K, E) embeddings of the crops at ``boxes`` (N, K, 4), given in
        the pixels of the frames the program crops from: the working canvas
        of the raw ``frames`` where the cell has one, else the frames."""
        outs = []
        with float32_exact():
            for i in range(0, len(frames), CHUNK):
                x = torch.from_numpy(np.ascontiguousarray(frames[i : i + CHUNK])).to(self.device)
                pix = preprocess.working_canvas(x, self.geom) if self.geom is not None else x
                b = boxes[i : i + CHUNK].to(self.device)
                y = self.reid(preprocess.reid_input(pix, b, self.reid_cfg["input_hw"]))
                outs.append(y.view(*b.shape[:2], -1))
        return torch.cat(outs)


def reid_gap(nets: Networks, prog_embeddings, frames: np.ndarray, boxes, ref=None) -> float:
    """The gap of one embed call's embeddings (N, K, E) of the crops at
    ``boxes``; ``ref`` the reference's when already computed."""
    emb = ref if ref is not None else nets.embed(frames, boxes)
    return _gap(prog_embeddings.to(emb.device), emb)


def detector_gap(nets: Networks, prog_boxes, prog_scores, frames: np.ndarray, ref=None) -> float:
    """The gap of one detector call's outputs; ``ref`` the reference's
    (boxes, scores) when already computed."""
    boxes, scores = ref if ref is not None else nets.detect(frames)
    anchors = yolov8.anchor_points(nets.detector_input_hw(), boxes.device)
    return max(_gap(prog_boxes.to(boxes.device) - anchors, boxes - anchors), _gap(prog_scores.to(scores.device), scores))


def keypoint_gap(nets: Networks, prog_heatmaps, frames: np.ndarray, ref=None) -> float:
    hm = ref if ref is not None else nets.heatmaps(frames)
    return _gap(prog_heatmaps.to(hm.device), hm)


def fit_homography(img: np.ndarray, world: np.ndarray, steps: int = 50) -> np.ndarray:
    """The image -> pitch homography of the correspondences ``img`` ->
    ``world`` (N, 2) that minimises the squared transfer error in pitch
    metres, in float64: a normalised DLT, then Gauss-Newton on the 8 free
    entries (h22 = 1) until it stops improving."""

    def norm(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / np.mean(np.linalg.norm(p - c, axis=1))
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])

    ts, td = norm(img), norm(world)
    a = np.concatenate([img, np.ones((len(img), 1))], 1) @ ts.T
    b = np.concatenate([world, np.ones((len(world), 1))], 1) @ td.T
    rows = []
    for (x, y, _), (u, v, _) in zip(a, b):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    h = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 3)
    H = np.linalg.inv(td) @ h @ ts
    h8 = (H / H[2, 2]).reshape(-1)[:8]
    x, y = img[:, 0], img[:, 1]

    def residual(h):
        q = h[6] * x + h[7] * y + 1.0
        return np.concatenate([(h[0] * x + h[1] * y + h[2]) / q - world[:, 0],
                               (h[3] * x + h[4] * y + h[5]) / q - world[:, 1]])

    for _ in range(steps):
        r = residual(h8)
        q = h8[6] * x + h8[7] * y + 1.0
        pu, pv = (h8[0] * x + h8[1] * y + h8[2]) / q, (h8[3] * x + h8[4] * y + h8[5]) / q
        z = np.zeros_like(x)
        ju = np.stack([x / q, y / q, 1 / q, z, z, z, -pu * x / q, -pu * y / q], 1)
        jv = np.stack([z, z, z, x / q, y / q, 1 / q, -pv * x / q, -pv * y / q], 1)
        j = np.concatenate([ju, jv])
        step = np.linalg.lstsq(j, r, rcond=None)[0]
        if np.sum(residual(h8 - step) ** 2) >= np.sum(r**2):
            break
        h8 = h8 - step
    return np.append(h8, 1.0).reshape(3, 3)


def _project(H: np.ndarray, x: float, y: float) -> tuple[float, float]:
    d = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    return (H[0, 0] * x + H[0, 1] * y + H[0, 2]) / d, (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / d


def _to_cell(v: float, k: int) -> float:
    """Distance from ``v`` to the reals that Python's ``int`` truncates to
    ``k``."""
    lo, hi = (k, k + 1) if k > 0 else ((k - 1, k) if k < 0 else (-1, 1))
    return max(0.0, lo - v, v - hi)


def _off_pitch_depth(x: float, y: float) -> float:
    """How far (x, y) lies inside the region whose truncation is on the
    pitch, (-1, 106) x (-1, 69): 0 when outside it."""
    return max(0.0, min(x + 1, PITCH_LENGTH + 1 - x, y + 1, PITCH_WIDTH + 1 - y))


def project_bf16(H: np.ndarray, x: float, y: float) -> list[int] | None:
    """The control's pitch position: the projection computed in bfloat16
    (the precision below the float32 the program's geometry states) and
    truncated as the program truncates, or None off the pitch."""
    b = lambda v: torch.tensor(v, dtype=torch.bfloat16)  # noqa: E731
    h = torch.tensor(H, dtype=torch.bfloat16)
    d = h[2, 0] * b(x) + h[2, 1] * b(y) + h[2, 2]
    tx = int(float((h[0, 0] * b(x) + h[0, 1] * b(y) + h[0, 2]) / d))
    ty = int(float((h[1, 0] * b(x) + h[1, 1] * b(y) + h[1, 2]) / d))
    return [tx, ty] if 0 <= tx <= PITCH_LENGTH and 0 <= ty <= PITCH_WIDTH else None


def pitch_gaps_m(frames: list, control: bool = False) -> tuple[float, float, int]:
    """(the mean gap in metres, the largest, objects judged) over
    ``frames``: (frame dict, image->pitch homography).  ``control``: judge
    the bfloat16 projection of each object's foot point in place of the
    program's position."""
    worst, total, n = 0.0, 0.0, 0
    for fr, H in frames:
        for cls in ("Player", "Goalkeeper"):
            for obj in fr["Coordinates"].get(cls, {}).values():
                x1, y1, x2, y2 = obj["BBox"]
                px, py = _project(H, int((x1 + x2) / 2), y2)
                xy = project_bf16(H, int((x1 + x2) / 2), y2) if control else obj.get("Transformed_Coordinates")
                if xy is None:
                    gap = _off_pitch_depth(px, py)
                else:
                    gap = float(np.hypot(_to_cell(px, xy[0]), _to_cell(py, xy[1])))
                worst = max(worst, gap)
                total += gap
                n += 1
    return (total / n if n else float("inf")), worst, n


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box ``a`` (4,) with each of ``b`` (M, 4)."""
    ix = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0, None)
    iy = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0, None)
    inter = ix * iy
    area = lambda r: (r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1])  # noqa: E731
    return inter / np.maximum(area(a) + area(b) - inter, 1e-9)


def track_miss_share(frames: list, img_hw) -> tuple[float, int]:
    """(share of tracked players matching no true box, players judged) over
    ``frames``: (frame dict, (P, 4) true boxes of the frame)."""
    h, w = img_hw
    hi = np.array([w - 1, h - 1, w - 1, h - 1], np.float64)
    miss = n = 0
    for fr, truth in frames:
        t = np.clip(np.asarray(truth, np.float64), 0, hi)
        for cls in ("Player", "Goalkeeper"):
            for obj in fr["Coordinates"].get(cls, {}).values():
                n += 1
                miss += bool(_iou(np.asarray(obj["BBox"], np.float64), t).max(initial=0.0) < IOU_MATCH)
    return (float(miss) / n if n else 1.0), n


def _in_view(xy, img_hw) -> bool:
    h, w = img_hw
    return 0 <= xy[0] < w and 0 <= xy[1] < h


def ball_box(xy) -> np.ndarray:
    """The true ball's box as the scene's truth rows draw it (its bottom
    centre at the ball's image position)."""
    return np.array([xy[0] - 5, xy[1] - 10, xy[0] + 5, xy[1]], np.float64)


def _greedy(score: np.ndarray, ok: np.ndarray) -> dict:
    """One-to-one matches (row -> column) of the pairs ``ok``, the largest
    ``score`` first."""
    pairs = sorted(zip(*np.nonzero(ok)), key=lambda rc: -score[rc])
    rows, cols, out = set(), set(), {}
    for r, c in pairs:
        if r not in rows and c not in cols:
            rows.add(r)
            cols.add(c)
            out[int(r)] = int(c)
    return out


def match_players(fr: dict, truth: np.ndarray, img_hw) -> dict:
    """{tracked player id: true player index} of one frame, at IoU 0.5 or
    more, one to one."""
    h, w = img_hw
    hi = np.array([w - 1, h - 1, w - 1, h - 1], np.float64)
    t = np.clip(np.asarray(truth, np.float64), 0, hi)
    ids, boxes = [], []
    for cls in ("Player", "Goalkeeper"):
        for oid, obj in fr["Coordinates"].get(cls, {}).items():
            ids.append(oid)
            boxes.append(obj["BBox"])
    if not ids:
        return {}
    iou = np.stack([_iou(np.asarray(b, np.float64), t) for b in boxes])
    return {ids[r]: c for r, c in _greedy(iou, iou >= IOU_MATCH).items()}


def object_miss_share(frames: list, img_hw) -> tuple[float, int]:
    """(share of the true objects in view that no printed box matches,
    objects judged) over ``frames``: (frame dict, or None where the output
    lacks the frame; (P, 4) true player boxes; (2,) true ball image
    position)."""
    miss = n = 0
    for fr, players, ball in frames:
        seen = [p for p in range(len(players)) if _in_view(((players[p][0] + players[p][2]) / 2, players[p][3]), img_hw)]
        has_ball = _in_view(ball, img_hw)
        n += len(seen) + has_ball
        if fr is None:
            miss += len(seen) + has_ball
            continue
        found = set(match_players(fr, players, img_hw).values())
        miss += sum(p not in found for p in seen)
        if has_ball:
            tb = ball_box(ball)
            balls = [obj["BBox"] for obj in fr["Coordinates"].get("Ball", {}).values()]
            miss += not any(_iou(tb, np.asarray([b], np.float64))[0] >= IOU_MATCH for b in balls)
    return (float(miss) / n if n else 1.0), n


def _cells(items: list) -> dict:
    """{(ID, Type): (x, y)} of one record's entity list, the ball as
    ("Ball", None); NaN or missing cells left out."""
    out = {}
    for it in items:
        xy = it.get("Coordinates")
        if xy is None or (isinstance(xy, float) and np.isnan(xy)):
            continue
        xy = np.asarray(xy, np.float64).reshape(-1)
        if xy.size == 2 and np.isfinite(xy).all():
            out[(it["ID"], it.get("Type"))] = xy
    return out


def table_miss_share(segments: list, img_hw) -> tuple[float, int]:
    """(share of the true objects in view that no Processor record finds,
    objects judged) over ``segments``: (records by frame of the segment,
    None where the table has no row for it; per frame (true feet (P, 2),
    true pitch positions (P, 2), ball image (2,), ball pitch (2,)))."""
    miss = n = 0
    for records, truth in segments:
        for rec, (feet, world, ball_img, ball_world) in zip(records, truth):
            objs = [(feet[p], world[p], False) for p in range(len(feet)) if _in_view(feet[p], img_hw)]
            if _in_view(ball_img, img_hw):
                objs.append((ball_img, ball_world, True))
            n += len(objs)
            if rec is None:
                miss += len(objs)
                continue
            video, pitch_xy = _cells(rec["Coordinates_video"]), _cells(rec["Coordinates"])
            keys = list(video)
            if not keys:
                miss += len(objs)
                continue
            score = np.full((len(objs), len(keys)), -np.inf)
            for i, (foot, pos, is_ball) in enumerate(objs):
                for j, key in enumerate(keys):
                    if (key[0] == "Ball") != is_ball or key not in pitch_xy:
                        continue
                    d = float(np.hypot(*(video[key] - foot)))
                    if d <= TOL_PX and float(np.hypot(*(pitch_xy[key] - pos))) <= TOL_M:
                        score[i, j] = -d
            miss += len(objs) - len(_greedy(score, np.isfinite(score)))
    return (float(miss) / n if n else 1.0), n


def votable(frames: list) -> set:
    """The tracked player ids that the Processor's rule gives at least one
    crop to vote with: a box of positive area, at least ``MIN_CROP_AREA``
    px, covered by no other player's box (one with identical coordinates
    aside) by more than ``MAX_CROP_OVERLAP`` of its area."""
    out = set()
    for fr in frames:
        players = fr["Coordinates"].get("Player", {}) if fr is not None else {}
        if not players:
            continue
        ids = list(players)
        b = np.asarray([players[i]["BBox"] for i in ids], np.float64)
        size = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        ox = np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0])
        oy = np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1])
        inter = np.maximum(ox, 0) * np.maximum(oy, 0)
        inter[(b[:, None, :] == b[None, :, :]).all(-1)] = 0.0
        cover = inter.max(1)
        for k, oid in enumerate(ids):
            if size[k] >= MIN_CROP_AREA and cover[k] <= MAX_CROP_OVERLAP * size[k]:
                out.add(oid)
    return out


def team_error_share(segments: list, img_hw) -> tuple[float, int]:
    """(share of the judged tracked ids on the wrong team, ids judged) over
    ``segments``: (the segment's frame dicts, its true player boxes (F, P,
    4), the true teams (P,), the Processor's ``team_mapping``)."""
    wrong = n = 0
    for frames, boxes, teams, mapping in segments:
        votes: dict = {}
        for fr, truth in zip(frames, boxes):
            if fr is None:
                continue
            for oid, p in match_players(fr, truth, img_hw).items():
                votes.setdefault(oid, []).append(p)
        ids = [oid for oid, ps in votes.items() if 2 * len(ps) >= len(frames)]
        if not ids:
            continue
        truth_team = [int(teams[max(set(votes[oid]), key=votes[oid].count)]) for oid in ids]
        got = [mapping.get(oid, mapping.get(int(oid))) for oid in ids]
        can = votable(frames)
        errs = [sum((int(g) != (t if swap == 0 else 1 - t)) if g is not None else (oid in can)
                    for oid, g, t in zip(ids, got, truth_team)) for swap in (0, 1)]
        wrong += min(errs)
        n += len(ids)
    return (float(wrong) / n if n else 1.0), n
