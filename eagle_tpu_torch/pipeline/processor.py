"""Processor: post-processing from the per-frame coordinates of
``CoordinateModel.get_coordinates`` to analysis-ready tables (PyTorch
counterpart of ``eagle_tpu/pipeline/processor.py``, without pandas).

Stages (:meth:`Processor.process_data`):
  1. the wide table, one row per frame with a person detection, one
     column per object id, plus the ball picked among its candidates by a
     constant-velocity Kalman filter (image coordinates gate the pitch
     coordinates);
  2. team assignment by jersey-colour votes: every eligible player crop is
     cut and resampled on the host, then clustered and counted in one
     batched pass on the Processor's device (:mod:`eagle_tpu_torch.ops.kmeans`);
  3. goalkeeper / player id unification and track-fragment merging;
  4. per-column linear interpolation (and optional smoothing).

In place of the DataFrame the port keeps a :class:`Table`: an int frame
index and ordered object columns whose cells are (x, y) tuples or lists,
or missing (NaN, or None for a frame without a homography).  Each step
reproduces the pandas semantics the JAX package relies on
(``combine_first``, ``first_valid_index`` / ``last_valid_index``,
``notna`` for the coverage drop, linear ``interpolate``), and
``Table.records()`` gives what ``DataFrame.to_dict("records")`` would.

The fragment merge is the intended one (the reference's own overlap test
is a tautology and never merges); ``ProcessorConfig.enable_fragment_merge
= False`` gives the reference's output.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from eagle_tpu_torch.config import ProcessorConfig
from eagle_tpu_torch.ops.kalman import CvKalman2D
from eagle_tpu_torch.ops.kmeans import COLOR_NAMES, crop_color_votes, gather_crops_host
from eagle_tpu_torch.pipeline.coordinate_model import StageTimer, resolve_device

CORNER_COLS = ["Bottom_Left", "Top_Left", "Top_Right", "Bottom_Right"]

NAN = float("nan")


def isna(v) -> bool:
    """pandas' ``isna`` for one object cell: None or a float NaN."""
    return v is None or (isinstance(v, float) and math.isnan(v))


class Table:
    """An ordered column table: ``index`` (the frame keys, in row order)
    and ``columns`` (name -> list of cells, one per row, in column order)."""

    def __init__(self, index=(), columns=None):
        self.index: list = list(index)
        self.columns: dict[str, list] = {} if columns is None else dict(columns)

    @property
    def empty(self) -> bool:
        """No rows or no columns (``DataFrame.empty``)."""
        return not self.index or not self.columns

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def __setitem__(self, name: str, cells) -> None:
        """Replace a column in place, or append a new one at the end."""
        self.columns[name] = list(cells)

    def drop(self, names) -> None:
        for name in names:
            del self.columns[name]

    def first_valid(self, name: str):
        """Index label of the column's first present cell, or None."""
        return next((k for k, v in zip(self.index, self.columns[name]) if not isna(v)), None)

    def last_valid(self, name: str):
        """Index label of the column's last present cell, or None."""
        pairs = zip(reversed(self.index), reversed(self.columns[name]))
        return next((k for k, v in pairs if not isna(v)), None)

    def at(self, name: str, label):
        return self.columns[name][self.index.index(label)]

    def records(self) -> list[dict]:
        """One {column: cell} dict per row, columns in order (the index is
        dropped, as ``to_json(orient="records")`` drops it)."""
        names = list(self.columns)
        cols = [self.columns[c] for c in names]
        return [dict(zip(names, row)) for row in zip(*cols)] if names else [{} for _ in self.index]


def combine_first(a: list, b: list) -> list:
    """``Series.combine_first`` on aligned columns: a's cell where present,
    else b's."""
    return [x if not isna(x) else y for x, y in zip(a, b)]


def calculate_distance(pt1, pt2):
    return np.sqrt((pt1[0] - pt2[0]) ** 2 + (pt1[1] - pt2[1]) ** 2)


def _split_xy(values) -> tuple[np.ndarray, np.ndarray]:
    """Column of (x, y) tuples / lists / missing -> two float arrays."""
    n = len(values)
    x = np.empty(n, np.float64)
    y = np.empty(n, np.float64)
    for i, v in enumerate(values):
        if isinstance(v, (list, tuple)):
            x[i] = v[0]
            y[i] = v[1]
        else:
            x[i] = np.nan
            y[i] = np.nan
    return x, y


def _join_xy(x: np.ndarray, y: np.ndarray) -> list:
    return [
        (xi, yi) if not (math.isnan(xi) and math.isnan(yi)) else NAN
        for xi, yi in zip(x.tolist(), y.tolist())
    ]


def _interp1(a: np.ndarray, fill: bool) -> np.ndarray:
    """pandas ``Series.interpolate(method='linear')`` on a float array, by
    position (np.interp, the primitive pandas calls).  ``fill`` clamps both
    edges (``interpolate().bfill().ffill()``); otherwise values outside the
    first and last valid ones stay NaN (``limit_area='inside'``)."""
    valid = ~np.isnan(a)
    nv = int(valid.sum())
    if nv == 0 or nv == len(a):
        return a
    idx = np.flatnonzero(valid)
    pos = np.arange(len(a), dtype=np.float64)
    out = a.copy()
    gaps = ~valid
    out[gaps] = np.interp(pos[gaps], pos[idx], a[idx])
    if not fill:
        out[: idx[0]] = np.nan
        out[idx[-1] + 1 :] = np.nan
    return out


def interpolate_df(table: Table, col_name: str, fill: bool = False) -> Table:
    """Linear interpolation of a tuple-valued column; ``fill`` also back-
    and forward-fills the edges (the ball columns)."""
    x, y = _split_xy(table[col_name])
    table[col_name] = _join_xy(_interp1(x, fill), _interp1(y, fill))
    return table


def smooth_df(table: Table, col_name: str) -> Table:
    """NaN every second sample, then re-interpolate."""
    x, y = _split_xy(table[col_name])
    x[::2] = np.nan
    y[::2] = np.nan
    table[col_name] = _join_xy(_interp1(x, False), _interp1(y, False))
    return table


def _init_ball_kf(detections: list, num_to_init: int):
    """Ball-selector filter: collect the leading window of candidates,
    fill its gaps linearly, seed the filter with the first position and
    the mean frame-to-frame velocity.  None below 2 present candidates."""
    init_vals = []
    non_none = 0
    i = 0
    while True:
        if non_none >= 2 and len(init_vals) >= num_to_init:
            break
        if i == len(detections):
            break
        curr = detections[i]
        if curr is not None:
            init_vals.append(curr[0])
            non_none += 1
        else:
            init_vals.append(None)
        i += 1

    if non_none < 2:
        return None

    xs = np.array([v[0] if v is not None else np.nan for v in init_vals], np.float64)
    ys = np.array([v[1] if v is not None else np.nan for v in init_vals], np.float64)
    init_vals = list(zip(_interp1(xs, True).tolist(), _interp1(ys, True).tolist()))
    vels = [
        (init_vals[k][0] - init_vals[k - 1][0], init_vals[k][1] - init_vals[k - 1][1])
        for k in range(1, len(init_vals))
    ]
    avg_vel = (np.mean([v[0] for v in vels]), np.mean([v[1] for v in vels]))
    return CvKalman2D(init_vals[0], avg_vel)


class _BallSelectState:
    """The ball selector's sequential carry: the filter plus the previous
    accepted pick."""

    def __init__(self, kf: CvKalman2D):
        self.kf = kf
        self.prev_pos = None  # column-vector shaped, like the reference
        self.prev_idx = None
        self.removed = 0


def _ball_select_step(state: _BallSelectState, i: int, candidates, filter: bool, threshold: float):
    """One frame of the reference's selection loop, mutating ``state`` and
    returning the picked position (or None)."""
    kf = state.kf
    if candidates is None or len(candidates) == 0:
        return None
    if len(candidates) == 1:
        meas = np.array([[np.float32(candidates[0][0])], [np.float32(candidates[0][1])]])
    else:
        pred = kf.predict()
        pred_pos = (pred[0, 0], pred[1, 0])
        d_pred = [np.linalg.norm(np.array(c) - np.array(pred_pos)) for c in candidates]
        if state.prev_pos is not None:
            # as the reference: (2,) - (2, 1) broadcasts to a 2x2 difference
            # whose Frobenius norm it uses
            d_prev = [np.linalg.norm(np.array(c) - np.array(state.prev_pos)) for c in candidates]
            dists = [0.5 * a + 0.5 * b for a, b in zip(d_pred, d_prev)]
        else:
            dists = d_pred
        best = candidates[int(np.argmin(dists))]
        meas = np.array([[np.float32(best[0])], [np.float32(best[1])]])

    if filter:
        if state.prev_pos is not None:
            dist = float(calculate_distance((meas[0, 0], meas[1, 0]), state.prev_pos)[0])
            if dist > threshold * (i - state.prev_idx):
                state.removed += 1
                return None
        kf.correct(meas)
        if state.prev_pos is not None:
            kf.predict()
        state.prev_pos = meas
        state.prev_idx = i
    return (float(meas[0, 0]), float(meas[1, 0]))


class Processor:
    """``Processor(coords, frames, fps).process_data()`` -> (table,
    team_mapping).  ``frames`` are the clip's host frames (a list or an
    (N, H, W, 3) uint8 array), read for the team-vote crops.  The votes run
    on the CUDA card unless ``device="cpu"``; with no card it raises.
    ``timer`` (a :class:`StageTimer`) collects the stages crops, votes,
    table, merge (the interpolation included) and format.  After
    :meth:`process_data`, ``crop_entries`` lists the voted crops (frame
    index, pid, bbox, overlap share) and ``crop_votes`` their (B, 12)
    int32 colour counts."""

    def __init__(
        self,
        coords: dict,
        frames,
        fps: int,
        debug: bool = False,
        filter_ball_detections: bool = False,
        config: ProcessorConfig | None = None,
        device: str | torch.device | None = None,
        timer: StageTimer | None = None,
    ):
        assert len(coords) == len(frames), (
            f"Length of coords ({len(coords)}) and frames ({len(frames)}) should be the same"
        )
        self.config = config or ProcessorConfig()
        if self.config.team_assign != "device":
            raise NotImplementedError(
                "only the device team assignment is ported (ProcessorConfig.team_assign='device'); "
                "the host backend runs sklearn per crop"
            )
        self.coords = coords
        self.frames = frames
        self.fps = fps
        self.debug = debug
        self.filter_ball_detections = filter_ball_detections
        self.device = resolve_device(device)
        self.timer = timer or StageTimer(self.device)
        self.crop_entries: list = []
        self.crop_votes = np.zeros((0, len(COLOR_NAMES)), np.int32)

    # ------------------------------------------------------------------

    def process_data(self, smooth: bool = False) -> tuple[Table, dict]:
        # launch the device votes first so the card works while the host
        # builds the table
        pending_votes = self._start_team_votes()
        with self.timer("table"):
            table = self.create_dataframe()
        if table.empty:
            return table, {}
        with self.timer("merge"):
            table = interpolate_df(table, "Ball", fill=True)
            table = interpolate_df(table, "Ball_video", fill=True)
        team_mapping = self._finish_team_mapping(pending_votes)
        with self.timer("merge"):
            table.index = [int(k) for k in table.index]
            table = self.merge_data(table, team_mapping)
            for col in list(table.columns):
                table = interpolate_df(table, col, fill=False)
                if smooth:
                    table = smooth_df(table, col)
        return table, team_mapping

    def format_data(self, table: Table) -> list[dict]:
        """Long-format per-frame records: the boundaries, and per frame the
        objects' pitch and image coordinates with the ball last."""
        with self.timer("format"):
            if table.empty:
                return []
            cols = list(table.columns)
            corner = [table[c] for c in CORNER_COLS]
            ball, ball_video = table["Ball"], table["Ball_video"]
            entity_cols = []  # (cells, ID, Type, is_video)
            for c in cols:
                if c in CORNER_COLS or "ball" in c.lower():
                    continue
                parts = c.split("_")
                entity_cols.append((table[c], int(parts[1]), parts[0], "video" in c))

            out = []
            for i in range(len(table)):
                rec = {"Boundaries": [cells[i] for cells in corner]}
                data, data_video = [], []
                for cells, oid, typ, is_video in entity_cols:
                    val = cells[i]
                    if isinstance(val, float) and math.isnan(val):
                        continue
                    item = {"ID": oid, "Coordinates": val, "Type": typ}
                    (data_video if is_video else data).append(item)
                data.append({"ID": "Ball", "Coordinates": ball[i]})
                data_video.append({"ID": "Ball", "Coordinates": ball_video[i]})
                rec["Coordinates"] = data
                rec["Coordinates_video"] = data_video
                out.append(rec)
            return out

    # ------------------------------------------------------------------

    def create_dataframe(self) -> Table:
        """The wide table: one row per frame with at least one person
        detection, columns in order of first appearance; ball candidates
        resolved over the whole clip and aligned to the kept rows; columns
        present in fewer than ``min_coverage`` of the rows dropped."""
        ball_img_candidates = []
        ball_pitch_candidates = []
        rows = {}
        frame_keys = list(self.coords.keys())

        for fk in frame_keys:
            curr = self.coords[fk]
            b = curr["Boundaries"]
            row = {"Bottom_Left": b[0], "Top_Left": b[1], "Top_Right": b[2], "Bottom_Right": b[3]}
            cd = curr.get("Coordinates", {})
            has_person = False
            for name in ("Player", "Goalkeeper"):
                for oid, item in cd.get(name, {}).items():
                    x1, y1, x2, y2 = item["BBox"]
                    tc = item.get("Transformed_Coordinates")
                    row[f"{name}_{oid}"] = tc if tc else NAN
                    row[f"{name}_{oid}_video"] = ((x1 + x2) / 2, y2)
                    has_person = True

            balls = cd.get("Ball", {})
            if balls:
                img, pitchc = [], []
                for item in balls.values():
                    conf = float(item["Confidence"])
                    x1, y1, x2, y2 = item["BBox"]
                    center = ((x1 + x2) / 2, y2)
                    tc = item["Transformed_Coordinates"] or center
                    img.append((center, conf))
                    pitchc.append((tc, conf))
                img.sort(key=lambda t: t[1], reverse=True)
                pitchc.sort(key=lambda t: t[1], reverse=True)
                ball_img_candidates.append([c for c, _ in img])
                ball_pitch_candidates.append([c for c, _ in pitchc])
            else:
                ball_img_candidates.append(None)
                ball_pitch_candidates.append(None)

            if has_person:
                rows[fk] = row

        h, w = np.asarray(self.frames[0]).shape[:2]
        ball_img = self.parse_ball_detections_with_kalman(
            ball_img_candidates,
            num_to_init=self.config.ball_kalman_init,
            filter=self.filter_ball_detections,
            threshold=0.1 * w,
        )
        ball_pitch = self.parse_ball_detections_with_kalman(
            ball_pitch_candidates, num_to_init=self.config.ball_kalman_init, filter=False
        )
        # image-coordinate acceptance gates the pitch coordinates
        ball_pitch = [ball_pitch[i] if ball_img[i] is not None else None for i in range(len(ball_img))]

        if not rows:
            return Table()
        index = list(rows)
        col_order: dict[str, None] = {}
        for row in rows.values():
            col_order.update(dict.fromkeys(row))
        table = Table(index, {c: [rows[fk].get(c, NAN) for fk in index] for c in col_order})
        pos = {fk: i for i, fk in enumerate(frame_keys)}
        for name, picks in (("Ball", ball_pitch), ("Ball_video", ball_img)):
            table[name] = [NAN if picks[pos[fk]] is None else picks[pos[fk]] for fk in index]
        # drop ids seen in < 1% of kept frames
        floor = self.config.min_coverage * len(table)
        table.drop([c for c, cells in table.columns.items() if sum(not isna(v) for v in cells) < floor])
        return table

    # ------------------------------------------------------------------

    def parse_ball_detections_with_kalman(
        self, detections: list, num_to_init: int = 5, filter: bool = True, threshold: float = 100
    ) -> list:
        """Pick one ball position per frame from ranked candidate lists: a
        constant-velocity Kalman prediction plus the previous pick break
        ties; the optional jump filter rejects moves larger than
        ``threshold`` times the frame gap."""
        kf = _init_ball_kf(detections, num_to_init)
        if kf is None:
            print("Not enough non-None coordinates to initialize Kalman Filter")
            return detections

        state = _BallSelectState(kf)
        positions = [_ball_select_step(state, i, c, filter, threshold) for i, c in enumerate(detections)]
        if self.debug and filter:
            print(f"Removed {state.removed} detections")
        return positions

    # ------------------------------------------------------------------

    def get_team_mapping(self) -> dict:
        """Team id per player from jersey-colour votes: per-crop KMeans
        foreground segmentation and HSV range counts, each crop's votes
        weighted by 1 - its overlap; the two most common best colours are
        the teams, other players take their best of those two."""
        return self._finish_team_mapping(self._start_team_votes())

    def _crop_entries(self) -> list:
        """Eligible (frame index, pid, bbox, overlap share) crops: skipped
        when more than ``max_crop_overlap`` of the box is covered by another
        player's box (boxes with identical coordinates ignore each other) or
        when the box is under 4 px of area."""
        entries = []
        for fi, fk in enumerate(self.coords):
            players = self.coords[fk].get("Coordinates", {}).get("Player", {})
            if not players:
                continue
            pids = list(players.keys())
            items = list(players.values())
            b = np.asarray([it["BBox"] for it in items], np.float64)  # (P, 4)
            sizes = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            ox = np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0])
            oy = np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1])
            inter = np.maximum(ox, 0) * np.maximum(oy, 0)
            same = (b[:, None, :] == b[None, :, :]).all(-1)
            inter[same] = 0.0
            max_overlap = inter.max(axis=1) if len(b) > 1 else np.zeros(len(b))
            for k, (pid, it) in enumerate(zip(pids, items)):
                size = sizes[k]
                if size <= 0:
                    continue
                prop_overlap = max_overlap[k] / size
                if prop_overlap > self.config.max_crop_overlap:
                    continue
                if size < 4:
                    continue
                x1, y1, x2, y2 = it["BBox"]
                entries.append((fi, int(pid), (x1, y1, x2, y2), prop_overlap))
        return entries

    def _start_team_votes(self):
        """Cut the crops on the host and launch the device votes without
        waiting for them.  Returns (entries, votes tensor or None)."""
        with self.timer("crops"):
            entries = self._crop_entries()
            if not entries:
                return (entries, None)
            fidx = np.array([e[0] for e in entries], np.int32)
            boxes = np.array([e[2] for e in entries], np.float32)
            crops = gather_crops_host(self.frames, fidx, boxes, grid_hw=self.config.crop_hw)
            crops = torch.from_numpy(crops).to(self.device)
        with self.timer("votes"):
            return (entries, crop_color_votes(crops, iters=self.config.kmeans_iters))

    def _finish_team_mapping(self, pending) -> dict:
        with self.timer("votes"):
            entries, dev_votes = pending
            counts: dict[int, dict[str, float]] = {}
            self.crop_entries = entries
            if dev_votes is not None:
                votes = self.crop_votes = dev_votes.cpu().numpy()
                # per pid in entry order; per crop the colours count-
                # descending, ties in COLOR_NAMES order -- the insertion order
                # that max() and Counter break their ties by
                for k, (_fi, pid, _box, prop) in enumerate(entries):
                    v = votes[k]
                    pos = np.flatnonzero(v > 0)
                    pos = pos[np.argsort(-v[pos], kind="stable")]
                    if len(pos) == 0:
                        continue
                    cc = counts.setdefault(int(pid), {})
                    for ci in pos:
                        name = COLOR_NAMES[ci]
                        cc[name] = cc.get(name, 0.0) + 1.0 - prop

            best_color = {pid: max(cc, key=cc.get) for pid, cc in counts.items()}
            top2 = Counter(best_color.values()).most_common(2)
            id_map = {color: i for i, (color, _) in enumerate(top2)}
            mapping = {}
            for pid, color in best_color.items():
                if color in id_map:
                    mapping[pid] = id_map[color]
                else:  # outlier: best of the two team colours from its votes
                    cc = [(c, v) for c, v in counts[pid].items() if c in id_map]
                    if not cc:
                        print(f"Unable to determine team for player {pid}")
                        continue
                    cc.sort(key=lambda t: t[1], reverse=True)
                    mapping[pid] = id_map[cc[0][0]]
            return mapping

    # ------------------------------------------------------------------

    def merge_data(self, table: Table, team_mapping: dict) -> Table:
        """Ids seen as both player and goalkeeper collapse into the
        goalkeeper columns; then temporally disjoint track fragments of one
        kind whose gap is at most ``merge_gap_seconds`` and whose ends lie
        within ``merge_px_per_frame`` px a frame of gap merge (unless
        mapped to different teams)."""
        gk_ids = [c.split("_")[1] for c in table.columns if "Goalkeeper" in c and "video" in c]
        for gid in gk_ids:
            pc, pcv = f"Player_{gid}", f"Player_{gid}_video"
            gc, gcv = f"Goalkeeper_{gid}", f"Goalkeeper_{gid}_video"
            if pc in table and pcv in table:
                table[gc] = combine_first(table[pc], table[gc])
                table[gcv] = combine_first(table[pcv], table[gcv])
                table.drop([pc, pcv])

        if not self.config.enable_fragment_merge:
            return table

        video_cols = [c for c in table.columns if "Ball" not in c and "video" in c]
        gap_limit = int(self.fps * self.config.merge_gap_seconds)
        spans = {c: (table.first_valid(c), table.last_valid(c)) for c in video_cols}

        to_merge = []
        for col in video_cols:
            kind = "Player" if "Player" in col else "Goalkeeper"
            c_first, c_last = spans[col]
            if c_first is None:
                continue
            for cand in video_cols:
                if cand == col or kind not in cand:
                    continue
                a_first, a_last = spans[cand]
                if a_first is None:
                    continue
                # temporally disjoint only
                if c_last >= a_first and a_last >= c_first:
                    continue
                # the earlier track's end against the later track's start
                if a_first < c_first:
                    gap_start, gap_start_val = a_last, table.at(cand, a_last)
                    gap_end, gap_end_val = c_first, table.at(col, c_first)
                else:
                    gap_start, gap_start_val = c_last, table.at(col, c_last)
                    gap_end, gap_end_val = a_first, table.at(cand, a_first)
                gap = abs(gap_end - gap_start)
                if gap > gap_limit:
                    continue
                if calculate_distance(gap_end_val, gap_start_val) > self.config.merge_px_per_frame * gap:
                    continue
                cid = int(col.split("_")[1])
                aid = int(cand.split("_")[1])
                if cid in team_mapping and aid in team_mapping:
                    if team_mapping[cid] != team_mapping[aid]:
                        continue
                to_merge.append((col, cand))

        to_merge.extend([(a.replace("_video", ""), b.replace("_video", "")) for a, b in to_merge])
        if self.debug:
            print(f"Merging {len(to_merge)} columns")
            print("To Merge:", to_merge)

        merged: dict[str, str] = {}

        def root(c):
            while c in merged:
                c = merged[c]
            return c

        for a, b in to_merge:
            ra, rb = root(a), root(b)
            if ra != rb and ra in table and rb in table:
                table[ra] = combine_first(table[ra], table[rb])
                table.drop([rb])
                merged[rb] = ra
        return table

