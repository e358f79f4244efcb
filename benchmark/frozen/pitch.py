# Frozen copy of eagle_tpu_torch/pitch.py (the 57 pitch landmarks the scene and the judge use).
# The benchmark keeps its own copy so that the yardstick does not move when
# the program does; the text below is the original's, with only the import
# of ``pitch`` pointed at the copy beside this file.
"""Pitch geometry: the 57 canonical UEFA pitch landmarks and derived constants.

A copy of the JAX package's ``eagle_tpu/pitch.py`` (plain numpy), kept
here so that this package imports nothing of the JAX package.

This module is the static-data layer of the framework (reference:
eagle/utils/pitch.py:1-302).  Unlike the reference, which stores every
mapping as a hand-written dict, we keep one canonical table -- the ordered
landmark names and their world coordinates on a UEFA 105x68 pitch -- and
*derive* everything else (left/right point sets, flip maps for augmentation,
on-plane masks, line families for keypoint synthesis) programmatically from
the geometry.  All derived structures are exported as fixed-shape numpy
arrays indexed by landmark id, which is what the pipeline consumes
(fixed 57-slot keypoint tensors instead of ragged dicts).

World frame: x in [0, 105] left->right, y in [0, 68] bottom->top, z up
(goal crossbars sit at z = -2.44 in the reference's convention, i.e. the
z-axis points *down* from the ground plane; we keep that convention for
bit-compatibility -- reference eagle/utils/pitch.py:233-240).
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# Primitive pitch dimensions (UEFA / IFAB Laws of the Game)
# ---------------------------------------------------------------------------

PITCH_LENGTH = 105.0  # x extent, meters
PITCH_WIDTH = 68.0  # y extent, meters
CENTER_X = PITCH_LENGTH / 2.0  # 52.5
CENTER_Y = PITCH_WIDTH / 2.0  # 34.0
PENALTY_AREA_DEPTH = 16.5
PENALTY_AREA_HALF_SPAN = 20.16  # 40.32 m wide
GOAL_AREA_DEPTH = 5.5
GOAL_AREA_HALF_SPAN = 9.16  # 18.32 m wide
CIRCLE_RADIUS = 9.15
PENALTY_MARK_DIST = 11.0
GOAL_HALF_SPAN = 3.66  # 7.32 m between posts
CROSSBAR_Z = -2.44  # reference convention: below-plane z for the crossbar

# Aliases used across the pipeline (reference coordinate_model.py:18-19).
PITCH_X_MAX = PITCH_LENGTH
PITCH_Y_MAX = PITCH_WIDTH


def _penalty_arc_y_offset() -> float:
    """Half-height of the chord where the penalty arc meets the 16.5 m line."""
    return math.sqrt(CIRCLE_RADIUS**2 - (PENALTY_AREA_DEPTH - PENALTY_MARK_DIST) ** 2)


def _touchline_tangent() -> tuple[float, float]:
    """Tangent-point offsets of the center circle as seen from the
    touchline/halfway intersection (52.5, 68):  the classic "tangent from an
    external point" construction.  Returns (dx, dy) from the circle center.
    """
    d = PITCH_WIDTH - CENTER_Y  # 34.0, distance from center to touchline point
    dy = CIRCLE_RADIUS**2 / d
    dx = math.sqrt(CIRCLE_RADIUS**2 - dy**2)
    return dx, dy


def _diagonal_circle_point() -> float:
    """45-degree point offset on the center circle: r / sqrt(2) ... not quite.

    The reference's CENTER_CIRCLE_TR sits at (58.97002704785691,
    40.47002704785691): equal x/y offsets of 6.47002704785691 = r/sqrt(2).
    """
    return CIRCLE_RADIUS / math.sqrt(2.0)


def _left_circle_tangent() -> tuple[float, float]:
    """Tangent point of the left penalty arc as seen from the penalty-area
    top corner (16.5, 54.16): the outermost point of the visible arc from
    the box-corner perspective.  Returns (dx, dy) offsets from the penalty
    mark; matches reference LEFT_CIRCLE_TANGENT_T at (19.9906727467215,
    35.70008928040832).
    """
    # external point P relative to the circle center C = (11, 34)
    px, py = PENALTY_AREA_DEPTH - PENALTY_MARK_DIST, PENALTY_AREA_HALF_SPAN
    d2 = px * px + py * py
    r2 = CIRCLE_RADIUS**2
    k = math.sqrt(d2 - r2) * CIRCLE_RADIUS / d2
    # of the two tangent points, take the one farther from the goal line
    dx = (r2 / d2) * px + k * py
    dy = (r2 / d2) * py - k * px
    return dx, dy


_ARC_DY = _penalty_arc_y_offset()
_TAN_DX, _TAN_DY = _touchline_tangent()
_DIAG = _diagonal_circle_point()
_LC_DX, _LC_DY = _left_circle_tangent()

# ---------------------------------------------------------------------------
# The canonical landmark table: id -> (name, world x, world y, world z).
# Ids and names follow the SoccerNet-calibration convention used by the
# reference (eagle/utils/pitch.py:1-59, :209-267); coordinates are derived
# from the primitive dimensions above so the geometry is self-documenting.
# ---------------------------------------------------------------------------

_L = 0.0
_R = PITCH_LENGTH

_LANDMARKS: list[tuple[str, float, float, float]] = [
    # 0-3: left goal posts (TL/TR are crossbar ends, z != 0)
    ("L_GOAL_TL_POST", _L, CENTER_Y - GOAL_HALF_SPAN, CROSSBAR_Z),
    ("L_GOAL_TR_POST", _L, CENTER_Y + GOAL_HALF_SPAN, CROSSBAR_Z),
    ("L_GOAL_BL_POST", _L, CENTER_Y - GOAL_HALF_SPAN, 0.0),
    ("L_GOAL_BR_POST", _L, CENTER_Y + GOAL_HALF_SPAN, 0.0),
    # 4-7: left goal area ("6-yard box") corners
    ("L_GOAL_AREA_BR_CORNER", GOAL_AREA_DEPTH, CENTER_Y - GOAL_AREA_HALF_SPAN, 0.0),
    ("L_GOAL_AREA_TR_CORNER", GOAL_AREA_DEPTH, CENTER_Y + GOAL_AREA_HALF_SPAN, 0.0),
    ("L_GOAL_AREA_BL_CORNER", _L, CENTER_Y - GOAL_AREA_HALF_SPAN, 0.0),
    ("L_GOAL_AREA_TL_CORNER", _L, CENTER_Y + GOAL_AREA_HALF_SPAN, 0.0),
    # 8-11: left penalty area corners
    ("L_PENALTY_AREA_BR_CORNER", PENALTY_AREA_DEPTH, CENTER_Y - PENALTY_AREA_HALF_SPAN, 0.0),
    ("L_PENALTY_AREA_TR_CORNER", PENALTY_AREA_DEPTH, CENTER_Y + PENALTY_AREA_HALF_SPAN, 0.0),
    ("L_PENALTY_AREA_BL_CORNER", _L, CENTER_Y - PENALTY_AREA_HALF_SPAN, 0.0),
    ("L_PENALTY_AREA_TL_CORNER", _L, CENTER_Y + PENALTY_AREA_HALF_SPAN, 0.0),
    # 12-15: pitch corners and halfway/touchline intersections
    ("BL_PITCH_CORNER", _L, 0.0, 0.0),
    ("TL_PITCH_CORNER", _L, PITCH_WIDTH, 0.0),
    ("B_TOUCH_AND_HALFWAY_LINES_INTERSECTION", CENTER_X, 0.0, 0.0),
    ("T_TOUCH_AND_HALFWAY_LINES_INTERSECTION", CENTER_X, PITCH_WIDTH, 0.0),
    # 16-19: right penalty area corners
    ("R_PENALTY_AREA_BL_CORNER", _R - PENALTY_AREA_DEPTH, CENTER_Y - PENALTY_AREA_HALF_SPAN, 0.0),
    ("R_PENALTY_AREA_TL_CORNER", _R - PENALTY_AREA_DEPTH, CENTER_Y + PENALTY_AREA_HALF_SPAN, 0.0),
    ("R_PENALTY_AREA_BR_CORNER", _R, CENTER_Y - PENALTY_AREA_HALF_SPAN, 0.0),
    ("R_PENALTY_AREA_TR_CORNER", _R, CENTER_Y + PENALTY_AREA_HALF_SPAN, 0.0),
    # 20-23: right goal area corners
    ("R_GOAL_AREA_BL_CORNER", _R - GOAL_AREA_DEPTH, CENTER_Y - GOAL_AREA_HALF_SPAN, 0.0),
    ("R_GOAL_AREA_TL_CORNER", _R - GOAL_AREA_DEPTH, CENTER_Y + GOAL_AREA_HALF_SPAN, 0.0),
    ("R_GOAL_AREA_BR_CORNER", _R, CENTER_Y - GOAL_AREA_HALF_SPAN, 0.0),
    ("R_GOAL_AREA_TR_CORNER", _R, CENTER_Y + GOAL_AREA_HALF_SPAN, 0.0),
    # 24-27: right goal posts (note TL/TR y-order is mirrored vs the left
    # goal in the reference convention -- eagle/utils/pitch.py:237-240)
    ("R_GOAL_TL_POST", _R, CENTER_Y + GOAL_HALF_SPAN, CROSSBAR_Z),
    ("R_GOAL_TR_POST", _R, CENTER_Y - GOAL_HALF_SPAN, CROSSBAR_Z),
    ("R_GOAL_BL_POST", _R, CENTER_Y + GOAL_HALF_SPAN, 0.0),
    ("R_GOAL_BR_POST", _R, CENTER_Y - GOAL_HALF_SPAN, 0.0),
    # 28-29: right pitch corners
    ("BR_PITCH_CORNER", _R, 0.0, 0.0),
    ("TR_PITCH_CORNER", _R, PITCH_WIDTH, 0.0),
    # 30-33: center-circle tangent points (from the touchline intersections)
    ("CENTER_CIRCLE_TANGENT_TR", CENTER_X + _TAN_DX, CENTER_Y + _TAN_DY, 0.0),
    ("CENTER_CIRCLE_TANGENT_TL", CENTER_X - _TAN_DX, CENTER_Y + _TAN_DY, 0.0),
    ("CENTER_CIRCLE_TANGENT_BR", CENTER_X + _TAN_DX, CENTER_Y - _TAN_DY, 0.0),
    ("CENTER_CIRCLE_TANGENT_BL", CENTER_X - _TAN_DX, CENTER_Y - _TAN_DY, 0.0),
    # 34-37: center-circle 45-degree points
    ("CENTER_CIRCLE_TR", CENTER_X + _DIAG, CENTER_Y + _DIAG, 0.0),
    ("CENTER_CIRCLE_TL", CENTER_X - _DIAG, CENTER_Y + _DIAG, 0.0),
    ("CENTER_CIRCLE_BR", CENTER_X + _DIAG, CENTER_Y - _DIAG, 0.0),
    ("CENTER_CIRCLE_BL", CENTER_X - _DIAG, CENTER_Y - _DIAG, 0.0),
    # 38-42: center-circle axis points, halfway-line intersections, kick-off
    ("CENTER_CIRCLE_R", CENTER_X + CIRCLE_RADIUS, CENTER_Y, 0.0),
    ("CENTER_CIRCLE_L", CENTER_X - CIRCLE_RADIUS, CENTER_Y, 0.0),
    ("T_HALFWAY_LINE_AND_CENTER_CIRCLE_INTERSECTION", CENTER_X, 43.15, 0.0),
    ("B_HALFWAY_LINE_AND_CENTER_CIRCLE_INTERSECTION", CENTER_X, 24.85, 0.0),
    ("CENTER_MARK", CENTER_X, CENTER_Y, 0.0),
    # 43-49: left penalty arc / circle features
    ("LEFT_CIRCLE_R", PENALTY_MARK_DIST + CIRCLE_RADIUS, CENTER_Y, 0.0),
    ("BL_16M_LINE_AND_PENALTY_ARC_INTERSECTION", PENALTY_AREA_DEPTH, CENTER_Y - _ARC_DY, 0.0),
    ("TL_16M_LINE_AND_PENALTY_ARC_INTERSECTION", PENALTY_AREA_DEPTH, CENTER_Y + _ARC_DY, 0.0),
    ("LEFT_CIRCLE_TANGENT_T", PENALTY_MARK_DIST + _LC_DX, CENTER_Y + _LC_DY, 0.0),
    ("LEFT_CIRCLE_TANGENT_B", PENALTY_MARK_DIST + _LC_DX, CENTER_Y - _LC_DY, 0.0),
    ("L_PENALTY_MARK", PENALTY_MARK_DIST, CENTER_Y, 0.0),
    ("L_MIDDLE_PENALTY", PENALTY_AREA_DEPTH, CENTER_Y, 0.0),
    # 50-56: right penalty arc / circle features (mirror of 43-49)
    ("RIGHT_CIRCLE_L", _R - PENALTY_MARK_DIST - CIRCLE_RADIUS, CENTER_Y, 0.0),
    ("BR_16M_LINE_AND_PENALTY_ARC_INTERSECTION", _R - PENALTY_AREA_DEPTH, CENTER_Y - _ARC_DY, 0.0),
    ("TR_16M_LINE_AND_PENALTY_ARC_INTERSECTION", _R - PENALTY_AREA_DEPTH, CENTER_Y + _ARC_DY, 0.0),
    ("RIGHT_CIRCLE_TANGENT_T", _R - PENALTY_MARK_DIST - _LC_DX, CENTER_Y + _LC_DY, 0.0),
    ("RIGHT_CIRCLE_TANGENT_B", _R - PENALTY_MARK_DIST - _LC_DX, CENTER_Y - _LC_DY, 0.0),
    ("R_PENALTY_MARK", _R - PENALTY_MARK_DIST, CENTER_Y, 0.0),
    ("R_MIDDLE_PENALTY", _R - PENALTY_AREA_DEPTH, CENTER_Y, 0.0),
]

NUM_KEYPOINTS = len(_LANDMARKS)
assert NUM_KEYPOINTS == 57

KEYPOINT_NAMES: tuple[str, ...] = tuple(name for name, *_ in _LANDMARKS)
NAME_TO_ID: dict[str, int] = {name: i for i, name in enumerate(KEYPOINT_NAMES)}

#: (57, 3) float64 world coordinates (x, y, z) for each landmark id.
WORLD_XYZ: np.ndarray = np.array([[x, y, z] for _, x, y, z in _LANDMARKS], dtype=np.float64)
WORLD_XYZ.setflags(write=False)

#: (57, 2) convenience view of ground-plane coordinates.
WORLD_XY: np.ndarray = WORLD_XYZ[:, :2].copy()
WORLD_XY.setflags(write=False)

# Dict views kept for API parity with the reference
# (INTERSECTION_TO_PITCH_POINTS / GROUND_TRUTH_POINTS, pitch.py:1-59,209-267).
INTERSECTION_TO_PITCH_POINTS: dict[int, str] = dict(enumerate(KEYPOINT_NAMES))
PITCH_POINTS_TO_INTERSECTION: dict[str, int] = dict(NAME_TO_ID)
GROUND_TRUTH_POINTS: dict[str, tuple[float, float, float]] = {
    name: (float(x), float(y), float(z)) for name, x, y, z in _LANDMARKS
}

# ---------------------------------------------------------------------------
# Derived masks and index sets
# ---------------------------------------------------------------------------

#: Landmarks not on the ground plane (the four crossbar ends); these are
#: excluded from homography estimation (reference pitch.py:65,
#: coordinate_model.py:339-343).
ON_PLANE_MASK: np.ndarray = WORLD_XYZ[:, 2] == 0.0
ON_PLANE_MASK.setflags(write=False)
NOT_ON_PLANE: list[int] = [int(i) for i in np.flatnonzero(~ON_PLANE_MASK)]

#: Left/right-half landmark id sets (reference pitch.py:63-64), derived by
#: world x position; landmarks on the halfway line belong to neither.
POINTS_LEFT: list[int] = [int(i) for i in np.flatnonzero(WORLD_XYZ[:, 0] < CENTER_X)]
POINTS_RIGHT: list[int] = [int(i) for i in np.flatnonzero(WORLD_XYZ[:, 0] > CENTER_X)]


def _mirror_map(flip_axis: int) -> np.ndarray:
    """id -> id map under a world-coordinate mirror (0 = L/R, 1 = T/B)."""
    mirrored = WORLD_XYZ.copy()
    extent = PITCH_LENGTH if flip_axis == 0 else PITCH_WIDTH
    mirrored[:, flip_axis] = extent - mirrored[:, flip_axis]
    out = np.full(NUM_KEYPOINTS, -1, dtype=np.int32)
    for i in range(NUM_KEYPOINTS):
        dists = np.linalg.norm(WORLD_XYZ - mirrored[i], axis=1)
        j = int(np.argmin(dists))
        if dists[j] < 1e-6:
            out[i] = j
    assert (out >= 0).all(), "pitch landmark set is not mirror-symmetric"
    return out


#: Horizontal-flip landmark permutation (reference LR_SIDES_MAPPING,
#: pitch.py:68-126), derived from geometry.
LR_FLIP_IDS: np.ndarray = _mirror_map(0)
LR_FLIP_IDS.setflags(write=False)

#: Vertical-flip landmark permutation (reference TOP_BOTTOM_MAPPING,
#: pitch.py:128-186), derived from geometry.
TB_FLIP_IDS: np.ndarray = _mirror_map(1)
TB_FLIP_IDS.setflags(write=False)

LR_SIDES_MAPPING: dict[str, str] = {
    KEYPOINT_NAMES[i]: KEYPOINT_NAMES[int(LR_FLIP_IDS[i])] for i in range(NUM_KEYPOINTS)
}
TOP_BOTTOM_MAPPING: dict[str, str] = {
    KEYPOINT_NAMES[i]: KEYPOINT_NAMES[int(TB_FLIP_IDS[i])] for i in range(NUM_KEYPOINTS)
}

#: Landmark id pairs joined by *painted* line segments perpendicular to the
#: pitch's long axis (reference pitch.py:188-207).  Cannot be derived from
#: coordinates alone (circle tangent points share an x value but lie on arcs,
#: not painted lines), so the set is spelled out: goal posts, goal-area and
#: penalty-area edges, goal lines, the halfway line, and the 16.5 m lines.
PERP_LINES: list[tuple[int, int]] = [
    (0, 1),  # left crossbar
    (2, 3),  # left goal line between posts
    (4, 5),  # left goal-area front edge
    (6, 7),  # left goal-area on goal line
    (8, 9),  # left penalty-area front edge (16.5 m line)
    (10, 11),  # left penalty-area on goal line
    (12, 13),  # left goal line (corner to corner)
    (14, 15),  # halfway line
    (16, 17),  # right penalty-area front edge
    (18, 19),  # right penalty-area on goal line
    (20, 21),  # right goal-area front edge
    (22, 23),  # right goal-area on goal line
    (24, 25),  # right crossbar
    (26, 27),  # right goal line between posts
    (28, 29),  # right goal line (corner to corner)
    (41, 40),  # halfway line through the center circle
    (44, 45),  # left 16.5 m line between arc intersections
    (51, 52),  # right 16.5 m line between arc intersections
]

# ---------------------------------------------------------------------------
# Line families for geometric keypoint synthesis
# (reference coordinate_model.py:76-94 builds these at runtime from dicts;
# here they are precomputed fixed-shape arrays so the synthesis step can run
# fully vectorized on device.)
# ---------------------------------------------------------------------------


def _build_line_families() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group on-plane landmarks by shared world X ("vertical" pitch lines)
    and shared world Y ("horizontal" pitch lines).

    Returns
    -------
    x_values : (NX,) distinct world-x values
    x_masks : (NX, 57) bool, landmark membership per x-line
    y_values : (NY,) distinct world-y values
    y_masks : (NY, 57) bool, landmark membership per y-line
    grid_ids : (NX, NY) int32, landmark id at (x_value, y_value) or -1
    x_order / y_order : (NX,) / (NY,) int32 rank of each line in
        first-appearance (landmark-id) order -- the iteration order the
        reference uses when capping synthesized keypoints
        (coordinate_model.py:169-183 iterates dict insertion order)
    """
    xs: dict[float, list[int]] = {}
    ys: dict[float, list[int]] = {}
    coord_to_id: dict[tuple[float, float], int] = {}
    for i in range(NUM_KEYPOINTS):
        if not ON_PLANE_MASK[i]:
            continue
        xr = round(float(WORLD_XYZ[i, 0]), 2)
        yr = round(float(WORLD_XYZ[i, 1]), 2)
        xs.setdefault(xr, []).append(i)
        ys.setdefault(yr, []).append(i)
        # first landmark wins on coordinate collisions (matches reference
        # coordinate_model.py:87-88, dict-insertion order)
        coord_to_id.setdefault((xr, yr), i)

    x_first_seen = list(xs)  # dict preserves first-appearance order
    y_first_seen = list(ys)
    x_values = np.array(sorted(xs), dtype=np.float64)
    y_values = np.array(sorted(ys), dtype=np.float64)
    x_order = np.array(
        [x_first_seen.index(round(float(v), 2)) for v in x_values], dtype=np.int32
    )
    y_order = np.array(
        [y_first_seen.index(round(float(v), 2)) for v in y_values], dtype=np.int32
    )
    x_masks = np.zeros((len(x_values), NUM_KEYPOINTS), dtype=bool)
    y_masks = np.zeros((len(y_values), NUM_KEYPOINTS), dtype=bool)
    for a, xv in enumerate(x_values):
        for i in xs[round(float(xv), 2)]:
            x_masks[a, i] = True
    for b, yv in enumerate(y_values):
        for i in ys[round(float(yv), 2)]:
            y_masks[b, i] = True
    grid_ids = np.full((len(x_values), len(y_values)), -1, dtype=np.int32)
    for a, xv in enumerate(x_values):
        for b, yv in enumerate(y_values):
            grid_ids[a, b] = coord_to_id.get((round(float(xv), 2), round(float(yv), 2)), -1)
    for arr in (x_values, x_masks, y_values, y_masks, grid_ids, x_order, y_order):
        arr.setflags(write=False)
    return x_values, x_masks, y_values, y_masks, grid_ids, x_order, y_order


(
    X_LINE_VALUES,
    X_LINE_MASKS,
    Y_LINE_VALUES,
    Y_LINE_MASKS,
    LINE_GRID_IDS,
    X_LINE_ORDER,
    Y_LINE_ORDER,
) = _build_line_families()

#: 100x100 normalized variant of the world coordinates (reference
#: pitch.py:270-280).
WORLD_XYZ_NORMALIZED: np.ndarray = WORLD_XYZ * np.array(
    [100.0 / PITCH_LENGTH, 100.0 / PITCH_WIDTH, 1.0]
)
WORLD_XYZ_NORMALIZED.setflags(write=False)
GROUND_TRUTH_POINTS_NORMALIZED: dict[str, tuple[float, float, float]] = {
    KEYPOINT_NAMES[i]: tuple(float(v) for v in WORLD_XYZ_NORMALIZED[i]) for i in range(NUM_KEYPOINTS)
}
