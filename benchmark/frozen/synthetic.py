# Frozen copy of eagle_tpu_torch/utils/synthetic.py (the seeded broadcast scene the traffic renders).
# The benchmark keeps its own copy so that the yardstick does not move when
# the program does; the text below is the original's, with only the import
# of ``pitch`` pointed at the copy beside this file.
"""Synthetic broadcast scene with exact ground truth (PyTorch port's copy of
``eagle_tpu/utils/synthetic.py``), drawn without OpenCV.

A fake TV view of a UEFA pitch under a known world->image homography, with
"players" (dark legs, a team jersey, a head) and a ball moving along known
world trajectories.  The eval CLI scores the models on it
(:mod:`eagle_tpu_torch.evaluate`), the acceptance runner drives its gates
with it (:mod:`eagle_tpu_torch.validate_acceptance`), and it runs where
OpenCV is not installed.

The truth arrays are the JAX package's: the same random draws, in the same
order, from the same ``np.random.default_rng(seed)``, through the same
float64 projection.  The frames are drawn by this module's own numpy
rasterizer, which follows OpenCV's integer drawing rules (the JAX package
draws with ``cv2.fillPoly``, ``cv2.line``, ``cv2.polylines``,
``cv2.rectangle`` and ``cv2.circle``):

- filled polygons (the mow stripes): the edges' 16.16 fixed-point x
  stepped row by row, each row filled over the pixel centres between them,
  plus the 8-connected outline of the integer vertices;
- thick lines (the markings, thickness 3): the segment clipped to the
  image grown by the thickness, a 16.16 fixed-point quad two pixels either
  side of it filled by scanlines with its fixed-point outline, and a
  filled disc of radius 2 at each end (polylines: at each segment's end,
  and at the start of an open one);
- filled rectangles (legs, torso) with both corners inclusive, and filled
  discs (head, ball) by OpenCV's midpoint scan.

The vertices are rounded as the JAX package rounds them: ``astype(np.int32)``
of the projected points, ``int(...)`` of the box corners.  Each primitive is
vectorised over the pixels it covers.  No path imports OpenCV, so every host
draws the same frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.frozen import pitch

_SHIFT = 16  # OpenCV's XY_SHIFT: 16.16 fixed point
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1
_THICKNESS = 3
_WHITE = (255, 255, 255)


@dataclasses.dataclass
class SyntheticScene:
    frames: np.ndarray  # (N, H, W, 3) uint8 BGR
    H_world_to_image: np.ndarray  # (3, 3)
    H_image_to_world: np.ndarray  # (3, 3)
    #: (N, P, 2) world positions of players
    player_world: np.ndarray
    #: (N, P, 2) image positions of player feet
    player_feet_image: np.ndarray
    #: (N, P, 4) image xyxy boxes
    player_boxes: np.ndarray
    #: (P,) team id (0/1)
    player_team: np.ndarray
    #: (N, 2) world ball positions
    ball_world: np.ndarray
    #: (N, 2) image ball positions (bottom center)
    ball_image: np.ndarray
    #: (57, 2) image positions of all pitch landmarks (may be off-screen)
    keypoints_image: np.ndarray
    fps: int


def _perspective_from_quads(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 3x3 homography taking the four points ``src`` to ``dst``, as
    ``cv2.getPerspectiveTransform`` computes it: the 8x8 system with
    ``H[2, 2] = 1`` built from the float32 points (their products are
    float32 products) and solved in float64 by :func:`_lu_solve`."""
    s = np.asarray(src, np.float32)
    d = np.asarray(dst, np.float32)
    a = np.zeros((8, 8))
    a[:4, 0:2] = s
    a[:4, 2] = 1.0
    a[4:, 3:5] = s
    a[4:, 5] = 1.0
    a[:4, 6:8] = -s * d[:, :1]
    a[4:, 6:8] = -s * d[:, 1:]
    h = _lu_solve(a, np.concatenate([d[:, 0], d[:, 1]]).astype(np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's LU solve (``DECOMP_LU``): Gaussian elimination with partial
    pivoting (the first row of largest magnitude), then back substitution
    dividing by the pivots, in its order of operations, so that the result
    is bit-equal to OpenCV's (LAPACK's differs in the last bits, enough to
    move a projected vertex across an integer)."""
    a, b = a.copy(), b.copy()
    m = len(b)
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if k != i:
            a[[i, k]] = a[[k, i]]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1 :] += alpha * a[i, i + 1 :]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def default_camera_homography(width: int = 1280, height: int = 720) -> np.ndarray:
    """A plausible main-camera view: the pitch fills a trapezoid.

    Maps world (x, y) [105 x 68, y up] to image pixels (u, v) [v down].
    """
    world_quad = np.array([[0.0, 68.0], [105.0, 68.0], [105.0, 0.0], [0.0, 0.0]], dtype=np.float32)
    # far touchline appears high & narrow-ish, near touchline low & wide
    image_quad = np.array(
        [
            [width * 0.08, height * 0.18],
            [width * 0.92, height * 0.18],
            [width * 1.25, height * 0.95],
            [-width * 0.25, height * 0.95],
        ],
        dtype=np.float32,
    )
    return _perspective_from_quads(world_quad, image_quad)


def project(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 3x3 homography to (..., 2) points."""
    pts = np.asarray(pts, dtype=np.float64)
    ones = np.ones(pts.shape[:-1] + (1,))
    homo = np.concatenate([pts, ones], axis=-1) @ H.T
    return homo[..., :2] / homo[..., 2:3]


# ---------------------------------------------------------------------------
# the rasterizer: OpenCV's integer drawing rules, in numpy
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """Clip the segment p1-p2 to [0, w-1] x [0, h-1] with OpenCV's
    arithmetic (``clipLine``).  Returns (inside, p1, p2)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _put(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    """Set the pixels (xs, ys) that lie inside the image."""
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _spans(img: np.ndarray, ys: np.ndarray, x1: np.ndarray, x2: np.ndarray, color) -> None:
    """Fill the row spans [x1, x2] (inclusive) of the rows ys, clipped."""
    h, w = img.shape[:2]
    ok = (ys >= 0) & (ys < h) & (x2 >= 0) & (x1 < w) & (x1 <= x2)
    ys, x1, x2 = ys[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok], w - 1)
    if len(ys) == 0:
        return
    lo, hi = int(x1.min()), int(x2.max())
    cols = np.arange(lo, hi + 1)
    inside = (cols[None, :] >= x1[:, None]) & (cols[None, :] <= x2[:, None])
    r, c = np.nonzero(inside)
    img[ys[r], cols[c]] = color


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's 8-connected line between integer points (``Line``), clipped."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    if not (0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w and 0 <= y2 < h):
        inside, (x1, y1), (x2, y2) = _clip_line(w, h, (x1, y1), (x2, y2))
        if not inside:
            return
    if x2 < x1:  # drawn left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = -1 if y2 < y1 else 1
    major, minor = (dx, dy) if dx >= dy else (dy, dx)
    k = np.arange(major + 1, dtype=np.int64)
    # the error term's minor steps, closed form: m_k = floor((2 k minor + major - 1) / (2 major))
    m = (2 * k * minor + major - 1) // (2 * major) if major else k * 0
    if dx >= dy:
        _put(img, x1 + k, y1 + sy * m, color)
    else:
        _put(img, x1 + m, y1 + sy * k, color)


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's outline of a fixed-point polygon edge (``Line2``): the
    16.16 points p1-p2, clipped, stepped one pixel along the major axis."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip_line(w << _SHIFT, h << _SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        step = _cdiv(dy << _SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        step = _cdiv(dx << _SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> _SHIFT
    x1 += _HALF
    y1 += _HALF
    _put(img, np.array([(x2 + _HALF) >> _SHIFT]), np.array([(y2 + _HALF) >> _SHIFT]), color)
    k = np.arange(count + 1, dtype=np.int64)
    if abs(dx) > abs(dy):
        _put(img, (x1 >> _SHIFT) + k, (y1 + k * step) >> _SHIFT, color)
    else:
        _put(img, (x1 + k * step) >> _SHIFT, (y1 >> _SHIFT) + k, color)


def _fill_convex(img: np.ndarray, v: list, color) -> None:
    """OpenCV's convex fill (``FillConvexPoly``) of 16.16 fixed-point
    vertices: the fixed-point outline, then two edge chains walked down
    from the top vertex, each edge's x stepped by its rounded slope from the
    row it starts on, every row filled between the chains' rounded x."""
    h, w = img.shape[:2]
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = ys.index(min(ys))
    ymin, ymax = (min(ys) + _HALF) >> _SHIFT, (max(ys) + _HALF) >> _SHIFT
    xmin, xmax = (min(xs) + _HALF) >> _SHIFT, (max(xs) + _HALF) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per chain: [vertex index, direction, x, dx, end row]
    chains = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
    edges = n
    y = ymin
    rows, lefts, rights = [], [], []
    while True:
        for c in chains:
            if y < c[4]:
                continue
            idx0, di = c[0], c[1]
            idx = (idx0 + di) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    xs0, xe = v[idx0][0], v[idx][0]
                    c[0], c[2], c[4] = idx, xs0, ty
                    c[3] = _cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        y_next = min(chains[0][4], chains[1][4], ymax + 1)
        k = np.arange(y_next - y, dtype=np.int64)
        xa = chains[0][2] + k * chains[0][3]
        xb = chains[1][2] + k * chains[1][3]
        rows.append(y + k)
        lefts.append((np.minimum(xa, xb) + _HALF) >> _SHIFT)
        rights.append((np.maximum(xa, xb) + _HALF) >> _SHIFT)
        for c in chains:
            c[2] += (y_next - y) * c[3]
        y = y_next
        if y > ymax:
            break
    if rows:
        _spans(img, np.concatenate(rows), np.concatenate(lefts), np.concatenate(rights), color)


def _fill_poly(img: np.ndarray, v: list, color) -> None:
    """OpenCV's general polygon fill (``fillPoly``) of integer vertices:
    the 8-connected outline, then each row filled between pairs of edges
    over the pixel centres that lie between their 16.16 x (an edge that
    leaves the image takes its line from its clipped ends)."""
    h, w = img.shape[:2]
    edges = []
    p0 = v[-1]
    for p1 in v:
        _line8(img, p0, p1, color)
        if p0[1] != p1[1]:
            c0 = (p0[0] << _SHIFT, p0[1])
            c1 = (p1[0] << _SHIFT, p1[1])
            if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h):
                _, t0, t1 = _clip_line(w, h, p0, p1)
                # the clipped ends' x, and their y unless clipping left none
                y0, y1 = (t0[1], t1[1]) if t0[1] != t1[1] else (p0[1], p1[1])
                c0, c1 = (t0[0] << _SHIFT, y0), (t1[0] << _SHIFT, y1)
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            top, c = (p0, c0) if p0[1] < p1[1] else (p1, c1)
            edges.append((top[1], max(p0[1], p1[1]), c[0] + (top[1] - c[1]) * dx, dx))
        p0 = p1
    if len(edges) < 2:
        return
    y0 = max(min(e[0] for e in edges), 0)
    y1 = min(max(e[1] for e in edges), h)
    if y1 <= y0:
        return
    ys = np.arange(y0, y1, dtype=np.int64)
    x = np.full((len(edges), len(ys)), np.iinfo(np.int64).max, np.int64)
    for i, (ey0, ey1, ex, edx) in enumerate(edges):
        on = (ys >= ey0) & (ys < ey1)
        x[i, on] = ex + (ys[on] - ey0) * edx
    x.sort(axis=0)
    for a in range(0, len(edges) - 1, 2):
        ok = x[a + 1] != np.iinfo(np.int64).max
        _spans(img, ys[ok], (x[a, ok] + _ONE - 1) >> _SHIFT, x[a + 1, ok] >> _SHIFT, color)


def _fill_disc(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's filled circle (``Circle``): the midpoint scan's row spans."""
    cx, cy = center
    half = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for row, hw in ((dy, dx), (dx, dy)):
            half[row] = max(half.get(row, -1), hw)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    rows = np.array(list(half), np.int64)
    hw = np.array(list(half.values()), np.int64)
    ys = np.concatenate([cy - rows, cy + rows])
    hw = np.concatenate([hw, hw])
    _spans(img, ys, cx - hw, cx + hw, color)


def _fill_rect(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.rectangle(..., -1)``: both corners inclusive, clipped."""
    h, w = img.shape[:2]
    x1, x2 = sorted((p1[0], p2[0]))
    y1, y2 = sorted((p1[1], p2[1]))
    img[max(y1, 0) : max(min(y2 + 1, h), 0), max(x1, 0) : max(min(x2 + 1, w), 0)] = color


def _thick_segment(img: np.ndarray, p0, p1, color, caps: int) -> None:
    """One segment of OpenCV's thick line (``ThickLine``, thickness 3): the
    segment clipped to the image grown by the thickness, its quad (offsets
    rounded to 16.16 fixed point, two pixels either side) and a filled disc
    of radius 2 at the start (``caps & 1``) and at the end (``caps & 2``)."""
    h, w = img.shape[:2]
    t = _THICKNESS
    inside, a, b = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t), (p1[0] + t, p1[1] + t))
    if not inside:
        return
    a = ((a[0] - t) << _SHIFT, (a[1] - t) << _SHIFT)
    b = ((b[0] - t) << _SHIFT, (b[1] - t) << _SHIFT)
    dx = (a[0] - b[0]) / _ONE
    dy = (b[1] - a[1]) / _ONE
    r = dx * dx + dy * dy
    half_width = t << (_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_width + (t & 1) * _ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = [(a[0] + ox, a[1] + oy), (a[0] - ox, a[1] - oy), (b[0] - ox, b[1] - oy), (b[0] + ox, b[1] + oy)]
        _fill_convex(img, quad, color)
    radius = (half_width + _HALF) >> _SHIFT
    for bit, p in ((1, a), (2, b)):
        if caps & bit:
            _fill_disc(img, ((p[0] + _HALF) >> _SHIFT, (p[1] + _HALF) >> _SHIFT), radius, color)


def _polyline(img: np.ndarray, pts: np.ndarray, closed: bool, color) -> None:
    """``cv2.polylines`` with thickness 3: a disc at each segment's end, and
    at the start of an open line."""
    pts = [(int(x), int(y)) for x, y in pts]
    p0 = pts[-1] if closed else pts[0]
    caps = 2 if closed else 3
    for p in pts[0 if closed else 1 :]:
        _thick_segment(img, p0, p, color, caps)
        p0 = p
        caps = 2


def _draw_pitch_lines(img: np.ndarray, H: np.ndarray) -> None:
    """White pitch markings under homography H (world->image)."""

    def wline(a, b, n=32):
        ps = project(H, np.linspace(a, b, n)).astype(np.int32)
        for i in range(n - 1):
            _thick_segment(img, (int(ps[i, 0]), int(ps[i, 1])), (int(ps[i + 1, 0]), int(ps[i + 1, 1])), _WHITE, 3)

    L, W = pitch.PITCH_LENGTH, pitch.PITCH_WIDTH
    # outline + halfway
    wline((0, 0), (L, 0)), wline((0, W), (L, W))
    wline((0, 0), (0, W)), wline((L, 0), (L, W))
    wline((L / 2, 0), (L / 2, W))
    # penalty + goal areas
    for x0, d in [(0.0, 1.0), (L, -1.0)]:
        for depth, half in [(16.5, 20.16), (5.5, 9.16)]:
            wline((x0, 34 - half), (x0 + d * depth, 34 - half))
            wline((x0, 34 + half), (x0 + d * depth, 34 + half))
            wline((x0 + d * depth, 34 - half), (x0 + d * depth, 34 + half))
    # center circle + penalty arcs
    th = np.linspace(0, 2 * np.pi, 90)
    circ = np.stack([L / 2 + 9.15 * np.cos(th), 34 + 9.15 * np.sin(th)], -1)
    _polyline(img, project(H, circ).astype(np.int32), True, _WHITE)
    for cx, d in [(11.0, 1.0), (L - 11.0, -1.0)]:
        a = np.arccos(5.5 / 9.15)
        th = np.linspace(-a, a, 30) if d > 0 else np.linspace(np.pi - a, np.pi + a, 30)
        arc = np.stack([cx + 9.15 * np.cos(th), 34 + 9.15 * np.sin(th)], -1)
        _polyline(img, project(H, arc).astype(np.int32), False, _WHITE)


def _pitch_image(H: np.ndarray, width: int, height: int) -> np.ndarray:
    """The empty pitch under H: grass, mow stripes and markings."""
    img = np.zeros((height, width, 3), dtype=np.uint8)
    img[:] = (60, 140, 70)  # green-ish pitch in BGR
    # mow stripes for texture (helps optical flow find gradients)
    for sx in range(0, 105, 10):
        quad = project(H, [[sx, 0], [sx + 5, 0], [sx + 5, 68], [sx, 68]]).astype(np.int32)
        _fill_poly(img, [(int(x), int(y)) for x, y in quad], (55, 130, 62))
    _draw_pitch_lines(img, H)
    return img


def make_scene(
    num_frames: int = 48,
    width: int = 1280,
    height: int = 720,
    num_players: int = 10,
    fps: int = 24,
    seed: int = 0,
    pan_speed: float = 0.0,
) -> SyntheticScene:
    """Render a deterministic synthetic broadcast clip.

    ``pan_speed`` shifts the camera horizontally (pixels/frame) to exercise
    the optical-flow / homography-update paths.
    """
    rng = np.random.default_rng(seed)
    H0 = default_camera_homography(width, height)

    # players: half per team, random walks inside the central pitch area
    start = rng.uniform([25, 15], [80, 53], size=(num_players, 2))
    vel = rng.uniform(-0.15, 0.15, size=(num_players, 2))
    team = (np.arange(num_players) % 2).astype(np.int32)
    jersey = {0: (40, 40, 215), 1: (200, 140, 30)}  # BGR: red vs blue-ish

    ball0 = np.array([52.5, 34.0])
    ball_vel = np.array([0.35, 0.12])

    frames = np.zeros((num_frames, height, width, 3), dtype=np.uint8)
    player_world = np.zeros((num_frames, num_players, 2))
    player_feet = np.zeros((num_frames, num_players, 2))
    player_boxes = np.zeros((num_frames, num_players, 4))
    ball_world = np.zeros((num_frames, 2))
    ball_image = np.zeros((num_frames, 2))

    background = None
    for t in range(num_frames):
        shift = np.array([[1, 0, pan_speed * t], [0, 1, 0], [0, 0, 1]], dtype=np.float64)
        H = shift @ H0
        if background is None or pan_speed != 0.0:  # a still camera draws one pitch
            background = _pitch_image(H, width, height)
        img = background.copy()

        pw = start + vel * t
        pf = project(H, pw)
        bw = ball0 + ball_vel * t
        bi = project(H, bw[None])[0]

        player_world[t] = pw
        player_feet[t] = pf
        ball_world[t] = bw
        ball_image[t] = bi

        # draw players back-to-front (far = small), boxes anchored at feet
        order = np.argsort(pf[:, 1])
        for p in order:
            u, v = pf[p]
            scale = 0.4 + 0.9 * (v / height)  # crude depth cue
            bw_px, bh_px = 26 * scale, 62 * scale
            x1, y1 = u - bw_px / 2, v - bh_px
            x2, y2 = u + bw_px / 2, v
            player_boxes[t, p] = (x1, y1, x2, y2)
            if x2 < 0 or x1 >= width or y2 < 0 or y1 >= height:
                continue
            # legs (dark), torso (jersey), head (skin)
            _fill_rect(img, (int(x1), int(v - bh_px * 0.45)), (int(x2), int(v)), (30, 30, 30))
            _fill_rect(img, (int(x1), int(y1 + bh_px * 0.18)), (int(x2), int(v - bh_px * 0.45)), jersey[int(team[p])])
            _fill_disc(img, (int(u), int(y1 + bh_px * 0.1)), max(2, int(4 * scale)), (150, 190, 220))
        _fill_disc(img, (int(bi[0]), int(bi[1]) - 4), 5, (250, 250, 250))
        frames[t] = img

    kp_img = project(H0, pitch.WORLD_XY)
    return SyntheticScene(
        frames=frames,
        H_world_to_image=H0,
        H_image_to_world=np.linalg.inv(H0),
        player_world=player_world,
        player_feet_image=player_feet,
        player_boxes=player_boxes,
        player_team=team,
        ball_world=ball_world,
        ball_image=ball_image,
        keypoints_image=kp_img,
        fps=fps,
    )
