"""Matplotlib UEFA-pitch plotting helpers (counterpart of
``eagle_tpu/utils/pitchplot.py``), on this package's ``pitch`` constants.

The reference's examples use the external mplsoccer package; this module
gives the subset they need -- the pitch's lines drawn onto an axes, and
team Voronoi regions clipped to the pitch -- for plotting the port's
output.  Host code only: matplotlib is imported by the caller, who passes
the axes; scipy's ``Voronoi`` does the geometry.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Voronoi

from eagle_tpu_torch import pitch as P


def draw_pitch(ax, line_color="white", pitch_color="black", linewidth=0.8):
    """Draw a UEFA 105x68 pitch onto a matplotlib axes."""
    ax.set_facecolor(pitch_color)
    L, W = P.PITCH_LENGTH, P.PITCH_WIDTH

    def line(x0, y0, x1, y1):
        ax.plot([x0, x1], [y0, y1], color=line_color, linewidth=linewidth, zorder=2)

    # outline + halfway
    line(0, 0, L, 0), line(0, W, L, W), line(0, 0, 0, W), line(L, 0, L, W)
    line(L / 2, 0, L / 2, W)
    # penalty + goal areas + goals
    for x0, d in ((0.0, 1.0), (L, -1.0)):
        for depth, half in ((P.PENALTY_AREA_DEPTH, P.PENALTY_AREA_HALF_SPAN),
                            (P.GOAL_AREA_DEPTH, P.GOAL_AREA_HALF_SPAN)):
            line(x0, 34 - half, x0 + d * depth, 34 - half)
            line(x0, 34 + half, x0 + d * depth, 34 + half)
            line(x0 + d * depth, 34 - half, x0 + d * depth, 34 + half)
        # goal box
        line(x0, 34 - P.GOAL_HALF_SPAN, x0 - d * 2, 34 - P.GOAL_HALF_SPAN)
        line(x0, 34 + P.GOAL_HALF_SPAN, x0 - d * 2, 34 + P.GOAL_HALF_SPAN)
        line(x0 - d * 2, 34 - P.GOAL_HALF_SPAN, x0 - d * 2, 34 + P.GOAL_HALF_SPAN)
    # center circle + spots + penalty arcs
    th = np.linspace(0, 2 * np.pi, 120)
    ax.plot(L / 2 + P.CIRCLE_RADIUS * np.cos(th), 34 + P.CIRCLE_RADIUS * np.sin(th),
            color=line_color, linewidth=linewidth, zorder=2)
    for cx, d in ((P.PENALTY_MARK_DIST, 1.0), (L - P.PENALTY_MARK_DIST, -1.0)):
        a = np.arccos((P.PENALTY_AREA_DEPTH - P.PENALTY_MARK_DIST) / P.CIRCLE_RADIUS)
        t = np.linspace(-a, a, 40) if d > 0 else np.linspace(np.pi - a, np.pi + a, 40)
        ax.plot(cx + P.CIRCLE_RADIUS * np.cos(t), 34 + P.CIRCLE_RADIUS * np.sin(t),
                color=line_color, linewidth=linewidth, zorder=2)
        ax.scatter([cx], [34], color=line_color, s=2, zorder=2)
    ax.scatter([L / 2], [34], color=line_color, s=2, zorder=2)
    ax.set_xlim(-4, L + 4)
    ax.set_ylim(-4, W + 4)
    ax.set_aspect("equal")
    ax.axis("off")
    return ax


def voronoi_polygons(xs, ys, teams):
    """Team-split Voronoi regions clipped to the pitch (the mplsoccer
    ``pitch.voronoi`` contract): returns (team0_polys, team1_polys), each a
    list of (N, 2) polygon vertex arrays.

    Clipping uses the reflection trick: every point mirrored across each
    pitch edge guarantees all interior regions are finite and bounded by
    the pitch rectangle.
    """
    pts = np.column_stack([np.asarray(xs, float), np.asarray(ys, float)])
    teams = np.asarray(teams)
    L, W = P.PITCH_LENGTH, P.PITCH_WIDTH
    mirrored = [pts]
    for axis, bound in ((0, 0.0), (0, L), (1, 0.0), (1, W)):
        m = pts.copy()
        m[:, axis] = 2 * bound - m[:, axis]
        mirrored.append(m)
    vor = Voronoi(np.vstack(mirrored))

    out0, out1 = [], []
    for i in range(len(pts)):
        region = vor.regions[vor.point_region[i]]
        if -1 in region or not region:
            continue
        poly = vor.vertices[region]
        poly = np.clip(poly, [0, 0], [L, W])
        (out0 if teams[i] == 0 else out1).append(poly)
    return out0, out1
