"""Pairwise baseline distance core (port copy of
``citlab_as_tpu/geometry/pairwise.py``: ``min_perpendicular_distances``,
``calc_interline_distances`` and the AS measure's ``calc_tols``).

This replaces the Java hot-loop kernel ``java_util/Util.class``
(``calcInterlineDistances`` / the tolerance loop of
``calcMetricForPageBaseLinePolys``). The reference's Python fallbacks define
the exact semantics (dbscan_baselines.py:63-110, geometry/util.py:831-902):

for each polygon *a* (with regression-angle orientation vector), scan pixels
``p_a`` in order; for each other polygon *b* (in list order):

  1. skip *b* if the L1 point-to-bbox distance exceeds the **running**
     minimum ``dist`` (order-dependent shrinking-skip — replicated exactly);
  2. skip *b* unless its two endpoints straddle poly-a's endpoints in the
     inline direction (the four-in-dist sign gate);
  3. over eligible pixels ``p_b`` (|inline dist| <= 2*tick), shrink ``dist``
     by the minimum |offline dist|.

The implementation vectorizes everything except the running-minimum scan,
which is evaluated exactly via an epoch scan: ``dist`` changes at most at a
handful of indices, and each segment between changes is found with one
vectorized ``argmax``.

The port's host C++ library (``citlab_as_tpu_torch.geometry.native``)
implements the same loop nest directly and is what
``calc_interline_distances`` runs; ``min_perpendicular_distances`` is its
plain version, equal to it within 1e-9 (tested: the library is built with
``-march=native``, so the compiler fuses multiply-adds that numpy rounds
twice).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

import math

from citlab_as_tpu_torch.geometry.polygon import Polygon


def _sequential_skip_min(bbox_dists: np.ndarray, cand_mins: np.ndarray, max_d: float) -> float:
    """Exact evaluation of::

        dist = max_d
        for i in range(len(bbox_dists)):
            if bbox_dists[i] > dist: continue
            dist = min(dist, cand_mins[i])

    via epoch scan: find the first index where both ``bbox_dists[i] <= dist``
    and ``cand_mins[i] < dist`` hold, update, repeat from i+1.
    """
    dist = float(max_d)
    pos = 0
    n = bbox_dists.shape[0]
    while pos < n:
        hit = (bbox_dists[pos:] <= dist) & (cand_mins[pos:] < dist)
        if not hit.any():
            break
        i = int(np.argmax(hit))
        dist = float(cand_mins[pos + i])
        pos += i + 1
    return dist


def _reg_line_angle(poly: Polygon) -> float:
    """Baseline orientation in [0, 2*pi) as the host library computes it
    (``reg_line_angle`` in ``csrc/geometry_host.cpp``): the regression
    slope from the 2x2 normal equations on (x, -y), summed left to right,
    with ``calc_reg_line_stats``'s quadrant fixups (polygon.py:271-319).
    ``calc_reg_line_stats`` solves the same fit by least squares, which can
    differ in the last bits; this is the formula the C++ loop uses."""
    xs, ys = poly.x_points, poly.y_points
    n = len(xs)
    if n <= 1:
        return 0.0
    inf_slope = False
    m = 0.0
    if n > 2:
        xmax, xmin = max(xs), min(xs)
        if xmax == xmin or xmax - xmin < 2:
            inf_slope = True
        else:
            s1, sx, sxx, sy, sxy = float(n), 0.0, 0.0, 0.0, 0.0
            for xi, yi in zip(xs, ys):
                xi, yi = float(xi), -float(yi)
                sx += xi
                sxx += xi * xi
                sy += yi
                sxy += xi * yi
            det = s1 * sxx - sx * sx
            if det < 1e-9:
                inf_slope = True
            else:
                m = (s1 * sxy - sx * sy) / det
    else:
        x1, x2 = float(xs[0]), float(xs[1])
        y1, y2 = -float(ys[0]), -float(ys[1])
        if x1 == x2:
            inf_slope = True
        else:
            m = (y2 - y1) / (x2 - x1)
    angle = math.pi / 2 if inf_slope else math.atan(m)
    if -math.pi / 2 < angle <= -math.pi / 4 and ys[0] > ys[-1]:
        angle += math.pi
    if -math.pi / 4 < angle <= math.pi / 4 and xs[0] > xs[-1]:
        angle += math.pi
    if math.pi / 4 < angle < math.pi / 2 and ys[0] < ys[-1]:
        angle += math.pi
    if angle < 0:
        angle += 2 * math.pi
    return angle


def min_perpendicular_distances(
    normed_polys: Sequence[Polygon],
    tick_dist: float,
    max_d: float,
) -> List[float]:
    """Per-polygon minimum perpendicular (offline) distance to any other
    polygon, gated by the inline window |in| <= 2*tick_dist.

    Returns ``max_d`` for polygons with no qualifying neighbor. Callers:
    interline distances (tick_dist = des_dist) and ``calc_tols``
    (tick_dist = tick_dist, then 0-substitution + mean-fill downstream).
    """
    n = len(normed_polys)
    if n == 0:
        return []
    if n == 1:
        return [float(max_d)]

    max_p = max(p.n_points for p in normed_polys)
    pts = np.zeros((n, max_p, 2), dtype=np.float64)
    mask = np.zeros((n, max_p), dtype=bool)
    first = np.zeros((n, 2), dtype=np.float64)
    last = np.zeros((n, 2), dtype=np.float64)
    bb = np.zeros((n, 4), dtype=np.float64)  # x, y, x+w, y+h

    for i, p in enumerate(normed_polys):
        arr = p.to_array().astype(np.float64)
        k = arr.shape[0]
        pts[i, :k] = arr
        mask[i, :k] = True
        first[i] = arr[0]
        last[i] = arr[-1]
        b = p.get_bounding_box()
        bb[i] = (b.x, b.y, b.x + b.width, b.y + b.height)

    angles = [_reg_line_angle(p) for p in normed_polys]
    or_x = np.array([math.cos(a) for a in angles])
    or_y = np.array([math.sin(a) for a in angles])

    # bbox-to-bbox L1 gap prefilter: pairs farther than max_d can never pass
    # the running-skip (dist <= max_d always), so dropping them is exact.
    gap_x = np.maximum(0.0, np.maximum(bb[:, None, 0] - bb[None, :, 2], bb[None, :, 0] - bb[:, None, 2]))
    gap_y = np.maximum(0.0, np.maximum(bb[:, None, 1] - bb[None, :, 3], bb[None, :, 1] - bb[:, None, 3]))
    near = (gap_x + gap_y) <= max_d

    out = []
    for a in range(n):
        ox, oy = or_x[a], or_y[a]
        cand = np.flatnonzero(near[a])
        cand = cand[cand != a]
        if cand.size == 0:
            out.append(float(max_d))
            continue

        # endpoint straddle gate (vectorized over candidate polys)
        def in_dist(p1, p2x, p2y):
            return (p1[0] - p2x) * ox + (-p1[1] + p2y) * oy

        a1, a2 = first[a], last[a]
        b1x, b1y = first[cand, 0], first[cand, 1]
        b2x, b2y = last[cand, 0], last[cand, 1]
        d11 = in_dist(a1, b1x, b1y)
        d12 = in_dist(a1, b2x, b2y)
        d21 = in_dist(a2, b1x, b1y)
        d22 = in_dist(a2, b2x, b2y)
        all_neg = (d11 < 0) & (d12 < 0) & (d21 < 0) & (d22 < 0)
        all_pos = (d11 > 0) & (d12 > 0) & (d21 > 0) & (d22 > 0)
        gate = ~(all_neg | all_pos)

        pa = pts[a][mask[a]]  # [Pa, 2]
        q = pts[cand]         # [M, P, 2]
        qm = mask[cand]       # [M, P]

        dx = pa[:, None, None, 0] - q[None, :, :, 0]
        dy = -pa[:, None, None, 1] + q[None, :, :, 1]
        ind = dx * ox + dy * oy
        offd = np.abs(dx * oy - dy * ox)
        elig = (np.abs(ind) <= 2.0 * tick_dist) & qm[None, :, :] & gate[None, :, None]
        offd = np.where(elig, offd, np.inf)
        cand_min = offd.min(axis=2)  # [Pa, M]

        # point-to-bbox L1 distance for the running skip
        bx1, by1, bx2, by2 = bb[cand, 0], bb[cand, 1], bb[cand, 2], bb[cand, 3]
        ddx = np.maximum(0.0, bx1[None, :] - pa[:, None, 0]) + np.maximum(0.0, pa[:, None, 0] - bx2[None, :])
        ddy = np.maximum(0.0, by1[None, :] - pa[:, None, 1]) + np.maximum(0.0, pa[:, None, 1] - by2[None, :])
        bbox_d = ddx + ddy  # [Pa, M]

        out.append(_sequential_skip_min(bbox_d.ravel(), cand_min.ravel(), max_d))

    return out


def calc_interline_distances(
    normed_polys: Sequence[Polygon], des_dist: int = 5, max_d: int = 500
) -> List[float]:
    """Interline distance per normed baseline (dbscan_baselines.py:63-110 /
    Java ``calcInterlineDistances``). Polygons must already be normed via
    ``norm_poly_dists``; returns max_d where no neighbor qualifies.

    Runs in the host C++ library; :func:`min_perpendicular_distances` is the
    plain version."""
    from citlab_as_tpu_torch.geometry.native import interline_distances_normed
    return interline_distances_normed(normed_polys, des_dist, max_d)


def calc_tols_plain(polys_truth: Sequence[Polygon], tick_dist: int = 5,
                    max_d: int = 250, rel_tol: float = 0.25) -> np.ndarray:
    """Per-GT-baseline tolerance values of the AS measure, in numpy (the
    plain version of :func:`calc_tols`): min perpendicular distance to the
    other baselines, 0 where none is found, then mean-fill the zeros, clip
    at the mean, scale by ``rel_tol`` (geometry/util.py:831-902, after
    arXiv 1705.03311)."""
    dists = min_perpendicular_distances(polys_truth, tick_dist=tick_dist, max_d=max_d)
    tols = np.array([d if d < max_d else 0.0 for d in dists], dtype=np.float64)
    nonzero = tols[tols != 0]
    mean_tols = float(nonzero.sum() / nonzero.size) if nonzero.size else float(max_d)
    tols = np.where(tols == 0, mean_tols, tols)
    tols = np.minimum(tols, mean_tols)
    return tols * rel_tol


def calc_tols(polys_truth: Sequence[Polygon], tick_dist: int = 5, max_d: int = 250,
              rel_tol: float = 0.25) -> np.ndarray:
    """:func:`calc_tols_plain` in the host C++ library (``gk_calc_tols``);
    the polygons must already be normed."""
    from citlab_as_tpu_torch.geometry.native import calc_tols_native
    return calc_tols_native(polys_truth, tick_dist, max_d, rel_tol)
