"""Geometry utilities (port copy of the part of
``citlab_as_tpu/geometry/util.py`` that the text-region and feature stages
reach: ``bounding_box``, ``convex_hull``, ``alpha_shape`` and its helpers).

Semantics follow python_util/geometry/util.py (file:line cites inline).
``alpha_shape`` runs in the port's host C++ library
(``geometry/native.py``); ``alpha_shape_plain`` is its numpy/scipy plain
version.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay

__all__ = ["bounding_box", "convex_hull", "alpha_shape", "alpha_shape_plain"]


def bounding_box(points) -> List[Tuple[int, int]]:
    """Axis-aligned bounding box vertices of a point list (util.py:508-520)."""
    xs, ys = zip(*points)
    return [(min(xs), min(ys)), (max(xs), min(ys)), (max(xs), max(ys)), (min(xs), max(ys))]


def convex_hull(points) -> List[Tuple[int, int]]:
    """Andrew's monotone chain (util.py:523-565). Returns hull CCW in image
    coords (lower hull then upper hull, endpoints dropped)."""

    def turn_left(p, q, r):
        return (q[0] - p[0]) * (r[1] - p[1]) - (r[0] - p[0]) * (q[1] - p[1]) > 0

    sorted_points = sorted(points)
    lower: list = []
    for pt in sorted_points:
        while len(lower) > 1 and not turn_left(lower[-2], lower[-1], pt):
            lower.pop()
        lower.append(pt)
    upper: list = []
    for pt in reversed(sorted_points):
        while len(upper) > 1 and not turn_left(upper[-2], upper[-1], pt):
            upper.pop()
        upper.append(pt)
    return lower[:-1] + upper[:-1]


def alpha_shape(points: np.ndarray, alpha: float) -> List[list]:
    """Alpha shape (concave hull) of 2-D points (util.py:568-697), closed
    (first point repeated), in the host C++ library: sweep-circle Delaunay,
    circumradius filter, unpaired-edge boundary walk and the 20 % escalation
    in one call (``gk_alpha_shape``). Where the C++ walk gives up (a
    collinear cloud, or no single circle after 64 escalations) the
    reference's own continuation runs: :func:`alpha_shape_plain` over the
    C++ triangulation. :func:`alpha_shape_plain` is the plain version."""
    assert alpha > 0, "alpha value has to be greater than zero"
    points = np.asarray(points)
    if points.shape[0] <= 3:
        boundary = points.tolist()
        boundary.append(boundary[0])
        return boundary
    from citlab_as_tpu_torch.geometry.native import alpha_shape_indices, delaunay
    idx = alpha_shape_indices(points, alpha)
    if idx is not None:
        boundary_points = points[idx].tolist()
        boundary_points.append(boundary_points[0])
        return boundary_points
    return alpha_shape_plain(points, alpha, simplices=delaunay(points))


def alpha_shape_plain(points: np.ndarray, alpha: float,
                      simplices: Optional[np.ndarray] = None) -> List[list]:
    """numpy/scipy version of :func:`alpha_shape` (util.py:568-697).

    Keeps Delaunay triangles with circumradius < alpha; boundary edges are
    the unpaired triangle edges, ordered into a single closed circle. On a
    degenerate boundary (disconnected circles or a vertex used > 2 times)
    the alpha value escalates by 20% and the computation restarts — the
    reference's recursive escalation, expressed as a loop. ``simplices``:
    the triangulation to use [T, 3]; None -> scipy's qhull. Any valid
    Delaunay triangle set gives the same boundary wherever the
    triangulation is unique; on co-circular points pass the C++
    triangulation (``geometry/native.py::delaunay``) to reproduce
    :func:`alpha_shape`."""
    assert alpha > 0, "alpha value has to be greater than zero"
    points = np.asarray(points)

    if points.shape[0] <= 3:
        boundary = points.tolist()
        boundary.append(boundary[0])
        return boundary

    if simplices is None:
        simplices = Delaunay(points).simplices  # [T, 3]

    if simplices.shape[0] <= 160:
        # small clouds (a text line's point set): floats and dicts compute
        # the identical result with less overhead than numpy; same scan
        # order, same escalation
        return _alpha_shape_small(points, simplices, alpha)

    pa = points[simplices[:, 0]].astype(np.float64)
    pb = points[simplices[:, 1]].astype(np.float64)
    pc = points[simplices[:, 2]].astype(np.float64)
    a = np.linalg.norm(pa - pb, axis=1)
    b = np.linalg.norm(pb - pc, axis=1)
    c = np.linalg.norm(pc - pa, axis=1)
    s = (a + b + c) / 2.0
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
    circum_r = a * b * c / (4.0 * (area + 1e-8))

    # directed edges per triangle [T, 3, 2] + canonical undirected encodings,
    # computed once; the per-alpha boundary extraction below is pure numpy
    tri_edges = np.stack([simplices[:, [0, 1]], simplices[:, [1, 2]],
                          simplices[:, [2, 0]]], axis=1)
    canon = (tri_edges.min(-1).astype(np.int64) * points.shape[0]
             + tri_edges.max(-1))                        # [T, 3]

    while True:
        keep = circum_r < alpha
        # boundary edges = edges appearing exactly once among kept triangles,
        # in first-occurrence scan order (matches the reference's dict order)
        kept_keys = canon[keep].ravel()
        kept_dirs = tri_edges[keep].reshape(-1, 2)
        _, first_idx, counts = np.unique(kept_keys, return_index=True,
                                         return_counts=True)
        edges = [(int(kept_dirs[i, 0]), int(kept_dirs[i, 1]))
                 for i in np.sort(first_idx[counts == 1])]

        boundary = _order_boundary(edges)
        if boundary is None:
            alpha += alpha * 0.2
            continue

        boundary_points = [points[e[0]].tolist() for e in boundary]
        boundary_points.append(boundary_points[0])
        return boundary_points


def _alpha_shape_small(points: np.ndarray, simplices: np.ndarray,
                       alpha: float) -> List[list]:
    """Plain-Python tail of :func:`alpha_shape` for few triangles — result
    (values, scan order, escalation) identical to the vectorized path; the
    circumradius math runs in float64 either way."""
    from math import sqrt

    pts = points.tolist()
    tris = simplices.tolist()
    n = points.shape[0]
    circum_r = []
    for i0, i1, i2 in tris:
        (x0, y0), (x1, y1), (x2, y2) = pts[i0], pts[i1], pts[i2]
        a = sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
        b = sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
        c = sqrt((x2 - x0) ** 2 + (y2 - y0) ** 2)
        s = (a + b + c) / 2.0
        area = sqrt(max(s * (s - a) * (s - b) * (s - c), 0.0))
        circum_r.append(a * b * c / (4.0 * (area + 1e-8)))

    while True:
        first: dict = {}   # canonical key -> (first directed edge, count)
        for t, (i0, i1, i2) in enumerate(tris):
            if not circum_r[t] < alpha:
                continue
            for u, v in ((i0, i1), (i1, i2), (i2, i0)):
                key = (u * n + v) if u < v else (v * n + u)
                entry = first.get(key)
                if entry is None:
                    first[key] = [(u, v), 1]
                else:
                    entry[1] += 1
        # dicts preserve insertion order == first-occurrence scan order
        edges = [e for e, cnt in first.values() if cnt == 1]

        boundary = _order_boundary(edges)
        if boundary is None:
            alpha += alpha * 0.2
            continue
        boundary_points = [list(pts[e[0]]) for e in boundary]
        boundary_points.append(boundary_points[0])
        return boundary_points


def _order_boundary(edges: List[Tuple[int, int]]) -> Optional[List[Tuple[int, int]]]:
    """Order undirected boundary edges into one closed circle. Returns None if
    the boundary is empty, splits into several circles, or a vertex is used
    more than twice (the reference's escalation triggers, util.py:674-687)."""
    if not edges:
        return None
    adj: Dict[int, List[int]] = {}
    for i, j in edges:
        adj.setdefault(i, []).append(j)
        adj.setdefault(j, []).append(i)
    # every vertex must be used exactly twice (a vertex used > 2 times or an
    # open chain both trigger the reference's escalation)
    if any(len(v) != 2 for v in adj.values()):
        return None

    start = edges[0][0]
    circle = [start]
    prev = None
    cur = start
    while True:
        nxt = adj[cur][0] if adj[cur][0] != prev else adj[cur][1]
        if nxt == start:
            break
        circle.append(nxt)
        prev, cur = cur, nxt
        if len(circle) > len(edges):
            return None  # safety: malformed boundary
    if len(circle) != len(edges):
        return None  # several disjoint circles
    return [(circle[i], circle[(i + 1) % len(circle)]) for i in range(len(circle))]
