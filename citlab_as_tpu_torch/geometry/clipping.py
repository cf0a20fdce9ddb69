"""Exact polygon boolean operations via slab decomposition (port copy of
``citlab_as_tpu/geometry/clipping.py``).

GEOS/shapely replacement for the region-valued booleans the separator page
writer needs (reference: separator_region_to_page_writer.py:107-387 uses
shapely ``difference``/``intersection``). The algorithm:

1. collect the non-horizontal edges of both operands (even-odd rings);
2. events = every endpoint y + every A-edge x B-edge crossing y; between
   consecutive events each surviving edge spans the whole slab and the
   edges are x-ordered without crossings;
3. sweep each slab left to right tracking the even-odd parity of A and B;
   regions where the boolean predicate holds are emitted as trapezoids;
4. trapezoid boundaries are emitted as directed segments with a consistent
   winding; interior seams cancel (exact duplicates for slab-spanning
   edges, signed interval coverage for horizontal seams at event rows) and
   the survivors are linked head-to-tail into rings;
5. rings with positive signed area are exteriors, negative are holes;
   holes attach to the smallest enclosing exterior.

This handles all degenerate cases the pixel-aligned polygons of this
pipeline produce (shared vertices, collinear overlapping edges, tangencies)
without perturbation: coincident edges simply bound zero-width trapezoid
regions, and duplicate boundary pieces cancel. Coordinates are float64;
linking snaps to a 1e-6 grid (page coordinates are < 1e5, so float error
from independent edge evaluations at a crossing event is << the snap).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

Ring = List[Tuple[float, float]]
Rings = List[Ring]

_SNAP = 1e-6


def _edge_array(rings: Rings) -> np.ndarray:
    """Non-horizontal edges as [E, 4] (x1, y1, x2, y2), rings closed."""
    segs = []
    for ring in rings:
        arr = np.asarray(ring, np.float64)
        if arr.shape[0] < 2:
            continue
        if not np.array_equal(arr[0], arr[-1]):
            arr = np.vstack([arr, arr[:1]])
        d = arr[1:] - arr[:-1]
        keep = d[:, 1] != 0.0
        if keep.any():
            segs.append(np.hstack([arr[:-1][keep], arr[1:][keep]]))
    if not segs:
        return np.zeros((0, 4), np.float64)
    return np.vstack(segs)


def _crossing_ys(ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """y coordinates of proper interior crossings between edge sets."""
    if ea.shape[0] == 0 or eb.shape[0] == 0:
        return np.zeros(0, np.float64)
    ax1, ay1, ax2, ay2 = (ea[:, i][:, None] for i in range(4))
    bx1, by1, bx2, by2 = (eb[:, i][None, :] for i in range(4))
    dax, day = ax2 - ax1, ay2 - ay1
    dbx, dby = bx2 - bx1, by2 - by1
    denom = dax * dby - day * dbx
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((bx1 - ax1) * dby - (by1 - ay1) * dbx) / denom
        u = ((bx1 - ax1) * day - (by1 - ay1) * dax) / denom
    valid = np.isfinite(t) & (t > 0) & (t < 1) & (u > 0) & (u < 1)
    return (ay1 + t * day)[valid]


def _x_at(edges: np.ndarray, y: float) -> np.ndarray:
    x1, y1, x2, y2 = edges[:, 0], edges[:, 1], edges[:, 2], edges[:, 3]
    return x1 + (y - y1) * (x2 - x1) / (y2 - y1)


_PREDICATES = {
    "difference": lambda a, b: a & ~b,
    "intersection": lambda a, b: a & b,
    "union": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
}


def _sweep_trapezoids(a: Rings, b: Rings, op: str):
    """Yield predicate-true trapezoids (y0, y1, xl0, xl1, xr0, xr1)."""
    pred = _PREDICATES[op]
    ea, eb = _edge_array(a), _edge_array(b)
    edges = np.vstack([ea, eb])
    if edges.shape[0] == 0:
        return
    from_a = np.zeros(edges.shape[0], bool)
    from_a[:ea.shape[0]] = True

    ys = np.concatenate([edges[:, 1], edges[:, 3], _crossing_ys(ea, eb)])
    ys = np.unique(ys)
    if ys.shape[0] < 2:
        return

    ymin = np.minimum(edges[:, 1], edges[:, 3])
    ymax = np.maximum(edges[:, 1], edges[:, 3])

    for y0, y1 in zip(ys[:-1], ys[1:]):
        ym = (y0 + y1) / 2.0
        live = (ymin <= ym) & (ymax >= ym)
        if not live.any():
            continue
        e = edges[live]
        ea_live = from_a[live]
        xm = _x_at(e, ym)
        order = np.argsort(xm, kind="stable")
        e, ea_live, xm = e[order], ea_live[order], xm[order]
        x_lo, x_hi = _x_at(e, y0), _x_at(e, y1)

        in_a = in_b = False
        for i in range(e.shape[0] - 1):
            if ea_live[i]:
                in_a = not in_a
            else:
                in_b = not in_b
            if not pred(in_a, in_b):
                continue
            if xm[i + 1] - xm[i] <= 0 and x_lo[i + 1] - x_lo[i] <= 0 \
                    and x_hi[i + 1] - x_hi[i] <= 0:
                continue  # zero-width region between coincident edges
            yield (float(y0), float(y1), float(x_lo[i]), float(x_hi[i]),
                   float(x_lo[i + 1]), float(x_hi[i + 1]))


def boolean_area(a: Rings, b: Rings, op: str = "intersection") -> float:
    """Exact area of the boolean combination (sum of trapezoid areas)."""
    area = 0.0
    for y0, y1, xl0, xl1, xr0, xr1 in _sweep_trapezoids(a, b, op):
        area += ((xr0 - xl0) + (xr1 - xl1)) / 2.0 * (y1 - y0)
    return area


def _key(x: float, y: float) -> Tuple[int, int]:
    return (int(round(x / _SNAP)), int(round(y / _SNAP)))


def _horizontal_pieces(cover: Dict[float, List[Tuple[float, float, int]]]):
    """Net signed horizontal boundary pieces per seam row.

    ``cover[y]`` holds (x_left, x_right, sign) intervals: +1 for trapezoid
    bottoms, -1 for tops. Where the net coverage is +1 the boundary runs
    left-to-right, -1 right-to-left, 0 it is an interior seam.
    """
    out = []
    for y, intervals in cover.items():
        xs = np.unique(np.asarray(
            [x for x0, x1, _ in intervals for x in (x0, x1)], np.float64))
        if xs.shape[0] < 2:
            continue
        mids = (xs[:-1] + xs[1:]) / 2.0
        net = np.zeros(mids.shape[0], np.int64)
        for x0, x1, sign in intervals:
            net[(mids > x0) & (mids < x1)] += sign
        for j in range(mids.shape[0]):
            if net[j] > 0:
                out.append(((xs[j], y), (xs[j + 1], y)))
            elif net[j] < 0:
                out.append(((xs[j + 1], y), (xs[j], y)))
    return out


def _pick_leftmost(segments, cands: List[int], d_in) -> int:
    """Junction rule: choose the candidate making the sharpest LEFT turn
    relative to the incoming direction (smallest CCW angle in (0, 2pi]).

    Every directed boundary piece keeps the polygon interior on its left, so
    the leftmost turn continues the boundary of the same face — regions that
    only touch at a vertex stay separate rings instead of being chained into
    one self-touching ring (mirrors the crack-follow rule in ops/contours.py).
    """
    ang_in = math.atan2(d_in[1], d_in[0])
    best_j, best_a = cands[0], float("inf")
    for j in cands:
        p, q = segments[j]
        a = (math.atan2(q[1] - p[1], q[0] - p[0]) - ang_in) % (2 * math.pi)
        if a <= 1e-12:
            a = 2 * math.pi  # straight-ahead loses to any genuine left turn
        if a < best_a:
            best_a, best_j = a, j
    return best_j


def _link_rings(segments) -> List[Ring]:
    """Chain directed segments head-to-tail into closed rings."""
    by_start: Dict[Tuple[int, int], List[int]] = {}
    for i, (p, q) in enumerate(segments):
        by_start.setdefault(_key(*p), []).append(i)
    used = [False] * len(segments)
    rings: List[Ring] = []
    for i in range(len(segments)):
        if used[i]:
            continue
        used[i] = True
        start_key = _key(*segments[i][0])
        ring = [segments[i][0], segments[i][1]]
        cur = _key(*segments[i][1])
        while cur != start_key:
            cands = [j for j in by_start.get(cur, []) if not used[j]]
            if not cands:
                break  # open chain (numerical orphan) — drop it
            if len(cands) == 1:
                j = cands[0]
            else:
                p, q = ring[-2], ring[-1]
                j = _pick_leftmost(segments, cands,
                                   (q[0] - p[0], q[1] - p[1]))
            used[j] = True
            ring.append(segments[j][1])
            cur = _key(*segments[j][1])
        if cur == start_key and len(ring) >= 4:
            rings.append(_simplify_ring(ring[:-1]))
    return [r for r in rings if len(r) >= 3]


def _simplify_ring(ring: Ring) -> Ring:
    """Drop repeated and collinear intermediate vertices.

    Two separate passes: near-duplicates first (junction self-loops produce
    consecutive vertices ~1e-14 apart), THEN collinearity against the KEPT
    neighbors — a single fused pass tested each vertex against its original
    neighbor, so a vertex following a dropped near-duplicate saw a ~0-length
    incoming edge, its cross product vanished, and real corners cascaded
    away (measured: a 769-area ring simplified to 647)."""
    pts: Ring = []
    for q in ring:
        if pts and math.hypot(q[0] - pts[-1][0], q[1] - pts[-1][1]) < _SNAP:
            continue
        pts.append((float(q[0]), float(q[1])))
    while len(pts) > 1 and math.hypot(pts[0][0] - pts[-1][0],
                                      pts[0][1] - pts[-1][1]) < _SNAP:
        pts.pop()
    changed = True
    while changed and len(pts) >= 3:
        changed = False
        out: Ring = []
        n = len(pts)
        for i in range(n):
            p, q, r = pts[i - 1], pts[i], pts[(i + 1) % n]
            cross = (q[0] - p[0]) * (r[1] - p[1]) \
                - (q[1] - p[1]) * (r[0] - p[0])
            if abs(cross) < _SNAP:
                changed = True
                continue
            out.append(q)
        pts = out
    return pts


def _signed_area(ring: Ring) -> float:
    arr = np.asarray(ring, np.float64)
    x, y = arr[:, 0], arr[:, 1]
    return float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)) / 2.0


def _point_in_ring(point, ring) -> bool:
    arr = np.asarray(ring, np.float64)
    px, py = float(point[0]), float(point[1])
    x, y = arr[:, 0], arr[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    crosses = (y > py) != (yp > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_at = (xp - x) * (py - y) / (yp - y) + x
    return bool(np.count_nonzero(crosses & (px < x_at)) % 2)


def polygon_boolean(a: Rings, b: Rings, op: str = "difference") -> List[Rings]:
    """Boolean combination of two even-odd polygons -> list of polygons
    (each [exterior, holes...]). Exact up to float64 / the 1e-6 link snap."""
    cover: Dict[float, List[Tuple[float, float, int]]] = {}
    segments = []
    for y0, y1, xl0, xl1, xr0, xr1 in _sweep_trapezoids(a, b, op):
        # CCW in (x right, y up): right edge ascends, left edge descends
        if xl0 != xr0 or xl1 != xr1:
            segments.append(((xr0, y0), (xr1, y1)))
            segments.append(((xl1, y1), (xl0, y0)))
        cover.setdefault(y0, []).append((min(xl0, xr0), max(xl0, xr0), +1))
        cover.setdefault(y1, []).append((min(xl1, xr1), max(xl1, xr1), -1))

    # slab-spanning seams shared by adjacent trapezoids cancel exactly
    seen: Dict[Tuple[Tuple[int, int], Tuple[int, int]], int] = {}
    for p, q in segments:
        k = (_key(*p), _key(*q))
        seen[k] = seen.get(k, 0) + 1
    survivors = []
    for p, q in segments:
        k, rk = (_key(*p), _key(*q)), (_key(*q), _key(*p))
        if seen.get(rk, 0) > 0 and seen.get(k, 0) > 0:
            seen[k] -= 1
            seen[rk] -= 1
            continue
        if seen.get(k, 0) > 0:
            seen[k] -= 1
            survivors.append((p, q))
    survivors.extend(_horizontal_pieces(cover))
    # zero-length in snap space (p and q round to the same grid point):
    # these are float-noise self-loops whose direction is meaningless —
    # they would feed garbage angles to the junction rule in _link_rings
    survivors = [(p, q) for p, q in survivors if _key(*p) != _key(*q)]

    rings = _link_rings(survivors)
    exteriors = [(r, _signed_area(r)) for r in rings if _signed_area(r) > 0]
    holes = [r for r in rings if _signed_area(r) < 0]

    polys: List[Rings] = [[ext] for ext, _ in exteriors]
    for hole in holes:
        cx = float(np.mean([p[0] for p in hole]))
        cy = float(np.mean([p[1] for p in hole]))
        best, best_area = None, np.inf
        for idx, (ext, area) in enumerate(exteriors):
            if area < best_area and (
                    _point_in_ring((cx, cy), ext)
                    or _point_in_ring(hole[0], ext)):
                best, best_area = idx, area
        if best is not None:
            polys[best].append(hole)
    return [p for p in polys if p]
