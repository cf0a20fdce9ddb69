"""2-D polygon boolean operations, a GEOS/shapely replacement (port copy of
``citlab_as_tpu/geometry/booleans.py``).

The separator page writer (reference:
separator_region_to_page_writer.py:107-387) splits text lines and baselines
at vertical separators with shapely. Shapely is not a dependency here;
instead:

- predicates (intersects/contains/area) are exact vector geometry;
- region-valued booleans (polygon difference / intersection area) are exact
  slab-sweep clipping (geometry/clipping.py); a 1-px rasterization variant
  remains as the property-test oracle;
- polyline (baseline) splitting against a polygon is exact parametric
  clipping.

A polygon is a list of rings, each ring a list of (x, y); ring[0] is the
exterior, the rest are holes (even-odd semantics).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi

from citlab_as_tpu_torch.ops.contours import trace_contours

Ring = List[Tuple[float, float]]
Rings = List[Ring]

_EIGHT = np.ones((3, 3), dtype=np.int8)


def ring_area(ring: Sequence[Tuple[float, float]]) -> float:
    """Absolute shoelace area."""
    arr = np.asarray(ring, dtype=np.float64)
    if arr.shape[0] < 3:
        return 0.0
    x, y = arr[:, 0], arr[:, 1]
    return abs(float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))) / 2.0


def polygon_area(rings: Rings) -> float:
    """Even-odd area: exterior minus holes."""
    if not rings:
        return 0.0
    return ring_area(rings[0]) - sum(ring_area(r) for r in rings[1:])


def ring_centroid(ring: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    arr = np.asarray(ring, dtype=np.float64)
    if np.allclose(arr[0], arr[-1]) and arr.shape[0] > 1:
        arr = arr[:-1]
    x, y = arr[:, 0], arr[:, 1]
    cross = x * np.roll(y, -1) - np.roll(x, -1) * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        return float(x.mean()), float(y.mean())
    cx = float(((x + np.roll(x, -1)) * cross).sum() / (6.0 * a))
    cy = float(((y + np.roll(y, -1)) * cross).sum() / (6.0 * a))
    return cx, cy


def point_in_ring(point, ring) -> bool:
    """Even-odd ray cast."""
    arr = np.asarray(ring, dtype=np.float64)
    px, py = float(point[0]), float(point[1])
    x, y = arr[:, 0], arr[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    crosses = (y > py) != (yp > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_at = (xp - x) * (py - y) / (yp - y) + x
    return bool(np.count_nonzero(crosses & (px < x_at)) % 2)


def point_in_polygon(point, rings: Rings) -> bool:
    inside = False
    for ring in rings:
        if point_in_ring(point, ring):
            inside = not inside
    return inside


def _segments(ring) -> np.ndarray:
    """[E, 4] array of (x1, y1, x2, y2) closing the ring."""
    arr = np.asarray(ring, dtype=np.float64)
    if not np.allclose(arr[0], arr[-1]):
        arr = np.vstack([arr, arr[:1]])
    return np.hstack([arr[:-1], arr[1:]])


def _any_segment_crossing(segs_a: np.ndarray, segs_b: np.ndarray) -> bool:
    """Proper or touching intersection between any segment pair (vectorized
    orientation tests over the E_a x E_b grid)."""
    ax1, ay1, ax2, ay2 = (segs_a[:, i][:, None] for i in range(4))
    bx1, by1, bx2, by2 = (segs_b[:, i][None, :] for i in range(4))

    def orient(ox, oy, px, py, qx, qy):
        return (px - ox) * (qy - oy) - (py - oy) * (qx - ox)

    d1 = orient(ax1, ay1, ax2, ay2, bx1, by1)
    d2 = orient(ax1, ay1, ax2, ay2, bx2, by2)
    d3 = orient(bx1, by1, bx2, by2, ax1, ay1)
    d4 = orient(bx1, by1, bx2, by2, ax2, ay2)
    proper = ((d1 * d2) < 0) & ((d3 * d4) < 0)
    if proper.any():
        return True

    # collinear / endpoint touches
    def on_seg(ox, oy, qx, qy, px, py, d):
        return (d == 0) & (np.minimum(ox, qx) <= px) & (px <= np.maximum(ox, qx)) \
            & (np.minimum(oy, qy) <= py) & (py <= np.maximum(oy, qy))

    touch = (on_seg(ax1, ay1, ax2, ay2, bx1, by1, d1)
             | on_seg(ax1, ay1, ax2, ay2, bx2, by2, d2)
             | on_seg(bx1, by1, bx2, by2, ax1, ay1, d3)
             | on_seg(bx1, by1, bx2, by2, ax2, ay2, d4))
    return bool(touch.any())


def polygons_intersect(a: Rings, b: Rings) -> bool:
    """True if the polygons share any point (boundary contact counts, as in
    shapely's ``intersects``)."""
    if not a or not b:
        return False
    ea, eb = np.asarray(a[0], np.float64), np.asarray(b[0], np.float64)
    # bbox reject
    if (ea[:, 0].max() < eb[:, 0].min() or eb[:, 0].max() < ea[:, 0].min()
            or ea[:, 1].max() < eb[:, 1].min() or eb[:, 1].max() < ea[:, 1].min()):
        return False
    if point_in_polygon(b[0][0], a) or point_in_polygon(a[0][0], b):
        return True
    segs_a = np.vstack([_segments(r) for r in a])
    segs_b = np.vstack([_segments(r) for r in b])
    return _any_segment_crossing(segs_a, segs_b)


def polygon_contains(a: Rings, b: Rings) -> bool:
    """True if polygon ``a`` contains polygon ``b`` entirely (interior test:
    every vertex of b inside a and no boundary crossings)."""
    if not a or not b:
        return False
    for pt in b[0]:
        if not point_in_polygon(pt, a):
            return False
    segs_a = np.vstack([_segments(r) for r in a])
    segs_b = np.vstack([_segments(r) for r in b])
    return not _any_segment_crossing(segs_a, segs_b)


# ---------------------------------------------------------------- raster ops

def rasterize_rings(rings: Rings, origin: Tuple[int, int], shape: Tuple[int, int]) -> np.ndarray:
    """Even-odd scanline fill into a bool mask of ``shape`` (rows, cols),
    with pixel (r, c) covering center (origin_x + c + .5, origin_y + r + .5)."""
    h, w = shape
    ox, oy = origin
    cross = np.zeros((h, w + 1), dtype=np.int32)
    for ring in rings:
        segs = _segments(ring)
        x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
        keep = y1 != y2
        if not keep.any():
            continue
        x1, y1, x2, y2 = x1[keep], y1[keep], x2[keep], y2[keep]
        for e in range(x1.shape[0]):
            ey1, ey2 = y1[e], y2[e]
            lo, hi = (ey1, ey2) if ey1 < ey2 else (ey2, ey1)
            r0 = max(0, int(np.ceil(lo - oy - 0.5)))
            r1 = min(h - 1, int(np.floor(hi - oy - 0.5 - 1e-12)))
            if r1 < r0:
                continue
            rows = np.arange(r0, r1 + 1)
            yc = oy + rows + 0.5
            xs = x1[e] + (yc - ey1) * (x2[e] - x1[e]) / (ey2 - ey1)
            cols = np.clip(np.ceil(xs - ox - 0.5).astype(np.int64), 0, w)
            np.add.at(cross, (rows, cols), 1)
    parity = np.cumsum(cross[:, :-1], axis=1) % 2
    return parity.astype(bool)


def _rings_bbox(list_of_rings: List[Rings]) -> Tuple[int, int, int, int]:
    pts = np.vstack([np.asarray(r, np.float64) for rings in list_of_rings for r in rings])
    return (int(np.floor(pts[:, 0].min())) - 1, int(np.floor(pts[:, 1].min())) - 1,
            int(np.ceil(pts[:, 0].max())) + 1, int(np.ceil(pts[:, 1].max())) + 1)


def _mask_to_polygons(mask: np.ndarray, origin: Tuple[int, int]) -> List[Rings]:
    """Label + trace, translating rings back to world coordinates."""
    if not mask.any():
        return []
    labels, _ = ndi.label(mask, structure=_EIGHT)
    polys = trace_contours(mask, labels=labels)
    ox, oy = origin
    return [[[(x + ox, y + oy) for x, y in ring] for ring in rings] for rings in polys]


def polygon_difference(a: Rings, b: Rings) -> List[Rings]:
    """a minus b as a list of polygons (exterior + holes).

    Mirrors _split_shapely_polygon (writer:116-124): the parts of ``a`` not
    covered by ``b``. Exact slab-sweep clipping (geometry/clipping.py) — the
    GEOS-``difference`` equivalent; the pixel-space rasterization remains as
    :func:`polygon_difference_raster` (test oracle / fallback)."""
    from citlab_as_tpu_torch.geometry.clipping import polygon_boolean
    return polygon_boolean(a, b, "difference")


def polygon_difference_raster(a: Rings, b: Rings) -> List[Rings]:
    """Pixel-space a minus b (1-px rasterize + trace). Kept as the property
    -test oracle for the exact clipper and as a fallback."""
    x0, y0, x1, y1 = _rings_bbox([a])
    shape = (y1 - y0 + 1, x1 - x0 + 1)
    mask_a = rasterize_rings(a, (x0, y0), shape)
    mask_b = rasterize_rings(b, (x0, y0), shape)
    return _mask_to_polygons(mask_a & ~mask_b, (x0, y0))


def polygon_intersection_area(a: Rings, b: Rings) -> float:
    """Exact intersection area (for the word->split argmax,
    writer:189-194)."""
    if not polygons_intersect(a, b):
        return 0.0
    from citlab_as_tpu_torch.geometry.clipping import boolean_area
    return boolean_area(a, b, "intersection")


def polyline_intersects_polygon(points, rings: Rings) -> bool:
    pts = np.asarray(points, np.float64)
    for p in pts:
        if point_in_polygon(p, rings):
            return True
    segs_l = np.hstack([pts[:-1], pts[1:]])
    segs_p = np.vstack([_segments(r) for r in rings])
    return _any_segment_crossing(segs_l, segs_p)


def split_polyline_outside(points, rings: Rings) -> List[List[Tuple[float, float]]]:
    """Pieces of a polyline lying outside a polygon — the baseline analog of
    shapely's LineString.difference (writer:199-206). Exact parametric
    clipping: each segment is cut at every boundary crossing and sub-segments
    are kept when their midpoint is outside."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 2:
        return []
    segs_p = np.vstack([_segments(r) for r in rings])
    px1, py1, px2, py2 = segs_p[:, 0], segs_p[:, 1], segs_p[:, 2], segs_p[:, 3]

    pieces: List[List[Tuple[float, float]]] = []
    current: List[Tuple[float, float]] = []

    def flush():
        nonlocal current
        if len(current) >= 2:
            pieces.append(current)
        current = []

    for i in range(pts.shape[0] - 1):
        a, b = pts[i], pts[i + 1]
        d = b - a
        # intersection params with every polygon edge
        denom = d[0] * (py2 - py1) - d[1] * (px2 - px1)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((px1 - a[0]) * (py2 - py1) - (py1 - a[1]) * (px2 - px1)) / denom
            u = (d[0] * (py1 - a[1]) - d[1] * (px1 - a[0])) / (-denom)
        valid = np.isfinite(t) & (t > 0) & (t < 1) & (u >= 0) & (u <= 1)
        ts = np.sort(np.unique(np.concatenate([[0.0, 1.0], t[valid]])))
        for t0, t1 in zip(ts[:-1], ts[1:]):
            mid = a + d * (t0 + t1) / 2.0
            p_start = tuple(a + d * t0)
            p_end = tuple(a + d * t1)
            if point_in_polygon(mid, rings):
                flush()
            else:
                if not current:
                    current.append(p_start)
                elif current[-1] != p_start:
                    flush()
                    current.append(p_start)
                current.append(p_end)
    flush()
    return pieces


def convert_polygon_with_holes(rings: Rings, min_hole_area: float = 0.0) -> List[Ring]:
    """Split a polygon with holes into hole-free exterior rings
    (writer:27-64 semantics: cut vertically at a hole centroid, recurse).
    Holes below ``min_hole_area`` are dropped first (writer:332-335)."""
    holes = [r for r in rings[1:] if ring_area(r) > min_hole_area]
    poly = [rings[0]] + holes
    if not holes:
        return [rings[0]]

    x0, y0, x1, y1 = _rings_bbox([poly])
    shape = (y1 - y0 + 1, x1 - x0 + 1)
    mask = rasterize_rings(poly, (x0, y0), shape)

    out: List[Ring] = []
    stack = [(mask, (x0, y0))]
    while stack:
        m, origin = stack.pop()
        for comp in _mask_to_polygons(m, origin):
            if len(comp) == 1:
                out.append(comp[0])
                continue
            cx, _ = ring_centroid(comp[1])
            col = int(round(cx)) - origin[0]
            col = max(1, min(m.shape[1] - 1, col))
            sub_bbox = _rings_bbox([comp])
            sx0, sy0, sx1, sy1 = sub_bbox
            sub_shape = (sy1 - sy0 + 1, sx1 - sx0 + 1)
            sub = rasterize_rings(comp, (sx0, sy0), sub_shape)
            cut = int(round(cx)) - sx0
            cut = max(1, min(sub.shape[1] - 1, cut))
            left = sub.copy()
            left[:, cut:] = False
            right = sub.copy()
            right[:, :cut] = False
            stack.append((left, (sx0, sy0)))
            stack.append((right, (sx0, sy0)))
    return out
