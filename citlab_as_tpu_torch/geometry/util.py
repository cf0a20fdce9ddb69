"""Geometry utilities (port copy of the part of
``citlab_as_tpu/geometry/util.py`` that the text-region, feature and
article-rectangle stages reach: ``bounding_box``, ``convex_hull``,
``alpha_shape`` and its helpers, ``check_intersection``, ``polygon_clip``,
``ortho_connect`` and ``smooth_surrounding_polygon`` with the helpers it
uses, the inline / offline distances ``get_dist_fast``, ``get_in_dist``,
``get_off_dist``, and the orientation rectangles and cones).

Semantics follow python_util/geometry/util.py (file:line cites inline).
``alpha_shape`` runs in the port's host C++ library
(``geometry/native.py``); ``alpha_shape_plain`` is its numpy/scipy plain
version.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay

from citlab_as_tpu_torch.geometry.polygon import Polygon, norm_poly_dists
from citlab_as_tpu_torch.geometry.rectangle import Rectangle

__all__ = ["bounding_box", "convex_hull", "alpha_shape", "alpha_shape_plain",
           "check_intersection", "polygon_clip", "ortho_connect",
           "smooth_surrounding_polygon", "get_dist_fast", "get_in_dist", "get_off_dist",
           "get_orientation_rectangles", "get_orientation_cones"]


def check_intersection(line_1, line_2) -> Optional[list]:
    """Segment-segment intersection (geometry/util.py:28-85).

    Lines are ``[[x1, x2], [y1, y2]]``. Returns the intersection point
    ``[x, y]``, ``["inf", "inf"]`` for overlapping collinear segments, or
    None. Degenerate divisions yield inf/nan (treated as no overlap) instead
    of raising.
    """
    x_points1, y_points1 = line_1
    x_points2, y_points2 = line_2

    us = np.array([x_points1[0], y_points1[0]], dtype=np.float64)
    vs = np.array([x_points1[1] - x_points1[0], y_points1[1] - y_points1[0]], dtype=np.float64)
    u = np.array([x_points2[0], y_points2[0]], dtype=np.float64)
    v = np.array([x_points2[1] - x_points2[0], y_points2[1] - y_points2[0]], dtype=np.float64)

    a = np.stack([vs, -v], axis=1)
    b = u - us

    rank_a = np.linalg.matrix_rank(a)
    rank_ab = np.linalg.matrix_rank(np.c_[a, b])

    if rank_a != rank_ab:
        return None  # parallel, disjoint

    if rank_a == rank_ab == 1:
        # Collinear: project line_2's endpoints onto line_1's parameter.
        # (Deviation from the reference, which divides component-wise and
        # crashes on axis-aligned collinear segments and misses the
        # fully-containing case; this projection handles all overlaps.)
        denom = float(vs @ vs)
        if denom == 0:
            return None  # line_1 is a point
        s_u = float((u - us) @ vs) / denom
        s_v = float(((u + v) - us) @ vs) / denom
        lo, hi = min(s_u, s_v), max(s_u, s_v)
        ov_lo, ov_hi = max(lo, 0.0), min(hi, 1.0)
        if ov_lo > ov_hi:
            return None
        if ov_lo < ov_hi:
            return ["inf", "inf"]
        pt = us + ov_lo * vs
        return [float(pt[0]), float(pt[1])]

    s, t = np.linalg.inv(a).dot(b)
    if not (0 <= s <= 1 and 0 <= t <= 1):
        return None
    pt = us + s * vs
    return [float(pt[0]), float(pt[1])]




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


def polygon_clip(poly, clip_poly) -> list:
    """Sutherland-Hodgman clipping of an arbitrary polygon against a convex
    CCW clip polygon (util.py:700-772)."""

    def is_inside(r, e):
        p, q = e
        return (q[0] - p[0]) * (r[1] - p[1]) - (r[0] - p[0]) * (q[1] - p[1]) > 0

    def intersect(e1, e2):
        (x1, y1), (x2, y2) = e1
        (x3, y3), (x4, y4) = e2
        dx12, dx34 = x1 - x2, x3 - x4
        dy12, dy34 = y1 - y2, y3 - y4
        n1 = x1 * y2 - y1 * x2
        n2 = x3 * y4 - y3 * x4
        d = 1.0 / (dx12 * dy34 - dy12 * dx34)
        return (n1 * dx34 - dx12 * n2) * d, (n1 * dy34 - dy12 * n2) * d

    output_poly = list(poly)
    c1 = clip_poly[-1]
    for c2 in clip_poly:
        input_poly = output_poly
        output_poly = []
        clip_edge = (c1, c2)
        p1 = input_poly[-1]
        for p2 in input_poly:
            if is_inside(p2, clip_edge):
                if not is_inside(p1, clip_edge):
                    output_poly.append(intersect((p1, p2), clip_edge))
                output_poly.append(p2)
            elif is_inside(p1, clip_edge):
                output_poly.append(intersect((p1, p2), clip_edge))
            p1 = p2
        if not output_poly:
            return []
        c1 = c2
    return output_poly


# -- orthogonal connect + rectilinear smoothing -----------------------------

def ortho_connect(rectangles: List[Rectangle]) -> List[Polygon]:
    """2-D Orthogonal Connect-The-Dots (O'Rourke; util.py:88-182): outline
    polygons of a union of axis-aligned rectangles. Vertices shared by an
    even number of rectangles cancel; remaining vertices are connected by
    alternating horizontal/vertical edges. Inner polygons (holes contained in
    another outline) are dropped, as in the reference."""
    points: set = set()
    for rect in rectangles:
        for pt in rect.get_vertices():
            if pt in points:
                points.remove(pt)
            else:
                points.add(pt)
    points_list = list(points)
    if not points_list:
        return []

    sort_x = sorted(points_list)
    sort_y = sorted(points_list, key=lambda p: (p[1], p[0]))

    edges_h: dict = {}
    edges_v: dict = {}
    i = 0
    while i < len(points_list):
        curr_y = sort_y[i][1]
        while i < len(points_list) and sort_y[i][1] == curr_y:
            edges_h[sort_y[i]] = sort_y[i + 1]
            edges_h[sort_y[i + 1]] = sort_y[i]
            i += 2
    i = 0
    while i < len(points_list):
        curr_x = sort_x[i][0]
        while i < len(points_list) and sort_x[i][0] == curr_x:
            edges_v[sort_x[i]] = sort_x[i + 1]
            edges_v[sort_x[i + 1]] = sort_x[i]
            i += 2

    all_polygons: List[Polygon] = []
    while edges_h:
        polygon = [(next(iter(edges_h)), 0)]
        edges_h.pop(polygon[0][0])
        # re-insert: popitem in the reference removes one endpoint mapping;
        # we emulate by tracking the start vertex and walking alternately
        start_vertex = polygon[0][0]
        # restore the popped mapping's partner walk: the walk below only pops
        # what it consumes, starting with a vertical edge from start_vertex
        while True:
            curr, e = polygon[-1]
            if e == 0:
                next_vertex = edges_v.pop(curr)
                polygon.append((next_vertex, 1))
            else:
                next_vertex = edges_h.pop(curr)
                polygon.append((next_vertex, 0))
            if polygon[-1][0] == start_vertex and polygon[-1][1] == 0:
                polygon.pop()
                break
        poly_pts = [pt for pt, _ in polygon]
        for vertex in poly_pts:
            edges_h.pop(vertex, None)
            edges_v.pop(vertex, None)
        xs, ys = zip(*poly_pts)
        all_polygons.append(Polygon(list(xs), list(ys)))

    # drop polygons contained in other polygons
    final = list(all_polygons)
    if len(all_polygons) > 1:
        for poly in all_polygons:
            for other in all_polygons:
                if other is poly:
                    continue
                if other.contains_point((poly.x_points[0], poly.y_points[0])):
                    final.remove(poly)
                    break
    return final


def get_orientation_rectangles(point, dims=(600, 300, 600, 300),
                               offset=0) -> Dict[str, Rectangle]:
    """N/E/S/W orientation rectangles around a point (util.py:185-203)."""
    height_v, width_v, height_h, width_h = dims
    pt_x, pt_y = point
    rect_n = Rectangle(pt_x - width_v // 2, pt_y - height_v, width_v, height_v)
    rect_n.translate(0, offset)
    rect_s = Rectangle(pt_x - width_v // 2, pt_y, width_v, height_v)
    rect_s.translate(0, -offset)
    rect_e = Rectangle(pt_x, pt_y - height_h // 2, width_h, height_h)
    rect_e.translate(-offset, 0)
    rect_w = Rectangle(pt_x - width_h, pt_y - height_h // 2, width_h, height_h)
    rect_w.translate(offset, 0)
    return {"n": rect_n, "e": rect_e, "s": rect_s, "w": rect_w}


def get_orientation_cones(point, dims=(600, 300, 600, 300), offset=0) -> Dict[str, Polygon]:
    """N/E/S/W orientation cones (triangles) around a point (util.py:206-228)."""
    height_v, width_v, height_h, width_h = dims
    pt_x, pt_y = point
    cone_n = Polygon([pt_x - width_v // 2, pt_x + width_v // 2, pt_x], [pt_y, pt_y, pt_y - height_v])
    cone_n.translate(0, offset)
    cone_s = Polygon([pt_x - width_v // 2, pt_x + width_v // 2, pt_x], [pt_y, pt_y, pt_y + height_v])
    cone_s.translate(0, -offset)
    cone_e = Polygon([pt_x, pt_x, pt_x + height_h], [pt_y + width_h // 2, pt_y - width_h // 2, pt_y])
    cone_e.translate(-offset, 0)
    cone_w = Polygon([pt_x, pt_x, pt_x - height_h], [pt_y + width_h // 2, pt_y - width_h // 2, pt_y])
    cone_w.translate(offset, 0)
    return {"n": cone_n, "e": cone_e, "s": cone_s, "w": cone_w}


def check_horizontal_edge(point_a, point_b) -> bool:
    """True if the edge between two points is more horizontal than vertical
    (util.py:274-281)."""
    return not (math.fabs(point_a[0] - point_b[0]) < math.fabs(point_a[1] - point_b[1]))


def _sort_cluster_by_y_then_x(cluster, inverse_y=False, inverse_x=False):
    """Sort (index, (point, orientation)) clusters by point coords
    (util.py:233-271)."""
    sy = -1 if inverse_y else 1
    sx = -1 if inverse_x else 1
    return sorted(cluster, key=lambda c: (sy * c[1][0][1], sx * c[1][0][0]))


def smooth_surrounding_polygon(
    polygon,
    poly_norm_dist: int = 10,
    orientation_dims: Tuple[int, int, int, int] = (400, 800, 600, 400),
    offset: int = 0,
) -> Polygon:
    """Rectilinear smoothing of a 'crooked' surrounding polygon
    (util.py:284-505): classify each vertex by N/E/S/W cone point counts into
    vertical / horizontal / corner orientation, fix isolated mislabels,
    collapse corner clusters, then average coordinate runs between corners
    into axis-aligned edges and rebuild the polygon from the ray
    intersections."""
    if isinstance(polygon, Polygon):
        polygon = polygon.as_list()
    surrounding_polygon = list(polygon)
    if surrounding_polygon[0] != surrounding_polygon[-1]:
        surrounding_polygon.append(polygon[0])

    poly_xs, poly_ys = zip(*surrounding_polygon)
    poly = Polygon(list(poly_xs), list(poly_ys))
    poly_norm = norm_poly_dists([poly], des_dist=poly_norm_dist)[0]

    poly_bb = poly.get_bounding_box()
    poly_h, poly_w = poly_bb.height, poly_bb.width
    dims_flex = [poly_h // 2, poly_h // 2, poly_w // 2, poly_h // 3]
    dims_min = [100, 80, 100, 60]
    dims = [max(min(x, y), z) for x, y, z in zip(orientation_dims, dims_flex, dims_min)]

    norm_pts = poly_norm.as_list()

    # orientation per original vertex from cone point counts
    oriented_points = []
    for pt in polygon:
        cones = get_orientation_cones(pt, dims, offset)
        counts = {o: sum(1 for pn in norm_pts if cones[o].contains_point(pn)) for o in cones}
        top_two = [k for k, _ in sorted(counts.items(), key=lambda kv: kv[1], reverse=True)][:2]
        if "n" in top_two and "s" in top_two:
            pt_o = "vertical"
        elif "e" in top_two and "w" in top_two:
            pt_o = "horizontal"
        elif "e" in top_two and "s" in top_two:
            pt_o = "corner_ul"
        elif "w" in top_two and "s" in top_two:
            pt_o = "corner_ur"
        elif "w" in top_two and "n" in top_two:
            pt_o = "corner_dr"
        else:
            pt_o = "corner_dl"
        oriented_points.append((pt, pt_o))

    n_op = len(oriented_points)

    # fix isolated misclassifications between two agreeing neighbors
    for i in range(n_op):
        if (
            oriented_points[i - 1][1] != oriented_points[i][1]
            and oriented_points[i - 1][1] == oriented_points[(i + 1) % n_op][1]
            and "corner" not in oriented_points[i - 1][1]
        ):
            oriented_points[i] = (oriented_points[i][0], oriented_points[i - 1][1])

    # collapse same-type corner clusters down to a single corner
    for i in range(n_op):
        if "corner" in oriented_points[i][1]:
            cluster = [(i, oriented_points[i])]
            j = (i + 1) % n_op
            while oriented_points[i][1] == oriented_points[j][1]:
                cluster.append((j, oriented_points[j]))
                j = (j + 1) % n_op
            if len(cluster) > 1:
                typ = oriented_points[i][1]
                if "ul" in typ:
                    cs = _sort_cluster_by_y_then_x(cluster)
                elif "ur" in typ:
                    cs = _sort_cluster_by_y_then_x(cluster, inverse_x=True)
                elif "dl" in typ:
                    cs = _sort_cluster_by_y_then_x(cluster, inverse_y=True)
                else:
                    cs = _sort_cluster_by_y_then_x(cluster, inverse_y=True, inverse_x=True)
                for idx, _ in cs[1:]:
                    oriented_points[idx] = (oriented_points[idx][0], "vertical")

    # rotate list to start at a corner, wrap around
    corner_idx = 0
    for i, op in enumerate(oriented_points):
        if "corner" in op[1]:
            corner_idx = i
            break
    oriented_points = oriented_points[corner_idx:] + oriented_points[:corner_idx]
    oriented_points.append(oriented_points[0])

    corner_ids = [i for i, op in enumerate(oriented_points) if "corner" in op[1]]
    if len(corner_ids) < 2:
        # no smoothing possible; return original closed polygon
        return poly

    smoothed_edges: List[int] = []
    start_cluster = oriented_points[corner_ids[0]:corner_ids[1] + 1]
    if len(start_cluster) > 3:
        is_horizontal = check_horizontal_edge(start_cluster[0][0], start_cluster[-1][0])
    else:
        is_horizontal = check_horizontal_edge(start_cluster[0][0], start_cluster[1][0])
    j = int(is_horizontal)

    for i in range(len(corner_ids) - 1):
        cluster = oriented_points[corner_ids[i]:corner_ids[i + 1] + 1]
        if len(cluster) > 3:
            if not j == check_horizontal_edge(cluster[0][0], cluster[-1][0]):
                smoothed_edges.append(cluster[0][0][j])
                j = int(not j)
            mean = round(float(sum(pt[0][j] for pt in cluster)) / len(cluster))
            smoothed_edges.append(mean)
            j = int(not j)
        else:
            if not j == check_horizontal_edge(cluster[0][0], cluster[1][0]):
                smoothed_edges.append(cluster[0][0][j])
                j = int(not j)
            for pt in cluster[:-1]:
                smoothed_edges.append(pt[0][j])
                j = int(not j)
        if i == len(corner_ids) - 2 and j != is_horizontal:
            smoothed_edges.append(cluster[-1][0][j])

    smoothed_polygon = Polygon()
    for i in range(len(smoothed_edges)):
        if is_horizontal:
            smoothed_polygon.add_point(
                smoothed_edges[(i + 1) % len(smoothed_edges)], smoothed_edges[i])
            is_horizontal = int(not is_horizontal)
        else:
            smoothed_polygon.add_point(
                smoothed_edges[i], smoothed_edges[(i + 1) % len(smoothed_edges)])
            is_horizontal = int(not is_horizontal)
    return smoothed_polygon


# -- inline / offline distances (util.py:775-829) ---------------------------

def get_dist_fast(point, bb: Rectangle) -> float:
    """L1 distance from a point to a bounding box (0 inside)."""
    dist = 0.0
    if point[0] < bb.x:
        dist += bb.x - point[0]
    if point[0] > bb.x + bb.width:
        dist += point[0] - bb.x - bb.width
    if point[1] < bb.y:
        dist += bb.y - point[1]
    if point[1] > bb.y + bb.height:
        dist += point[1] - bb.y - bb.height
    return dist


def get_in_dist(p1, p2, or_vec_x, or_vec_y) -> float:
    """Inline (parallel) component of p1 - p2 along the orientation vector;
    y is flipped into math coordinates."""
    diff_x = p1[0] - p2[0]
    diff_y = -p1[1] + p2[1]
    return diff_x * or_vec_x + diff_y * or_vec_y


def get_off_dist(p1, p2, or_vec_x, or_vec_y) -> float:
    """Offline (perpendicular) component of p1 - p2 to the orientation."""
    diff_x = p1[0] - p2[0]
    diff_y = -p1[1] + p2[1]
    return diff_x * or_vec_y - diff_y * or_vec_x
