"""Polygon primitive + baseline normalization (port copy of
``citlab_as_tpu/geometry/polygon.py``, numpy paths only).

Semantics match python_util/geometry/polygon.py:9-421 (the canonical baseline
normalization ``norm_poly_dists = thin_out(blow_up(p))`` and the regression
angle ``calc_reg_line_stats`` must agree bit-for-bit with the reference /
Java kernel, or DBSCAN clustering and the AS measure drift). Implementations
are numpy-vectorized where the reference loops per pixel.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.geometry.rectangle import Rectangle
from citlab_as_tpu_torch.utils.mathutil import round_half_up_array


class Polygon:
    """Integer polygon / polyline. Coordinates are stored as Python ints;
    float inputs are truncated toward zero (reference polygon.py:24-26)."""

    __slots__ = ("x_points", "y_points", "bounds")

    def __init__(self, x_points: Sequence = None, y_points: Sequence = None, n_points: int = 0):
        if x_points is None:
            x_points = []
        if y_points is None:
            y_points = []
        self.x_points: List[int] = [int(x) for x in x_points]
        self.y_points: List[int] = [int(y) for y in y_points]
        if len(self.x_points) != len(self.y_points):
            raise ValueError("x_points and y_points must have equal length")
        self.bounds: Rectangle | None = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_arrays(cls, xs: np.ndarray, ys: np.ndarray) -> "Polygon":
        # astype(int64) truncates toward zero like int(); .tolist() yields
        # Python ints ~10x faster than per-element int() casts
        p = cls.__new__(cls)
        p.x_points = np.asarray(xs).astype(np.int64, copy=False).tolist()
        p.y_points = np.asarray(ys).astype(np.int64, copy=False).tolist()
        p.bounds = None
        return p

    @classmethod
    def from_points(cls, points: Sequence[Tuple[int, int]]) -> "Polygon":
        if len(points) == 0:
            return cls()
        xs, ys = zip(*points)
        return cls(list(xs), list(ys))

    # -- accessors ---------------------------------------------------------
    @property
    def n_points(self) -> int:
        return len(self.x_points)

    def as_list(self) -> List[Tuple[int, int]]:
        return list(zip(self.x_points, self.y_points))

    def to_array(self) -> np.ndarray:
        """[N, 2] int64 array of (x, y) points."""
        return np.stack(
            [np.asarray(self.x_points, dtype=np.int64),
             np.asarray(self.y_points, dtype=np.int64)], axis=1
        ) if self.n_points else np.zeros((0, 2), dtype=np.int64)

    def __repr__(self):
        return f"Polygon({self.n_points} pts)"

    # NOTE: no __eq__ — identity comparison is intentional. The pairwise
    # kernels (interline distances, calc_tols) compare polygons by identity
    # (`poly_b != poly_a`) exactly as the reference does; value equality
    # would wrongly skip duplicate baselines.

    # -- mutation ----------------------------------------------------------
    def add_point(self, x: int, y: int) -> None:
        self.x_points.append(int(x))
        self.y_points.append(int(y))
        if self.bounds is not None:
            self._update_bounds(int(x), int(y))

    def translate(self, delta_x: int, delta_y: int) -> None:
        self.x_points = [x + int(delta_x) for x in self.x_points]
        self.y_points = [y + int(delta_y) for y in self.y_points]
        if self.bounds is not None:
            self.bounds.translate(delta_x, delta_y)

    def rescale(self, scale: float) -> None:
        """Scale all points by ``scale`` with half-up rounding
        (python_util/geometry/point.py:1-11)."""
        self.x_points = [int(v) for v in round_half_up_array(np.asarray(self.x_points) * scale)]
        self.y_points = [int(v) for v in round_half_up_array(np.asarray(self.y_points) * scale)]
        if self.bounds is not None:
            self.bounds = None
            self.calculate_bounds()

    # -- bounds ------------------------------------------------------------
    def calculate_bounds(self) -> None:
        self.bounds = Rectangle(
            min(self.x_points), min(self.y_points),
            max(self.x_points) - min(self.x_points) + 1,
            max(self.y_points) - min(self.y_points) + 1,
        )

    def _update_bounds(self, x: int, y: int) -> None:
        b = self.bounds
        if x < b.x:
            b.width += b.x - x
            b.x = x
        else:
            b.width = max(b.width, x - b.x)
        if y < b.y:
            b.height += b.y - y
            b.y = y
        else:
            b.height = max(b.height, y - b.y)

    def get_bounding_box(self) -> Rectangle:
        if self.n_points == 0:
            return Rectangle()
        if self.bounds is None:
            self.calculate_bounds()
        return self.bounds.get_bounds()

    # -- predicates --------------------------------------------------------
    def contains_point(self, point) -> bool:
        """Ray-cast point-in-polygon (Jordan), polygon.py:144-165."""
        if not self.get_bounding_box().contains_point(point):
            return False
        px, py = point[0], point[1]
        xs = np.asarray(self.x_points, dtype=np.float64)
        ys = np.asarray(self.y_points, dtype=np.float64)
        xs_prev = np.roll(xs, 1)
        ys_prev = np.roll(ys, 1)
        crosses = (ys > py) != (ys_prev > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_at = (xs_prev - xs) * (py - ys) / (ys_prev - ys) + xs
        hits = crosses & (px < x_at)
        return bool(np.count_nonzero(hits) % 2 == 1)


def blow_up(polygon: Polygon) -> Polygon:
    """Densify a polyline to ~1-px steps between adjacent vertices.

    Per segment, interpolate along the dominant axis with half-up rounding of
    the minor coordinate; degenerate (duplicate-point) segments contribute
    nothing. Matches polygon.py:168-213 exactly (vectorized per segment).
    """
    n = polygon.n_points
    if n < 2:
        return Polygon(list(polygon.x_points), list(polygon.y_points))

    xs = np.asarray(polygon.x_points, dtype=np.int64)
    ys = np.asarray(polygon.y_points, dtype=np.int64)
    out_x: List[np.ndarray] = []
    out_y: List[np.ndarray] = []

    for i in range(1, n):
        x1, y1, x2, y2 = xs[i - 1], ys[i - 1], xs[i], ys[i]
        diff_x = abs(int(x2 - x1))
        diff_y = abs(int(y2 - y1))
        if max(diff_x, diff_y) < 1:
            if i == n - 1:
                out_x.append(np.asarray([x2]))
                out_y.append(np.asarray([y2]))
            continue
        if diff_x >= diff_y:
            step = 1 if x1 < x2 else -1
            xn = x1 + step * np.arange(0, diff_x, dtype=np.int64)
            yn = np.empty_like(xn)
            yn[0] = y1
            yn[1:] = round_half_up_array(y1 + (xn[1:] - x1) * (y2 - y1) / (x2 - x1))
        else:
            step = 1 if y1 < y2 else -1
            yn = y1 + step * np.arange(0, diff_y, dtype=np.int64)
            xn = np.empty_like(yn)
            xn[0] = x1
            xn[1:] = round_half_up_array(x1 + (yn[1:] - y1) * (x2 - x1) / (y2 - y1))
        out_x.append(xn)
        out_y.append(yn)
        if i == n - 1:
            out_x.append(np.asarray([x2]))
            out_y.append(np.asarray([y2]))

    if not out_x:
        return Polygon()
    return Polygon.from_arrays(np.concatenate(out_x), np.concatenate(out_y))


def thin_out(polygon: Polygon, des_dist: int) -> Polygon:
    """Resample a blown-up polyline to points ~``des_dist`` apart, keeping at
    least 20 points (polygon.py:216-241). Polygons with <= 20 points are
    returned unchanged (same object, as in the reference)."""
    n = polygon.n_points
    if n <= 20:
        return polygon
    dist = n - 1
    des_pts = max(20, int(dist / des_dist) + 1)
    step = dist / (des_pts - 1)
    idx = (np.arange(des_pts - 1) * step).astype(np.int64)
    xs = np.asarray(polygon.x_points, dtype=np.int64)
    ys = np.asarray(polygon.y_points, dtype=np.int64)
    out_x = np.concatenate([xs[idx], xs[-1:]])
    out_y = np.concatenate([ys[idx], ys[-1:]])
    return Polygon.from_arrays(out_x, out_y)


def norm_poly_dists(poly_list: Sequence[Polygon], des_dist: int) -> List[Polygon]:
    """Canonical baseline normalization: blow_up then thin_out per polygon,
    with the degenerate-huge-bbox guard (polygon.py:244-268)."""
    res = []
    for poly in poly_list:
        bb = poly.get_bounding_box()
        if bb.width > 100000 or bb.height > 100000:
            poly = Polygon([0], [0], 1)
        normed = thin_out(blow_up(poly), des_dist)
        normed.get_bounding_box()
        res.append(normed)
    return res


def calc_line(x_points: Sequence[int], y_points: Sequence[int]):
    """2x2 normal-equation least squares line fit, returning (intercept, slope).

    Matches python_util/geometry/linear_regression.py:6-57 including the
    near-singular guards: x-range < 2 -> (sum_x/len, inf); det < 1e-9 ->
    (first x, inf)."""
    xs = np.asarray(x_points, dtype=np.float64)
    ys = np.asarray(y_points, dtype=np.float64)
    if xs.max() - xs.min() < 2:
        return float(xs.sum() / len(xs)), float("inf")
    a = np.stack([np.ones_like(xs), xs], axis=1)
    ls = a.T @ a
    rs = a.T @ ys
    det = ls[0, 0] * ls[1, 1] - ls[0, 1] * ls[1, 0]
    if det < 1e-9:
        return float(xs[0]), float("inf")
    inv = np.array([[ls[1, 1], -ls[0, 1]], [-ls[1, 0], ls[0, 0]]]) / det
    n, m = inv @ rs
    return float(n), float(m)


def calc_reg_line_stats(poly: Polygon) -> Tuple[float, float]:
    """Baseline orientation angle (in [0, 2*pi)) and y-axis intercept of the
    regression line, with the reference's quadrant fixups based on the
    traversal direction (polygon.py:271-319). y is negated (image coords)."""
    if poly.n_points <= 1:
        return 0.0, 0.0

    n = float("inf")
    if poly.n_points > 2:
        if max(poly.x_points) == min(poly.x_points):
            m = float("inf")
        else:
            n, m = calc_line(poly.x_points, [-y for y in poly.y_points])
    else:
        x1, x2 = poly.x_points
        y1, y2 = [-y for y in poly.y_points]
        if x1 == x2:
            m = float("inf")
        else:
            m = (y2 - y1) / (x2 - x1)
            n = y2 - m * x2

    if m == float("inf"):
        angle = math.pi / 2
    else:
        angle = math.atan(m)

    if -math.pi / 2 < angle <= -math.pi / 4 and poly.y_points[0] > poly.y_points[-1]:
        angle += math.pi
    if -math.pi / 4 < angle <= math.pi / 4 and poly.x_points[0] > poly.x_points[-1]:
        angle += math.pi
    if math.pi / 4 < angle < math.pi / 2 and poly.y_points[0] < poly.y_points[-1]:
        angle += math.pi
    if angle < 0:
        angle += 2 * math.pi

    return angle, n


def string_to_poly(string_polygon: str) -> Polygon:
    """Parse ``"x1,y1;x2,y2;..."`` into a Polygon (polygon.py:322-343)."""
    points = string_polygon.split(";")
    if len(points) < 2:
        raise ValueError("Wrong polygon string format.")
    poly = Polygon()
    for p in points:
        coord = p.split(",")
        if len(coord) < 2:
            raise ValueError("Wrong polygon string format.")
        poly.add_point(int(coord[0]), int(coord[1]))
    return poly


def poly_to_string(polygon: Polygon) -> str:
    """Inverse of :func:`string_to_poly` (polygon.py:346-361)."""
    return ";".join(f"{x},{y}" for x, y in zip(polygon.x_points, polygon.y_points))


def are_vertical_aligned(line1, line2, margin: int = 20) -> bool:
    """x-extent overlap test between two polylines given as point lists
    (polygon.py:406-421); used for heading/separator alignment masking."""
    l1_min, l1_max = min(p[0] for p in line1), max(p[0] for p in line1)
    l2_min, l2_max = min(p[0] for p in line2), max(p[0] for p in line2)
    if l2_min - margin <= l1_min <= l2_max and l2_min <= l1_max <= l2_max + margin:
        return True
    if l1_min - margin <= l2_min <= l1_max and l1_min <= l2_max <= l1_max + margin:
        return True
    if l1_min - margin < l2_min < l1_min + margin or l1_max - margin < l2_max < l1_max + margin:
        return True
    return False


def sort_ascending_by_x(polys):
    """Sort point-list polygons by minimal x (polygon.py:386-393)."""
    return sorted(polys, key=lambda poly: min(p[0] for p in poly))


def sort_ascending_by_y(polys):
    """Sort point-list polygons by maximal y (polygon.py:396-403)."""
    return sorted(polys, key=lambda poly: max(p[1] for p in poly))
