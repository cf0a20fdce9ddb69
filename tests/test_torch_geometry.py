"""Geometry parity: the port's copies of ``geometry/{booleans,clipping,
polygon,rectangle}`` and ``utils/mathutil`` against the JAX package's, on
the cases of ``tests/test_booleans.py`` and ``tests/test_geometry.py`` and
on seeded random polygons. Results must be equal (same code, numpy only);
``norm_poly_dists`` takes the numpy path in the port, so it is also held
against the JAX package's default route on whole-page lists."""
import numpy as np
import pytest

import citlab_as_tpu.geometry.booleans as jb
import citlab_as_tpu.geometry.clipping as jc
import citlab_as_tpu.geometry.polygon as jp
import citlab_as_tpu.geometry.rectangle as jr
import citlab_as_tpu.utils.mathutil as jm
import citlab_as_tpu_torch.geometry.booleans as tb
import citlab_as_tpu_torch.geometry.clipping as tc
import citlab_as_tpu_torch.geometry.polygon as tp
import citlab_as_tpu_torch.geometry.rectangle as tr
import citlab_as_tpu_torch.utils.mathutil as tm

from tests.test_booleans import _star_polygon, rect
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)


def _pairs(n=12, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = [_star_polygon(rng, 60, 60, 20, 50)]
        b = [_star_polygon(rng, 60 + rng.randint(-30, 30),
                           60 + rng.randint(-30, 30), 10, 40)]
        out.append((a, b))
    return out


FIXED = {
    "vertical_split": ([rect(0, 0, 100, 20)], [rect(40, -10, 60, 30)]),
    "no_overlap": ([rect(0, 0, 10, 10)], [rect(20, 20, 30, 30)]),
    "hole": ([rect(0, 0, 100, 100)], [rect(40, 40, 60, 60)]),
    "shared_edge": ([rect(0, 0, 10, 10)], [rect(5, 0, 10, 10)]),
    "identical": ([rect(0, 0, 10, 10)], [rect(0, 0, 10, 10)]),
    "tangency": ([[(0, 0), (20, 0), (20, 20), (0, 20)]],
                 [[(4, 4), (10, 4), (10, 10), (4, 10)],
                  [(10, 10), (16, 10), (16, 16), (10, 16)]]),
    "with_hole": ([rect(0, 0, 50, 50), rect(10, 10, 40, 40)],
                  [rect(20, -5, 30, 55)]),
}
CASES = dict(FIXED, **{f"star{i}": ab for i, ab in enumerate(_pairs())})


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("name", sorted(CASES))
def test_region_booleans_equal(name):
    a, b = CASES[name]
    assert tb.polygon_difference(a, b) == jb.polygon_difference(a, b)
    assert tb.polygon_difference_raster(a, b) == jb.polygon_difference_raster(a, b)
    assert tb.polygon_intersection_area(a, b) == jb.polygon_intersection_area(a, b)
    for op in ("difference", "intersection", "union"):
        assert tc.polygon_boolean(a, b, op) == jc.polygon_boolean(a, b, op)
        assert tc.boolean_area(a, b, op) == jc.boolean_area(a, b, op)
    assert tb.polygons_intersect(a, b) == jb.polygons_intersect(a, b)
    assert tb.polygon_contains(a, b) == jb.polygon_contains(a, b)
    assert tb.polygon_contains(b, a) == jb.polygon_contains(b, a)
    assert tb.polygon_area(a) == jb.polygon_area(a)
    assert tb.ring_centroid(a[0]) == jb.ring_centroid(a[0])
    line = [(-10, 7), (30, 9), (70, 55), (130, 60)]
    assert tb.polyline_intersects_polygon(line, a) == jb.polyline_intersects_polygon(line, a)
    assert tb.split_polyline_outside(line, a) == jb.split_polyline_outside(line, a)
    assert [tb.point_in_polygon(p, a) for p in line] == [jb.point_in_polygon(p, a) for p in line]


@pytest.mark.usefixtures("jax_native")
def test_rasterize_and_hole_conversion_equal():
    rings = [rect(0, 0, 100, 100), rect(20, 20, 60, 60), rect(70, 70, 72, 72)]
    np.testing.assert_array_equal(tb.rasterize_rings(rings, (0, 0), (100, 100)),
                                  jb.rasterize_rings(rings, (0, 0), (100, 100)))
    for min_area in (0.0, 10.0, 1000.0, 1e6):
        assert (tb.convert_polygon_with_holes(rings, min_area)
                == jb.convert_polygon_with_holes(rings, min_area))


def _baselines(rng, n):
    polys = []
    for _ in range(n):
        k = rng.randint(2, 6)
        xs = np.sort(rng.randint(0, 1200, k))
        ys = rng.randint(0, 1600) + rng.randint(-15, 15, k)
        polys.append((xs.tolist(), ys.tolist()))
    return polys


def _as_tuple(poly):
    return (list(poly.x_points), list(poly.y_points), poly.n_points)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("n", [3, 40])
def test_norm_poly_dists_equal(n):
    """n = 40 takes the JAX package's host C route when that library is
    built; the port's numpy path must give the same points either way."""
    pts = _baselines(np.random.RandomState(n), n)
    pts.append(([0, 200000], [5, 5]))               # the huge-bbox guard
    got = tp.norm_poly_dists([tp.Polygon(x, y, len(x)) for x, y in pts], 3)
    ref = jp.norm_poly_dists([jp.Polygon(x, y, len(x)) for x, y in pts], 3)
    assert [_as_tuple(p) for p in got] == [_as_tuple(p) for p in ref]


def test_polygon_methods_equal():
    rng = np.random.RandomState(3)
    for xs, ys in _baselines(rng, 10) + [([0, 10], [0, 100]), ([5, 5, 5], [1, 9, 30])]:
        a, b = tp.Polygon(xs, ys, len(xs)), jp.Polygon(xs, ys, len(xs))
        assert _as_tuple(tp.blow_up(a)) == _as_tuple(jp.blow_up(b))
        assert _as_tuple(tp.thin_out(tp.blow_up(a), 7)) == _as_tuple(jp.thin_out(jp.blow_up(b), 7))
        assert tp.calc_reg_line_stats(a) == jp.calc_reg_line_stats(b)
        assert tp.poly_to_string(a) == jp.poly_to_string(b)
        assert _as_tuple(tp.string_to_poly(tp.poly_to_string(a))) == _as_tuple(b)
        assert vars(a.get_bounding_box()) == vars(b.get_bounding_box())
        for sc in (0.6, 900 / 2000, 1.5):
            a2, b2 = tp.Polygon(xs, ys, len(xs)), jp.Polygon(xs, ys, len(xs))
            a2.rescale(sc), b2.rescale(sc)
            a2.translate(3, -4), b2.translate(3, -4)
            a2.add_point(7, 9), b2.add_point(7, 9)
            assert _as_tuple(a2) == _as_tuple(b2)
            assert vars(a2.get_bounding_box()) == vars(b2.get_bounding_box())
            assert a2.as_list() == b2.as_list()
            np.testing.assert_array_equal(a2.to_array(), b2.to_array())
    square_t = tp.Polygon.from_points([(0, 0), (10, 0), (10, 10), (0, 10)])
    square_j = jp.Polygon.from_points([(0, 0), (10, 0), (10, 10), (0, 10)])
    for pt in [(5, 5), (0, 0), (10, 5), (11, 5), (-1, -1), (5, 10)]:
        assert square_t.contains_point(pt) == square_j.contains_point(pt)
    l1, l2 = [(0, 0), (50, 2)], [(65, 30), (120, 31)]
    for margin in (10, 20):
        assert (tp.are_vertical_aligned(l1, l2, margin)
                == jp.are_vertical_aligned(l1, l2, margin))


def test_rectangle_methods_equal():
    rng = np.random.RandomState(11)
    for _ in range(40):
        v = rng.randint(-20, 60, 8).tolist()
        (a, c), (b, d) = [(m.Rectangle(*v[:4]), m.Rectangle(*v[4:])) for m in (tr, jr)]
        assert vars(a.intersection(c)) == vars(b.intersection(d))
        assert vars(a.get_gap_to(c)) == vars(b.get_gap_to(d))
        assert a.contains_rectangle(c) == b.contains_rectangle(d)
        assert a.get_vertices() == b.get_vertices()
        assert [a.lies_above_of(c), a.lies_below_of(c), a.lies_left_of(c),
                a.lies_right_of(c)] == [b.lies_above_of(d), b.lies_below_of(d),
                                        b.lies_left_of(d), b.lies_right_of(d)]
        pt = (v[0] + 1, v[5])
        assert a.contains_point(pt) == b.contains_point(pt)
        assert a.contains_point_on_boundary(pt) == b.contains_point_on_boundary(pt)
        assert vars(tr.merge_rectangles([a, c])) == vars(jr.merge_rectangles([b, d]))
        ra, rb = a.rescale(0.45), b.rescale(0.45)
        assert vars(a if ra is None else ra) == vars(b if rb is None else rb)


def test_mathutil_equal():
    xs = [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 2.4999, 1e9 + 0.5]
    assert [tm.round_half_up(x) for x in xs] == [jm.round_half_up(x) for x in xs]
    np.testing.assert_array_equal(tm.round_half_up_array(np.array(xs)),
                                  jm.round_half_up_array(np.array(xs)))
    assert tm.round_by_base(3.14159, 2, 0.05) == jm.round_by_base(3.14159, 2, 0.05)
    assert tm.safe_div(1, 0) == jm.safe_div(1, 0)
    assert tm.f_measure(0.5, 0.25) == jm.f_measure(0.5, 0.25)
    assert tm.f1_score(3, 1, 2) == jm.f1_score(3, 1, 2)
