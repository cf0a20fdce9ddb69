"""The port's host geometry library (``csrc/geometry_host.cpp`` through
``citlab_as_tpu_torch/geometry/native.py``) against the JAX package's
default (native) path and against its numpy plain versions, on random
baselines and on grid-aligned baselines whose point clouds are full of
co-circular points. The library builds with the host C++ compiler at first
use, so it runs here.

Against the JAX package: bit-identical, no tolerance (interline distances
raw and normed, cluster features, normalization, alpha-shape boundaries).
Against the plain versions: integers bit-identical (normalized points,
bounding boxes, alpha-shape boundaries over the library's triangulation);
doubles within 1e-9 absolute, because both libraries are built with
``-march=native`` and the compiler fuses multiply-adds that numpy rounds
twice (the JAX package holds its own numpy path to the same 1e-9).
"""
import os

import numpy as np
import pytest

from citlab_as_tpu.geometry import native as jn
from citlab_as_tpu.geometry.polygon import Polygon as JPolygon
from citlab_as_tpu.geometry.util import alpha_shape as j_alpha_shape
from citlab_as_tpu_torch.geometry import native as tn
from citlab_as_tpu_torch.geometry.pairwise import min_perpendicular_distances
from citlab_as_tpu_torch.geometry.polygon import Polygon, norm_poly_dists
from citlab_as_tpu_torch.geometry.util import alpha_shape, alpha_shape_plain
from citlab_as_tpu_torch.ops.kernels import build
from citlab_as_tpu_torch.stages.baseline_clustering import cluster_features_plain
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)


def _random_baselines(seed):
    """Slanted, kinked polylines in columns, some short, some reversed."""
    rng = np.random.RandomState(seed)
    out = []
    for col in range(rng.randint(1, 4)):
        y = 80
        for _ in range(rng.randint(5, 25)):
            k = rng.randint(2, 6)
            x0 = 40 + col * 500 + rng.randint(0, 20)
            xs = np.sort(rng.randint(x0, x0 + rng.randint(10, 420), k))
            ys = y + np.cumsum(rng.randint(-4, 5, k))
            if rng.rand() < 0.1:
                xs, ys = xs[::-1], ys[::-1]
            out.append((xs, ys))
            y += rng.randint(25, 70)
    return out


def _grid_baselines(seed):
    """Horizontal baselines on an integer grid at a fixed pitch: every
    shifted cloud is a lattice (co-circular points everywhere)."""
    rng = np.random.RandomState(seed)
    pitch = int(rng.choice([40, 50, 60]))
    out = []
    for col in range(2):
        x0 = 30 + col * 400
        for r in range(rng.randint(4, 12)):
            xs = np.array([x0, x0 + 300])
            out.append((xs, np.full(2, 100 + r * pitch)))
    return out


CASES = [("random", s) for s in range(4)] + [("grid", s) for s in range(3)]


def _polys(kind, seed):
    raw = (_random_baselines if kind == "random" else _grid_baselines)(seed)
    return ([Polygon.from_arrays(np.asarray(x), np.asarray(y)) for x, y in raw],
            [JPolygon.from_arrays(np.asarray(x), np.asarray(y)) for x, y in raw])


# every test here holds the port's host library to the JAX package's
# native one: the shared fixture fails by name where that is not loaded
pytestmark = pytest.mark.usefixtures("jax_native")


@pytest.mark.parametrize("kind,seed", CASES)
def test_interline_distances_bit_identical(kind, seed):
    tp, jp = _polys(kind, seed)
    raw = tn.interline_distances_raw(tp, 5, 500)
    assert np.array_equal(raw, jn.interline_distances_raw_native(jp, 5, 500))
    normed = norm_poly_dists(tp, 5)
    got = tn.interline_distances_normed(normed, 5, 500)
    plain = min_perpendicular_distances(normed, 5, 500)
    ref = jn.interline_distances_native(jn.norm_poly_dists_native(jp, 5), 5, 500)
    assert got == ref
    assert np.array_equal(raw, got)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind,seed", CASES)
def test_cluster_features_bit_identical(kind, seed):
    tp, jp = _polys(kind, seed)
    d, bb = tn.cluster_features(tp, 5, 500, 50)
    pd, pbb = cluster_features_plain(tp, 5, 500, 50)
    jd, jbb = jn.cluster_features_native(jp, 5, 500, 50)
    assert np.array_equal(d, jd) and np.array_equal(bb, jbb)
    np.testing.assert_allclose(d, pd, rtol=0, atol=1e-9)
    assert np.array_equal(bb, pbb)


@pytest.mark.parametrize("kind,seed", CASES)
def test_norm_poly_dists_bit_identical(kind, seed):
    tp, jp = _polys(kind, seed)
    got = tn.norm_poly_dists(tp, 5)
    plain = norm_poly_dists(tp, 5)
    ref = jn.norm_poly_dists_native(jp, 5)
    for g, p, r in zip(got, plain, ref):
        assert list(g.x_points) == list(p.x_points) == list(r.x_points)
        assert list(g.y_points) == list(p.y_points) == list(r.y_points)
    coords, offsets = tn.norm_poly_dists_packed(tp, 5)
    assert offsets[-1] == coords.shape[0] == sum(g.n_points for g in got)


def _clouds(kind, seed):
    """The text-region stage's article clouds: normed baselines plus copies
    shifted by one interline distance, several lines per cloud."""
    tp, _ = _polys(kind, seed)
    coords, off = tn.norm_poly_dists_packed(tp, 50)
    dists = tn.interline_distances_raw(tp, 5, 100)
    clouds = []
    for start in range(0, len(tp), 3):
        parts = []
        for i in range(start, min(start + 3, len(tp))):
            nci = coords[off[i]:off[i + 1]].astype(np.int64)
            parts += [nci, nci + np.asarray([1, -max(int(0.95 * dists[i]), 1)])]
        clouds.append(np.concatenate(parts))
    return clouds


def _edges(boundary):
    pts = [tuple(p) for p in boundary]
    return {frozenset(e) for e in zip(pts, pts[1:])}


@pytest.mark.parametrize("kind,seed", CASES)
def test_alpha_shape_bit_identical(kind, seed):
    for cloud in _clouds(kind, seed):
        got = alpha_shape(cloud, 75)
        assert got == j_alpha_shape(cloud, 75)
        # the plain version over the library's triangulation
        assert got == alpha_shape_plain(cloud, 75, simplices=tn.delaunay(cloud))
        if kind == "random":
            # random clouds triangulate uniquely: qhull gives the same
            # boundary, starting at another vertex (its triangle order)
            assert _edges(got) == _edges(alpha_shape_plain(cloud, 75))


def test_degenerate_inputs():
    assert tn.interline_distances_normed([], 5, 500) == []
    assert tn.cluster_features([], 5, 500, 50)[0].shape == (0,)
    assert tn.delaunay(np.array([[0, 0], [1, 1], [2, 2]], float)) is None
    assert tn.alpha_shape_indices(np.zeros((3, 2)), 75) is None
    one = [Polygon.from_arrays(np.array([0, 100]), np.array([5, 5]))]
    assert tn.interline_distances_raw(one, 5, 500).tolist() == [500.0]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "geometry_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path / "csrc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="build failed"):
        build.load("geometry_host")
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="not found"):
        build.build_all(["geometry_host"])


def test_library_is_cached_by_source_hash():
    tn.get_lib()
    path = build._lib_path("geometry_host")
    assert os.path.exists(path) and path.startswith(build.BUILD_DIR)
