"""ctypes bindings of the port's host geometry library
(``csrc/geometry_host.cpp``, the port's copy of the entry points of the JAX
package's host kernel that the main path reaches).

The library is built with the host C++ compiler at first use
(``ops/kernels/build.py``) into the ``.gitignore``d ``build/``. A failed
build raises: the stages have no quiet numpy fallback. The numpy functions
in ``geometry/{pairwise,polygon,util}.py`` are the plain versions; the tests
hold the two equal (integers bit for bit, doubles within 1e-9) and the
library bit-identical to the JAX package's host library.
"""
from __future__ import annotations

import ctypes
import threading
from itertools import chain
from typing import List, Optional, Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.geometry.polygon import Polygon

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed (raises on failure)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from citlab_as_tpu_torch.ops.kernels import build
            lib = build.load("geometry_host")
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int32)
            i32, f64 = ctypes.c_int32, ctypes.c_double
            lib.gk_interline_distances.argtypes = [dp, ip, i32, i32, f64, dp]
            lib.gk_interline_distances.restype = None
            lib.gk_interline_distances_normed.argtypes = [dp, ip, i32, i32, f64, dp]
            lib.gk_interline_distances_normed.restype = None
            lib.gk_norm_poly_sizes.argtypes = [dp, ip, i32, i32]
            lib.gk_norm_poly_sizes.restype = i32
            lib.gk_norm_poly_dists.argtypes = [dp, ip, i32, i32, dp, ip]
            lib.gk_norm_poly_dists.restype = None
            lib.gk_delaunay.argtypes = [dp, i32, ip]
            lib.gk_delaunay.restype = i32
            lib.gk_alpha_shape.argtypes = [dp, i32, f64, ip]
            lib.gk_alpha_shape.restype = i32
            lib.gk_cluster_features.argtypes = [dp, ip, i32, i32, f64, f64, dp, dp]
            lib.gk_cluster_features.restype = None
            lib.gk_calc_tols.argtypes = [dp, ip, i32, i32, f64, f64, dp]
            lib.gk_calc_tols.restype = None
            lib.gk_calc_metric.argtypes = [dp, ip, i32, dp, ip, i32, dp, i32, i32,
                                           f64, dp, dp]
            lib.gk_calc_metric.restype = None
            _lib = lib
    return _lib


def _pack(polys: Sequence[Polygon]) -> Tuple[np.ndarray, np.ndarray]:
    """(coords [total, 2] float64, offsets [n + 1] int32) of the polygons."""
    n = len(polys)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(np.fromiter((p.n_points for p in polys), np.int32, n),
              out=offsets[1:])
    total = int(offsets[-1])
    coords = np.empty((total, 2), np.float64)
    coords[:, 0] = np.fromiter(
        chain.from_iterable(p.x_points for p in polys), np.float64, total)
    coords[:, 1] = np.fromiter(
        chain.from_iterable(p.y_points for p in polys), np.float64, total)
    return coords, offsets


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def interline_distances_normed(normed_polys: Sequence[Polygon], des_dist: int,
                               max_d: float) -> List[float]:
    """Interline distance per already-normed baseline
    (``gk_interline_distances_normed``)."""
    if not normed_polys:
        return []
    lib = get_lib()
    coords, offsets = _pack(normed_polys)
    out = np.empty(len(normed_polys), np.float64)
    lib.gk_interline_distances_normed(_dp(coords), _ip(offsets), len(normed_polys),
                                      int(des_dist), float(max_d), _dp(out))
    return out.tolist()


def interline_distances_raw(polys: Sequence[Polygon], des_dist: int,
                            max_d: float) -> np.ndarray:
    """Interline distances straight from raw baselines: normalized at
    ``des_dist`` inside the same call (``gk_interline_distances``)."""
    if not polys:
        return np.empty(0, np.float64)
    lib = get_lib()
    coords, offsets = _pack(polys)
    out = np.empty(len(polys), np.float64)
    lib.gk_interline_distances(_dp(coords), _ip(offsets), len(polys),
                               int(des_dist), float(max_d), _dp(out))
    return out


def norm_poly_dists_packed(polys: Sequence[Polygon], des_dist: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """blow_up + thin_out of every polygon (``gk_norm_poly_dists``) as
    (coords [total, 2] float64 of integral values, offsets [n + 1] int32)."""
    if not polys:
        return np.empty((0, 2), np.float64), np.zeros(1, np.int32)
    lib = get_lib()
    coords, offsets = _pack(polys)
    total = lib.gk_norm_poly_sizes(_dp(coords), _ip(offsets), len(polys),
                                   int(des_dist))
    out_coords = np.empty((total, 2), np.float64)
    out_offsets = np.empty(len(polys) + 1, np.int32)
    lib.gk_norm_poly_dists(_dp(coords), _ip(offsets), len(polys), int(des_dist),
                           _dp(out_coords), _ip(out_offsets))
    return out_coords, out_offsets


def norm_poly_dists(polys: Sequence[Polygon], des_dist: int) -> List[Polygon]:
    """:func:`norm_poly_dists_packed` as Polygon objects (bounds computed),
    the C++ twin of ``geometry/polygon.py::norm_poly_dists``."""
    coords, offsets = norm_poly_dists_packed(polys, des_dist)
    out = []
    for i in range(len(polys)):
        seg = coords[offsets[i]:offsets[i + 1]]
        poly = Polygon.from_arrays(seg[:, 0].astype(np.int64),
                                   seg[:, 1].astype(np.int64))
        poly.get_bounding_box()
        out.append(poly)
    return out


def cluster_features(polys: Sequence[Polygon], des_dist: int, max_d: float,
                     target_avg: float) -> Tuple[np.ndarray, np.ndarray]:
    """(interline distances [N], normed bboxes [N, 4] as x, y, w, h) for the
    baseline-clustering stage in one call (``gk_cluster_features``): the
    normalize -> measure -> rescale to ``target_avg`` -> re-normalize ->
    re-measure chain of ``DBSCANBaselines``."""
    n = len(polys)
    if n == 0:
        return np.empty(0, np.float64), np.empty((0, 4), np.float64)
    lib = get_lib()
    coords, offsets = _pack(polys)
    out_d = np.empty(n, np.float64)
    out_bb = np.empty((n, 4), np.float64)
    lib.gk_cluster_features(_dp(coords), _ip(offsets), n, int(des_dist),
                            float(max_d), float(target_avg), _dp(out_d), _dp(out_bb))
    return out_d, out_bb


def delaunay(points: np.ndarray) -> Optional[np.ndarray]:
    """Delaunay triangles [T, 3] (vertex ids, counter-clockwise) by the
    sweep-circle triangulation (``gk_delaunay``); None for fewer than three
    points or a collinear / coincident cloud."""
    pts = np.ascontiguousarray(np.asarray(points, np.float64))
    n = pts.shape[0]
    if n < 3:
        return None
    out = np.empty((2 * n, 3), np.int32)
    n_tris = get_lib().gk_delaunay(_dp(pts), n, _ip(out))
    if n_tris < 0:
        return None
    return out[:n_tris].copy()


def alpha_shape_indices(points: np.ndarray, alpha: float) -> Optional[np.ndarray]:
    """Boundary vertex ids (circle order, not closed) of the alpha shape
    with the 20 % escalation (``gk_alpha_shape``); None for fewer than four
    points, a degenerate triangulation, or no closed boundary after 64
    escalations."""
    pts = np.ascontiguousarray(np.asarray(points, np.float64))
    n = pts.shape[0]
    if pts.ndim != 2 or pts.shape[1] != 2 or n < 4:
        return None
    out = np.empty(6 * n + 8, np.int32)
    m = get_lib().gk_alpha_shape(_dp(pts), n, float(alpha), _ip(out))
    if m < 0:
        return None
    return out[:m].copy()


def calc_tols_native(normed_polys: Sequence[Polygon], tick_dist: int,
                     max_d: float, rel_tol: float) -> np.ndarray:
    """The AS measure's tolerance per already-normed GT baseline
    (``gk_calc_tols``)."""
    if not normed_polys:
        return np.empty(0, np.float64)
    coords, offsets = _pack(normed_polys)
    out = np.empty(len(normed_polys), np.float64)
    get_lib().gk_calc_tols(_dp(coords), _ip(offsets), len(normed_polys), int(tick_dist),
                           float(max_d), float(rel_tol), _dp(out))
    return out


def calc_metric_native(polys_truth: Sequence[Polygon], polys_reco: Sequence[Polygon],
                       tols: np.ndarray, tick_dist: int, rel_tol: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(precision [n_tols, n_reco], recall [n_tols, n_truth]) of one page's
    RAW baselines (``gk_calc_metric``: normalized inside; ``tols[0] < 0``
    asks for the dynamic per-line tolerances). Both lists must be
    non-empty."""
    if not polys_truth or not polys_reco:
        raise ValueError("calc_metric_native needs truth and hypothesis baselines")
    t_coords, t_offsets = _pack(polys_truth)
    r_coords, r_offsets = _pack(polys_reco)
    tols = np.ascontiguousarray(np.asarray(tols, np.float64))
    precision = np.empty((len(tols), len(polys_reco)), np.float64)
    recall = np.empty((len(tols), len(polys_truth)), np.float64)
    get_lib().gk_calc_metric(
        _dp(t_coords), _ip(t_offsets), len(polys_truth),
        _dp(r_coords), _ip(r_offsets), len(polys_reco),
        _dp(tols), len(tols), int(tick_dist), float(rel_tol),
        _dp(precision), _dp(recall))
    return precision, recall
