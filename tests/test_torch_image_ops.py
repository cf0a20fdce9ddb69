"""The port's remaining image and geometry helpers on the CPU against the
JAX package: ``ops/image_utils.py`` (``apply_transform`` for every transform
and kernel type, ``get_rotation_angle``, ``ImageResizer``),
``ops/morphology.py`` (``structuring_element``, ``morph_close``, the
``*_masked`` ops), ``ops/connected_components.py`` (``cc_stats``,
``segment_max_per_component``), ``geometry/util.py`` (``get_dist_fast``,
``get_in_dist``, ``get_off_dist``, ``get_orientation_rectangles``) and
``stages/baseline_clustering.py::get_list_of_scaled_polygons``."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from citlab_as_tpu_torch.ops import image_utils as tiu  # noqa: E402
from citlab_as_tpu_torch.ops import morphology as tmorph  # noqa: E402

TRANSFORMS = ("erosion", "dilation", "opening", "closing", "gradient", "tophat",
              "blackhat")


def _page(shape, seed):
    """A uint8 page: noise, dark strokes and blobs, so every transform
    changes something."""
    rng = np.random.RandomState(seed)
    img = rng.randint(150, 256, shape).astype(np.uint8)
    for _ in range(12):
        y, x = rng.randint(0, shape[0]), rng.randint(0, shape[1])
        img[y:y + rng.randint(1, 9), x:x + rng.randint(1, 15)] = rng.randint(0, 80)
    return img


@pytest.mark.parametrize("shape", [(37, 53), (64, 90)])
@pytest.mark.parametrize("kernel_type", ["rect", "ellipse", "cross"])
def test_apply_transform_equals_jax(shape, kernel_type):
    """7 transforms x 3 kernel types x 2 sizes, bit for bit; the kernel
    sizes (odd, even, non-square) and the iterations vary per case."""
    from citlab_as_tpu.ops.image_utils import apply_transform as japply
    img = _page(shape, seed=shape[0])
    for i, transform in enumerate(TRANSFORMS):
        kernel = ((4, 4), (5, 3), (3, 6), (7, 7))[i % 4]
        iterations = 1 + i % 2
        want = japply(img, transform, kernel, kernel_type, iterations)
        got = tiu.apply_transform(img, transform, kernel, kernel_type, iterations,
                                  device="cpu")
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{transform} {kernel}")
    floats = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(
        tiu.apply_transform(floats, "gradient", (5, 5), kernel_type, device="cpu"),
        japply(floats, "gradient", (5, 5), kernel_type))
    with pytest.raises(ValueError, match="transform_type"):
        tiu.apply_transform(img, "warp", device="cpu")
    with pytest.raises(ValueError, match="kernel_type"):
        tiu.apply_transform(img, "erosion", kernel_type="diamond", device="cpu")


@pytest.mark.parametrize("kind", ["rect", "ellipse", "cross"])
def test_structuring_elements_and_masked_ops_equal_jax(kind):
    from citlab_as_tpu.ops import morphology as jmorph
    x = np.random.RandomState(1).rand(2, 23, 31).astype(np.float32)
    for kw, kh in ((1, 1), (3, 3), (4, 6), (7, 5), (9, 9)):
        np.testing.assert_array_equal(tmorph.structuring_element(kind, kw, kh),
                                      jmorph.structuring_element(kind, kw, kh))
        if kind == "rect":
            np.testing.assert_array_equal(
                tmorph.morph_close(torch.from_numpy(x), kw, kh).numpy(),
                np.asarray(jmorph.morph_close(jnp.asarray(x), kw, kh)))
            continue
        for name in ("erode_masked", "dilate_masked", "morph_open_masked",
                     "morph_close_masked"):
            got = getattr(tmorph, name)(torch.from_numpy(x), kw, kh, kind).numpy()
            want = np.asarray(getattr(jmorph, name)(jnp.asarray(x), kw, kh, kind))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {kw}x{kh}")
    with pytest.raises(ValueError, match="structuring-element"):
        tmorph.structuring_element("diamond", 3, 3)


def test_cc_stats_and_segment_max_equal_jax():
    from citlab_as_tpu.ops.connected_components import (
        cc_stats as jstats, segment_max_per_component as jsegmax)
    from citlab_as_tpu_torch.ops.connected_components import (
        cc_stats as tstats, segment_max_per_component as tsegmax)
    rng = np.random.RandomState(2)
    for h, w, p in ((20, 30, 0.3), (41, 17, 0.55), (8, 8, 0.0), (25, 25, 0.9)):
        binary = (rng.rand(h, w) < p).astype(np.uint8)
        jlabels, jst = jstats(binary)
        tlabels, tst = tstats(torch.from_numpy(binary))
        np.testing.assert_array_equal(tlabels, jlabels)
        assert tst == jst
        values = rng.rand(h, w).astype(np.float32)
        np.testing.assert_array_equal(
            tsegmax(torch.from_numpy(tlabels), torch.from_numpy(values)).numpy(),
            np.asarray(jsegmax(jnp.asarray(jlabels), jnp.asarray(values))))
        ints = rng.randint(-5, 50, (h, w)).astype(np.int32)
        np.testing.assert_array_equal(
            tsegmax(torch.from_numpy(tlabels), torch.from_numpy(ints)).numpy(),
            np.asarray(jsegmax(jnp.asarray(jlabels), jnp.asarray(ints))))


def test_get_rotation_angle_equals_jax():
    from citlab_as_tpu.ops.image_utils import get_rotation_angle as jangle
    img = np.zeros((80, 120), np.float32)
    for y in range(10, 70, 8):       # text lines tilted by about 1 degree
        for x in range(5, 115):
            img[int(y + x * 0.017), x] = 1.0
    want = jangle(img, delta=0.5, limit=2.0)
    assert tiu.get_rotation_angle(img, delta=0.5, limit=2.0) == want
    assert want[1] != 0.0


def test_image_resizer_equals_jax(tmp_path):
    from citlab_as_tpu.ops.image_utils import ImageResizer as JResizer
    from citlab_as_tpu_torch.utils.io import save_png
    rng = np.random.RandomState(3)
    arr = rng.randint(0, 256, (70, 45)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    save_png(path, rng.randint(0, 256, (33, 58)).astype(np.uint8))
    for factor in (0.5, 1.7):
        jr, tr = JResizer([arr, path], scaling_factor=factor), \
            tiu.ImageResizer([arr, path], scaling_factor=factor)
        for a, b in zip(tr.images, jr.images):
            np.testing.assert_array_equal(a, b)
        tr.add_image(arr[:20])
        jr.add_image(arr[:20])
        # the resize weights are jax's; the sums run as float32 matmuls,
        # a few ulps from XLA's on the 0-255 scale
        for a, b in zip(tr.resize(), jr.resize()):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-3)
        assert tr.resize() is tr.resize()
        for pad in (False, True):
            (touts, tshapes), (jouts, jshapes) = (
                tr.resize_ratio(30, 50, pad), jr.resize_ratio(30, 50, pad))
            assert tshapes == jshapes
            for a, b in zip(touts, jouts):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-3)


def test_geometry_helpers_equal_jax():
    from citlab_as_tpu.geometry import util as jutil
    from citlab_as_tpu.geometry.rectangle import Rectangle as JRect
    from citlab_as_tpu_torch.geometry import util as tutil
    from citlab_as_tpu_torch.geometry.rectangle import Rectangle as TRect
    rng = np.random.RandomState(4)
    for _ in range(200):
        x, y, w, h = (int(v) for v in rng.randint(-50, 200, 4))
        point = tuple(rng.uniform(-100, 300, 2))
        assert abs(tutil.get_dist_fast(point, TRect(x, y, abs(w), abs(h)))
                   - jutil.get_dist_fast(point, JRect(x, y, abs(w), abs(h)))) <= 1e-9
        p1, p2 = tuple(rng.uniform(-100, 100, 2)), tuple(rng.uniform(-100, 100, 2))
        angle = rng.uniform(0, 2 * np.pi)
        vx, vy = np.cos(angle), np.sin(angle)
        for name in ("get_in_dist", "get_off_dist"):
            assert abs(getattr(tutil, name)(p1, p2, vx, vy)
                       - getattr(jutil, name)(p1, p2, vx, vy)) <= 1e-9
        dims = tuple(int(v) for v in rng.randint(1, 700, 4))
        offset = int(rng.randint(-30, 30))
        point = tuple(int(v) for v in rng.randint(0, 2000, 2))
        got = tutil.get_orientation_rectangles(point, dims, offset)
        want = jutil.get_orientation_rectangles(point, dims, offset)
        assert got.keys() == want.keys()
        for k in got:
            assert (got[k].x, got[k].y, got[k].width, got[k].height) == \
                (want[k].x, want[k].y, want[k].width, want[k].height)


def test_scaled_polygons_equal_jax():
    from citlab_as_tpu.geometry.polygon import Polygon as JPoly
    from citlab_as_tpu.stages.baseline_clustering import (
        get_list_of_scaled_polygons as jscaled)
    from citlab_as_tpu_torch.geometry.polygon import Polygon as TPoly
    from citlab_as_tpu_torch.stages.baseline_clustering import (
        get_list_of_scaled_polygons as tscaled)
    rng = np.random.RandomState(5)
    polys = [rng.randint(0, 3000, (2, rng.randint(1, 9))) for _ in range(20)]
    for factor in (1.0, 0.37, 2.5):
        got = tscaled([TPoly(list(p[0]), list(p[1])) for p in polys], factor)
        want = jscaled([JPoly(list(p[0]), list(p[1])) for p in polys], factor)
        assert [(list(a.x_points), list(a.y_points)) for a in got] == \
            [(list(b.x_points), list(b.y_points)) for b in want]
