"""The port's ops against the JAX package's, on the same numpy inputs:
CC filter (bit-exact), resize (atol 1e-3 on the 0-255 scale), contour
tracing (identical rings), rect morphology, bit packing."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from citlab_as_tpu.stages import separator as jsep
from citlab_as_tpu_torch.ops import connected_components as tcc
from citlab_as_tpu_torch.ops import contours as tcontours
from citlab_as_tpu_torch.ops import morphology as tmorph
from citlab_as_tpu_torch.ops import resize as tresize
from citlab_as_tpu_torch.stages import separator as tsep
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

# the JAX package's ops/__init__ re-exports functions under module names
jcc = importlib.import_module("citlab_as_tpu.ops.connected_components")
jcontours = importlib.import_module("citlab_as_tpu.ops.contours")
jmorph = importlib.import_module("citlab_as_tpu.ops.morphology")


def _blobs(h, w, seed, density=0.08):
    """Random strokes, rules and speckle: components of all sizes around
    the 100-px threshold, diagonal joins, serpentines."""
    rng = np.random.RandomState(seed)
    m = np.zeros((h, w), np.uint8)
    m[rng.rand(h, w) < density] = 255
    for _ in range(6):
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, 4), x:x + rng.randint(5, 60)] = 255
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(5, 60), x:x + rng.randint(1, 4)] = 255
    for k in range(0, min(h, w) - 1, 2):     # a diagonal staircase
        m[k, k] = m[k + 1, k + 1] = 255
    return m


def _serpentine(h=40, w=40):
    m = np.zeros((h, w), np.uint8)
    for r in range(0, h, 4):
        m[r, 1:w - 1] = 255
        c = w - 2 if (r // 4) % 2 == 0 else 1
        m[r:r + 4, c] = 255
    return m


@pytest.mark.parametrize("seed,hw,min_size", [
    (0, (64, 96), 100), (1, (50, 70), 5), (2, (80, 40), 100), (3, (33, 47), 1)])
def test_remove_small_components_bit_exact(seed, hw, min_size):
    m = _blobs(*hw, seed)
    want = np.asarray(jcc.remove_small_components(jnp.asarray(m),
                                                  jnp.int32(min_size)))
    got = tcc.remove_small_components(torch.from_numpy(m)[None], min_size)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_remove_small_components_batched_and_serpentine():
    """A batch mixing a many-turn serpentine (long fixpoint) with speckle:
    each page equals the reference run on its own."""
    pages = np.stack([_serpentine(), _blobs(40, 40, 7, density=0.3)])
    got = tcc.remove_small_components(torch.from_numpy(pages), 100)
    for i in range(2):
        want = np.asarray(jcc.remove_small_components(jnp.asarray(pages[i]),
                                                      jnp.int32(100)))
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_connected_components_labels_match():
    m = _blobs(48, 64, 11)
    want = np.asarray(jcc.connected_components(jnp.asarray(m)))
    got = tcc.connected_components(torch.from_numpy(m)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst", [((130, 95), (96, 70)), ((200, 141), (150, 105)),
                                     ((64, 48), (64, 33)), ((40, 30), (60, 45))])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.RandomState(sum(src))
    img = rng.randint(0, 256, (2,) + src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (2,) + dst, method="linear",
                            antialias=True)
    got = tresize.resize_image(torch.from_numpy(img), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("n_in,n_out", [(130, 96), (95, 70), (40, 60), (1420, 1065)])
def test_resize_weight_matrices_are_jax_s(n_in, n_out):
    """The weight matrices (entries in [0, 1]) are jax's compute_weight_mat
    to a few float32 ulps of 1.0 (atol 2e-7): the same formula, with the normalising sums taken in
    another order (XLA's fusion of the jitted formula moves its own last
    bits too); the support (nonzero pattern) is identical."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
    want = jax.jit(lambda: compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, True))()
    got = tresize.linear_weight_matrix(n_in, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)
    np.testing.assert_array_equal(got.numpy() != 0, np.asarray(want) != 0)


def test_scaling_factor_matches():
    from citlab_as_tpu.ops.resize import get_scaling_factor
    for args in [(2000, 1420, 1.0, 1500), (1500, 1000, 1.0, None),
                 (800, 600, 0.5, 1500), (800, 600, None, 1500)]:
        assert tresize.get_scaling_factor(*args) == get_scaling_factor(*args)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_contours_identical_rings(seed):
    m = _blobs(60, 80, seed, density=0.15)
    m[20:40, 20:50] = 255
    m[25:35, 25:45] = 0          # a hole
    m[28:31, 30:33] = 255        # an island in the hole
    assert tcontours.trace_contours(m) == jcontours.trace_contours(m)


def test_trace_contours_empty():
    assert tcontours.trace_contours(np.zeros((5, 5), np.uint8)) == []


@pytest.mark.parametrize("kw,kh", [(5, 1), (1, 7), (4, 1), (1, 6), (3, 3)])
def test_rect_morphology_matches(kw, kh):
    img = _blobs(30, 40, kw * 10 + kh, density=0.5).astype(np.float32)
    for jf, tf in ((jmorph.erode, tmorph.erode), (jmorph.dilate, tmorph.dilate),
                   (jmorph.morph_open, tmorph.morph_open)):
        want = np.asarray(jf(jnp.asarray(img), kw, kh))
        np.testing.assert_array_equal(tf(torch.from_numpy(img), kw, kh).numpy(), want)


@pytest.mark.parametrize("w", [8, 13, 32, 70])
def test_pack_bits_msb_first(w):
    mask = np.random.RandomState(w).rand(3, 5, w) > 0.5
    want = np.asarray(jsep.pack_bits_device(jnp.asarray(mask)))
    got = tsep.pack_bits_device(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.packbits(mask, axis=-1))
    np.testing.assert_array_equal(tsep.unpack_mask_bits(got[0], w),
                                  mask[0].astype(np.uint8) * 255)


def test_apply_threshold_uint8_scaling():
    arr = np.array([10, 20, 200], np.uint8)
    assert tsep.apply_threshold(arr, 0.05).tolist() == \
        jsep.apply_threshold(arr, 0.05).tolist() == [0, 255, 255]
