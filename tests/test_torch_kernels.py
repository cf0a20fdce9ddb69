"""The port's kernels K1 (conv3x3) and K2 (separator morphology).

Each plain version against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs; and a line-for-line Python transliteration
of K2's streaming CUDA algorithm (segments, halos, lags) against the plain
version. The CUDA kernels themselves are held against the plain versions
on a card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from citlab_as_tpu.ops.morphology import morph_open as jax_morph_open
from citlab_as_tpu.ops.pallas.conv3x3 import conv3x3_mxu
from citlab_as_tpu.ops.pallas.separator_morphology import fused_separator_masks
from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
from tests.test_torch_cuda import _k1_inputs, _synthetic, _to_oihw

K1_SHAPES = [(2, 32, 48, 8, 8), (1, 16, 32, 16, 16), (1, 20, 40, 4, 8),
             (1, 18, 30, 16, 8), (1, 32, 32, 32, 32), (1, 24, 64, 8, 32)]


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_conv3x3_plain_matches_pallas(shape):
    x, w3, bias = _k1_inputs(shape)
    ref = conv3x3_mxu(jnp.asarray(x), jnp.asarray(w3), jnp.asarray(bias),
                      tile_rows=8)
    got = k1.conv3x3(torch.from_numpy(x), _to_oihw(w3), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_conv3x3_plain_relu_matches_pallas():
    x, w3, bias = _k1_inputs((1, 16, 16, 8, 8), seed=1)
    ref = conv3x3_mxu(jnp.asarray(x), jnp.asarray(w3), jnp.asarray(bias),
                      relu=True, tile_rows=8)
    got = k1.conv3x3(torch.from_numpy(x), _to_oihw(w3), torch.from_numpy(bias),
                     relu=True)
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_cpu_tensors_do_not_count_launches():
    before = (k1.launches, k2.launches)
    x, w3, bias = _k1_inputs((1, 8, 8, 8, 8))
    k1.conv3x3(torch.from_numpy(x), _to_oihw(w3), torch.from_numpy(bias))
    k2.separator_morphology(torch.zeros(1, 8, 8), 3, 3, 3)
    assert (k1.launches, k2.launches) == before


# ---------------------------------------------------------------- K2

def _border_image():
    img = np.zeros((40, 280), np.float32)
    img[0:3, :] = 255.0      # rule on the top border
    img[:, 0:3] = 255.0      # rule on the left border
    return img


def _jax_chain(cleaned, h_k, v_k, noise_k):
    x = jnp.asarray(cleaned, jnp.float32)
    horizontal = jax_morph_open(x, h_k, 1)
    vertical = jax_morph_open(x, 1, v_k)
    horizontal = jnp.clip(horizontal - vertical, 0, 255)
    horizontal = jax_morph_open(horizontal, noise_k, 1)
    return np.asarray(horizontal), np.asarray(vertical)


K2_CASES = [
    ("synthetic", (5, 7, 3)), ("synthetic", (15, 30, 10)),
    ("synthetic", (4, 6, 2)), ("multi_stripe", (11, 16, 7)),
    ("border", (9, 9, 5)),
]


def _k2_image(kind):
    return {"synthetic": lambda: _synthetic(),
            "multi_stripe": lambda: _synthetic(h=64, w=700, seed=3),
            "border": _border_image}[kind]()


@pytest.mark.parametrize("kind,kernels", K2_CASES)
def test_separator_morphology_plain_matches_pallas(kind, kernels):
    img = _k2_image(kind)
    want_h, want_v = fused_separator_masks(img, *kernels, interpret=True)
    got_h, got_v = k2.separator_morphology(torch.from_numpy(img), *kernels)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))


def test_separator_morphology_wide_halo_matches_jax_chain():
    """h_k + noise_k >= 64: past the Pallas kernel's fixed halo; held
    against the JAX morph_open chain. uint8 in, uint8 out, batched."""
    imgs = np.stack([_synthetic(h=80, w=900, seed=s) for s in (4, 5)])
    kernels = (45, 30, 25)
    got_h, got_v = k2.separator_morphology(
        torch.from_numpy(imgs.astype(np.uint8)), *kernels)
    assert got_h.dtype == torch.uint8 and got_v.dtype == torch.uint8
    for i in range(2):
        want_h, want_v = _jax_chain(imgs[i], *kernels)
        np.testing.assert_array_equal(got_v[i].numpy(), want_v.astype(np.uint8))
        np.testing.assert_array_equal(got_h[i].numpy(), want_h.astype(np.uint8))


# Python transliteration of csrc/separator_morphology.cu, block by block
_V_SEG, _H_ROWS, _H_SEG = 64, 64, 128
_NEG = -(1 << 30)


def _k2_stream(img, hk, vk, nk):
    h, w = img.shape
    x = img != 0
    v = np.zeros((h, w), bool)
    a, bt = vk // 2, vk - 1 - vk // 2
    for col in range(w):                                # vertical_open_kernel
        for lo in range(0, h, _V_SEG):
            hi = min(h, lo + _V_SEG)
            last_zero = last_one = _NEG
            for t in range(lo - 2 * a, hi + 2 * bt):
                if 0 <= t < h and not x[t, col]:
                    last_zero = t
                j = t - bt
                if 0 <= j < h and last_zero < j - a:
                    last_one = j
                i = j - bt
                if lo <= i < hi:
                    v[i, col] = last_one >= i - a
    out = np.zeros((h, w), bool)
    a1, b1, a2, b2 = hk // 2, hk - 1 - hk // 2, nk // 2, nk - 1 - nk // 2
    L, R = 2 * (a1 + a2), 2 * (b1 + b2)
    for r in range(h):                                  # horizontal_open_kernel
        for c0 in range(0, w, _H_SEG):
            left, cend = c0 - L, min(w, c0 + _H_SEG)
            span = np.arange(left, c0 + _H_SEG + R)
            inside = (span >= 0) & (span < w)
            sx = np.ones(span.size, bool)               # the staged tile
            sv = np.zeros(span.size, bool)
            sx[inside], sv[inside] = x[r, span[inside]], v[r, span[inside]]
            lz_x = lo_e1 = lz_s = lo_e2 = _NEG
            for t in range(left, cend + R):
                if 0 <= t < w and not sx[t - left]:
                    lz_x = t
                j1 = t - b1
                if 0 <= j1 < w and lz_x < j1 - a1:
                    lo_e1 = j1
                i1 = j1 - b1
                if i1 >= left and 0 <= i1 < w:
                    if not (lo_e1 >= i1 - a1 and not sv[i1 - left]):
                        lz_s = i1
                j2 = i1 - b2
                if 0 <= j2 < w and lz_s < j2 - a2:
                    lo_e2 = j2
                i2 = j2 - b2
                if c0 <= i2 < cend:
                    out[r, i2] = lo_e2 >= i2 - a2
    return out.astype(np.float32) * 255, v.astype(np.float32) * 255


@pytest.mark.parametrize("hw,kernels,seed", [
    ((70, 300), (15, 30, 10), 0), ((130, 260), (4, 6, 2), 1),
    ((40, 280), (9, 9, 5), 2), ((66, 150), (40, 33, 30), 3),
    ((20, 20), (1, 1, 1), 4),
])
def test_k2_streaming_algorithm_matches_plain(hw, kernels, seed):
    """The CUDA kernel's per-thread streaming windows, segment starts and
    shared-memory halos, run in Python, equal the plain max_pool chain —
    even k (shifted anchors), border-touching runs, halos past 64."""
    h, w = hw
    img = _synthetic(h=h, w=w, seed=seed)
    img[0:2, :w // 3] = 255.0
    img[:h // 2, -2:] = 255.0
    got_h, got_v = _k2_stream(img, *kernels)
    want_h, want_v = k2.separator_morphology_plain(torch.from_numpy(img), *kernels)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_h, want_h.numpy())
