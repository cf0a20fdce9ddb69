"""The port's kernels K1 (conv3x3) and K2 (separator morphology).

Each plain version against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs; and numpy transliterations of what the
CUDA kernels do that no CPU run reaches: K1's implicit GEMM over the
packed weights and the halo tile as the kernel indexes them, and K2's
bit-plane algorithm (words, funnel shifts, halo fills, tile walk, aligned
16-byte pieces), each against the plain version. The CUDA kernels
themselves are held against the plain versions on a card in
``test_torch_cuda.py``.
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


# ------------------------------------------- K1 as csrc/conv3x3.cu indexes it

_TH = 8


def _k1_halo_tile(x, b, oy0, ox0, tw, cinp, piece):
    """load_tile: [(TH+2) * (tw+2), cinp], a piece of ``piece`` channels
    zero-filled when its pixel is outside the image or it starts past Cin."""
    _, h, w, cin = x.shape
    in_w = tw + 2
    tile = np.zeros(((_TH + 2) * in_w, cinp), np.float32)
    for pix in range((_TH + 2) * in_w):
        gy, gx = oy0 - 1 + pix // in_w, ox0 - 1 + pix % in_w
        for p0 in range(0, cinp, piece):
            if 0 <= gy < h and 0 <= gx < w and p0 < cin:
                n = min(piece, cin - p0)
                tile[pix, p0:p0 + n] = x[b, gy, gx, p0:p0 + n]
    return tile


def _k1_m_fragments(cin, cinp, cout):
    """launch_bf16's choice: 64-pixel tile rows (4 M fragments a warp) when
    two blocks of them fit in an SM's shared memory, else 32-pixel rows."""
    if cin == 8:
        return 4
    pitch, opitch = 16 * ((cinp // 8) | 1), 16 * ((cout // 8) | 1)
    smem4 = 9 * cout * pitch + _TH * 64 * opitch + 2 * (_TH + 2) * 66 * pitch
    return 4 if 2 * (smem4 + 1024) <= 228 * 1024 else 2


def _k1_mma(x, packed, bias, cin, cinp, relu=False):
    """The bf16 kernel's tile walk and fragments in f32 numpy: a warp per
    tile row, M fragments of 16 pixels, N fragments of 8 channels, one k
    step per (tap, 16 channels) — or per tap with k = 8 when Cin == 8."""
    bsz, h, w, _ = x.shape
    cout = packed.shape[1]
    k8 = cin == 8
    mf = _k1_m_fragments(cin, cinp, cout)
    tw, kstep = 16 * mf, (8 if k8 else 16)
    in_w = tw + 2
    y = np.full((bsz, h, w, cout), np.nan, np.float32)
    for b in range(bsz):
        for oy0 in range(0, h, _TH):
            for ox0 in range(0, w, tw):
                tile = _k1_halo_tile(x, b, oy0, ox0, tw, cinp,
                                     8 if cin % 8 == 0 else 1)
                for warp in range(_TH):
                    acc = np.zeros((tw, cout), np.float32)
                    for tap in range(9):
                        ky, kx = divmod(tap, 3)
                        for kc in range(cinp // kstep):
                            ks = slice(kc * kstep, (kc + 1) * kstep)
                            for m in range(mf):
                                first = (warp + ky) * in_w + kx + m * 16
                                a = tile[first:first + 16, ks]            # 16 x k
                                for n in range(cout // 8):
                                    bfrag = packed[tap, n * 8:(n + 1) * 8, ks]
                                    acc[m * 16:(m + 1) * 16, n * 8:(n + 1) * 8] += a @ bfrag.T
                    out = acc + bias
                    if relu:
                        out = np.maximum(out, 0)
                    oy = oy0 + warp
                    if oy < h:
                        n_ok = min(tw, w - ox0)
                        y[b, oy, ox0:ox0 + n_ok] = out[:n_ok]
    return y


def _k1_fma(x, packed, bias, cin, cinp):
    """The f32 kernel: 8 x 32 tiles, chunks of 8 channels, per tap a dot of
    the pixel's 8 channels with a packed weight row."""
    bsz, h, w, _ = x.shape
    cout = packed.shape[1]
    y = np.full((bsz, h, w, cout), np.nan, np.float32)
    for b in range(bsz):
        for oy0 in range(0, h, _TH):
            for ox0 in range(0, w, 32):
                tile = _k1_halo_tile(x, b, oy0, ox0, 32, cinp,
                                     4 if cin % 4 == 0 else 1).reshape(_TH + 2, 34, cinp)
                acc = np.zeros((_TH, 32, cout), np.float32)
                for c0 in range(0, cinp, 8):
                    for tap in range(9):
                        ky, kx = divmod(tap, 3)
                        acc += (tile[ky:ky + _TH, kx:kx + 32, c0:c0 + 8]
                                @ packed[tap, :, c0:c0 + 8].T)
                rows, cols = min(_TH, h - oy0), min(32, w - ox0)
                y[b, oy0:oy0 + rows, ox0:ox0 + cols] = (acc + bias)[:rows, :cols]
    return y


K1_EMULATED = [
    (1, 16, 64, 8, 8), (1, 11, 70, 8, 16), (2, 9, 33, 16, 16), (1, 8, 64, 16, 32),
    (1, 13, 37, 32, 32), (1, 17, 20, 16, 8), (1, 8, 66, 32, 16), (1, 10, 35, 64, 32),
    (1, 9, 18, 12, 8), (1, 8, 40, 24, 16), (1, 5, 7, 48, 32),
]


@pytest.mark.parametrize("shape", K1_EMULATED)
def test_k1_implicit_gemm_over_packed_weights_matches_plain(shape):
    """pack_weights + the kernel's tap order, k steps (k8 at Cin = 8), zero
    rows past Cin, halo zero-fill and ragged tiles, in f32 numpy, equal
    conv3x3_plain. The weights are rounded to bf16 first, so that the bf16
    packing is exact."""
    _, _, _, cin, cout = shape
    x, w3, bias = _k1_inputs(shape, seed=sum(shape))
    wt = _to_oihw(w3).bfloat16()
    cinp, row = k1.packed_layout(cin, torch.bfloat16)
    packed = k1.pack_weights(wt)
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == (9, cout, row)
    assert cinp >= cin and row % 8 == 0 and (row // 8) % 2 == 1
    assert not packed[:, :, cin:].any()
    got = _k1_mma(x, packed.float().numpy(), bias, cin, cinp, relu=True)
    want = k1.conv3x3_plain(torch.from_numpy(x), wt.float(), torch.from_numpy(bias),
                            relu=True)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 9, 40, 8, 8), (1, 12, 33, 12, 16),
                                   (1, 8, 32, 64, 32), (1, 10, 31, 10, 8)])
def test_k1_f32_chunks_over_packed_weights_match_plain(shape):
    _, _, _, cin, cout = shape
    x, w3, bias = _k1_inputs(shape, seed=sum(shape))
    wt = _to_oihw(w3)
    cinp, row = k1.packed_layout(cin, torch.float32)
    packed = k1.pack_weights(wt)
    assert tuple(packed.shape) == (9, cout, row) and row == cinp and cinp % 8 == 0
    got = _k1_fma(x, packed.numpy(), bias, cin, cinp)
    want = k1.conv3x3_plain(torch.from_numpy(x), wt, torch.from_numpy(bias))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_k1_packed_weights_are_cached_until_the_tensor_changes():
    wt = _to_oihw(_k1_inputs((1, 8, 8, 16, 8))[1])
    first = k1._packed_weights(wt)
    assert k1._packed_weights(wt) is first
    wt.mul_(2.0)                                    # in-place update: new version
    second = k1._packed_weights(wt)
    assert second is not first
    torch.testing.assert_close(second, k1.pack_weights(wt))
    ident = id(wt)
    del wt
    assert ident not in k1._packed


# -------------------------- K2 as csrc/separator_morphology.cu computes it

_TR, _TC = 64, 256
_TCW = _TC // 32
_ONES = np.uint32(0xFFFFFFFF)


def _col_mask(gw, w):
    """Bits of global words ``gw`` (columns 32 gw .. 32 gw + 31) in the image."""
    lo = gw.astype(np.int64) * 32
    n = np.clip(w - lo, 0, 32)
    mask = ((np.uint64(1) << n.astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
    return np.where((lo < 0) | (lo >= w), np.uint32(0), mask)


def _span_word(plane, q):
    """plane[:, wi + q] for every wi, zero outside the span."""
    nw = plane.shape[1]
    out = np.zeros_like(plane)
    src = np.arange(nw) + q
    ok = (src >= 0) & (src < nw)
    out[:, ok] = plane[:, src[ok]]
    return out


def _funnelshift_r(lo, hi, s):
    if s == 0:
        return lo.copy()
    return (lo >> np.uint32(s)) | (hi << np.uint32(32 - s))


def _row_window(plane, a, b, is_and):
    acc = np.full_like(plane, _ONES if is_and else 0)
    for d in range(-a, b + 1):
        q, s = d >> 5, d & 31
        v = _funnelshift_r(_span_word(plane, q), _span_word(plane, q + 1), s)
        acc = acc & v if is_and else acc | v
    return acc


def _col_window(plane, rows, a, b, is_and):
    """Window [r - a, r + b] down the columns, for the plane rows ``rows``."""
    acc = np.full((len(rows), plane.shape[1]), _ONES if is_and else 0, np.uint32)
    for d in range(-a, b + 1):
        v = plane[rows + d]
        acc = acc & v if is_and else acc | v
    return acc


def _k2_bitplane(img, hk, vk, nk, piece=16, base_misalign=0):
    """One block per 64 x 256 tile, as the kernel: x to a bit-plane through
    aligned pieces of ``piece`` elements (the image starting
    ``base_misalign`` elements past a boundary), the chain on words, the
    masks back through aligned pieces."""
    h, w = img.shape
    flat = (img != 0).ravel()
    av, bv = vk // 2, vk - 1 - vk // 2
    a1, b1, a2, b2 = hk // 2, hk - 1 - hk // 2, nk // 2, nk - 1 - nk // 2
    lw = (2 * (a1 + a2) + 31) // 32
    nw = lw + _TCW + (2 * (b1 + b2) + piece - 1 + 31) // 32
    nr = _TR + 2 * (av + bv)
    out = np.full((2, h, w), -1, np.int64)
    for r0 in range(0, h, _TR):
        for c0 in range(0, w, _TC):
            w0, top = c0 // 32 - lw, r0 - 2 * av
            gws = w0 + np.arange(nw)
            rows_g = top + np.arange(nr)
            row_ok = (rows_g >= 0) & (rows_g < h)
            inside = np.where(row_ok[:, None], _col_mask(gws, w)[None, :], np.uint32(0))
            X = ~inside                                    # ones outside the image
            cs, ce = max(0, w0 * 32), min(w, (w0 + nw) * 32)
            for rb in np.nonzero(row_ok)[0]:
                gy = top + rb
                mis = (base_misalign + gy * w + cs) % piece
                for k in range((nw * 32) // piece + 1):
                    lo = cs - mis + k * piece
                    if lo >= ce:
                        continue
                    # the whole aligned piece wherever the tensor has it (it
                    # may reach into the neighbouring row), then the bits of
                    # columns [cs, ce)
                    bits = 0
                    for e in range(piece):
                        if 0 <= gy * w + lo + e < h * w:
                            bits |= int(flat[gy * w + lo + e]) << e
                    bits &= ((1 << min(ce - lo, piece)) - 1) & ~((1 << max(cs - lo, 0)) - 1)
                    pos = lo - w0 * 32
                    if pos < 0:
                        bits >>= -pos
                        pos = 0
                    word, sh = pos >> 5, pos & 31
                    X[rb, word] |= np.uint32((bits << sh) & 0xFFFFFFFF)
                    if sh + piece > 32 and word + 1 < nw:
                        X[rb, word + 1] |= np.uint32(bits >> (32 - sh))
            tile_rows = 2 * av + np.arange(_TR)
            ev = np.zeros_like(X)
            er = np.arange(av, nr - bv)
            ev[er] = _col_window(X, er, av, bv, True) & inside[er]
            t_in = inside[tile_rows]
            pa = _row_window(X[tile_rows], a1, b1, True) & t_in
            pv = _col_window(ev, tile_rows, av, bv, False)
            pb = (_row_window(pa, a1, b1, False) & ~pv) | ~t_in
            pa = _row_window(pb, a2, b2, True) & t_in
            hor = _row_window(pa, a2, b2, False)
            pb[:, lw:lw + _TCW + 1] = hor[:, lw:lw + _TCW + 1]   # the tile's words + 1
            for which, plane in enumerate((pb, pv)):
                for t in range(min(_TR, h - r0)):
                    gy = r0 + t
                    # the border between two blocks' columns moves right to
                    # the row's next aligned boundary
                    shift = -(base_misalign + gy * w + c0) % piece
                    cs = 0 if c0 == 0 else min(c0 + shift, w)
                    ce = min(w, c0 + _TC + shift)
                    mis = (base_misalign + gy * w + cs) % piece
                    for k in range(_TC // piece + 2):
                        lo = cs - mis + k * piece
                        if lo >= ce:
                            continue
                        if lo >= cs and lo + piece <= ce:
                            pos = lo - w0 * 32
                            word, sh = pos >> 5, pos & 31
                            hi = int(plane[t, word + 1]) if word + 1 < nw else 0
                            bits = (int(plane[t, word]) | (hi << 32)) >> sh
                            assert (out[which, gy, lo:lo + piece] < 0).all()
                            out[which, gy, lo:lo + piece] = [
                                (bits >> e) & 1 for e in range(piece)]
                        else:
                            for e in range(max(lo, cs), min(lo + piece, ce)):
                                pos = e - w0 * 32
                                assert out[which, gy, e] < 0, "written twice"
                                out[which, gy, e] = (int(plane[t, pos >> 5]) >> (pos & 31)) & 1
    assert (out >= 0).all(), "a pixel was never written"
    return out[0].astype(np.float32) * 255, out[1].astype(np.float32) * 255


@pytest.mark.parametrize("hw,kernels,seed,piece,misalign", [
    ((70, 300), (15, 30, 10), 0, 16, 0), ((130, 260), (4, 6, 2), 1, 16, 5),
    ((40, 280), (9, 9, 5), 2, 4, 1), ((66, 150), (40, 33, 30), 3, 16, 0),
    ((20, 20), (1, 1, 1), 4, 16, 3), ((70, 520), (48, 30, 32), 5, 16, 7),
    ((75, 333), (15, 30, 10), 6, 4, 2), ((33, 290), (70, 5, 3), 7, 16, 0),
])
def test_k2_bitplane_algorithm_matches_plain(hw, kernels, seed, piece, misalign):
    """The CUDA kernel's words, funnel shifts, halo fills, tile walk and
    aligned pieces (16 uint8 or 4 f32 elements), run in numpy, equal the
    plain max_pool chain — even k (shifted anchors), border-touching runs,
    rows that start at any alignment, windows wider than a word, width
    > 256 with h_k + noise_k >= 64, H and W not multiples of 32."""
    h, w = hw
    img = _synthetic(h=h, w=w, seed=seed)
    img[0:2, :w // 3] = 255.0
    img[:h // 2, -2:] = 255.0
    got_h, got_v = _k2_bitplane(img, *kernels, piece=piece, base_misalign=misalign)
    want_h, want_v = k2.separator_morphology_plain(torch.from_numpy(img), *kernels)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_h, want_h.numpy())
