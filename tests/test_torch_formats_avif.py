"""AVIF as PIL 12.1 reads it (libavif 1.3.0, dav1d 1.5.1, libyuv), against
PIL, the JAX package's ``load_image`` and dav1d itself.

Every small AVIF fixture of ``tests/data/torch_formats_variants/small/``
(``scripts/avif_variants.py``: a drawn page and a photo at every speed,
quality 0-100, 4:0:0 / 4:2:0 / 4:2:2 / 4:4:4, full and limited range,
tiles, aom's intra options one at a time, odd sizes, the colour box
relabelled, EXIF / XMP / ICC / alpha; loop restoration, CDEF, 10- and
12-bit streams, superres and the matrices libavif converts in floating
point; film grain, grid items, avis sequences, premultiplied alpha and
frames rescaled to their ispe) and the nine full-size pages of
``tests/data/torch_formats_avif/`` decode through the port's
``load_image`` to exactly PIL's "L" and "RGB" bytes (tolerance 0) and to
PIL's recorded digests. The AV1 planes equal dav1d's, 8- or 16-bit, read
through the ``dav1d_*`` calls of the libavif PIL ships (ctypes, tests
only), film grain with dav1d's SIMD on and off; on the
identity-relabelled 4:4:4 files PIL's "RGB" bytes are the planes
themselves (G = Y, B = U, R = V). Every route of the YUV to RGB
conversion equals libavif's ``avifImageYUVToRGB`` on random planes of
every depth, layout, range and matrix, premultiplied alpha included; the
film grain synthesis equals ``dav1d_apply_grain``, the rescale
``avifImageScale`` and the unpremultiply
``avifRGBImageUnpremultiplyAlpha``, on random inputs. PIL's container
refusals raise ``UnsupportedImageFormat`` by name, and a seeded sample of
``scripts/fuzz_avif.py`` holds damaged files to PIL.
"""
import ctypes
import glob
import hashlib
import io
import json
import os
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import avif
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import fuzz_avif  # noqa: E402
from scripts.avif_variants import (AVIF_FAULTS, AVIF_VARIANTS, avif_bytes,  # noqa: E402
                                   depth_bytes, huge_frame_bytes, photo_rgb)

SMALL_DIR = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PAGES_DIR = os.path.join(REPO, "tests", "data", "torch_formats_avif")
SMALL = sorted(os.path.basename(p) for p in glob.glob(os.path.join(SMALL_DIR, "avif_*.avif")))
PAGES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(PAGES_DIR, "*.avif")))


def _records():
    with open(os.path.join(SMALL_DIR, "small.json")) as f:
        return {r["file"]: r for r in json.load(f)}


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _planes(data: bytes):
    info = avif.open_avif(data)
    row, y, u, v = avif.decode_planes(data, info)
    return info, row, [y] if u is None else [y, u, v]


# ------------------------------------------------------------ the fixtures

def test_small_fixtures_are_the_catalogue():
    assert SMALL == sorted(f"avif_{name}.avif" for name in AVIF_VARIANTS)
    assert len(SMALL) >= 100


@pytest.mark.parametrize("name", SMALL)
def test_small_fixture_is_pils_in_L_and_RGB(name):
    """load_image equals the JAX package's (PIL's) bytes and PIL's
    recorded digests, and image_size PIL's size."""
    path = os.path.join(SMALL_DIR, name)
    rec = _records()[name]
    for mode in ("L", "RGB"):
        jio._IMAGE_CACHE.clear()
        tio._IMAGE_CACHE.clear()
        want = jio.load_image(path, mode)
        got = tio.load_image(path, mode)
        np.testing.assert_array_equal(got, want)
        assert _digest(got) == rec[f"sha256_{mode}"]
    assert list(tio.image_size(path)) == rec["size"]
    with Image.open(path) as im:
        assert avif.open_avif(_read(path)).mode == im.mode


@pytest.mark.parametrize("name", SMALL)
def test_av1_planes_are_dav1ds(name):
    """Each AV1 frame of the colour image (a grid's tiles, a track's first
    sample), before libavif scales or stitches it, equals dav1d's planes
    (its film grain applied)."""
    data = _read(os.path.join(SMALL_DIR, name))
    for obus, _, planes in avif.colour_frames(data):
        want = fuzz_avif.dav1d_planes(obus)
        assert want is not None and len(want) == len(planes)
        for got, ref in zip(planes, want):
            np.testing.assert_array_equal(got, ref)


GRAIN = [n for n in SMALL if "grain" in n]


@pytest.mark.parametrize("name", GRAIN)
def test_film_grain_planes_are_dav1ds_c_code(name):
    """The film-grain fixtures' planes equal dav1d's with its SIMD off too
    (dav1d's C film grain, which its assembly matches), and differ from
    the planes before grain."""
    data = _read(os.path.join(SMALL_DIR, name))
    for obus, row, planes in avif.colour_frames(data):
        assert row[22] == 1
        want = fuzz_avif.dav1d_planes(obus, simd=False)
        for got, ref in zip(planes, want):
            np.testing.assert_array_equal(got, ref)
        bare = fuzz_avif.dav1d_planes(obus, grain=False)
        assert any(not np.array_equal(a, b) for a, b in zip(planes, bare))


@pytest.mark.parametrize("speed,quality,subsampling,page", [
    (6, 75, "4:2:0", True), (8, 50, "4:4:4", False), (4, 90, "4:2:0", True),
    (10, 30, "4:0:0", False), (2, 60, "4:2:2", True)])
def test_full_sequence_header_key_frame_is_dav1ds(speed, quality, subsampling, page):
    """PIL's still images carry the reduced still-picture header; the first
    frame of an image sequence carries the full one (operating points,
    order hints, frame size and refresh fields, error resilience): its
    planes equal dav1d's."""
    from citlab_as_tpu_torch.utils.avif import _frame
    from scripts.avif_variants import page_rgb, sequence_key_frame
    arr = page_rgb(160, 96, seed=speed) if page else photo_rgb(160, 96, seed=speed)
    obus = sequence_key_frame(arr, speed=speed, quality=quality, subsampling=subsampling)
    assert (obus[2 + 2] >> 3) & 1 == 0                 # the sequence header is not reduced
    want = fuzz_avif.dav1d_planes(obus)
    _, got = _frame(obus, "sequence key frame", 160, 96)
    assert want is not None and len(want) == len(got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["avif_identity-444.avif", "avif_identity-444-limited.avif"])
def test_identity_relabelled_444_rgb_is_the_planes(name):
    """With the colour box relabelled to the identity matrix, libavif hands
    the planes through: PIL's "RGB" is (V, Y, U), in full range the planes
    themselves."""
    data = _read(os.path.join(SMALL_DIR, name))
    _, row, (y, u, v) = _planes(data)
    assert (row[3], row[4]) == (0, 0)                  # 4:4:4
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    if name.endswith("-limited.avif"):
        scale = lambda p: avif._limited_to_full(p).astype(np.uint8)  # noqa: E731
        np.testing.assert_array_equal(rgb, np.stack([scale(v), scale(y), scale(u)], -1))
    else:
        np.testing.assert_array_equal(rgb, np.stack([v, y, u], -1))
        assert rgb[..., 1].mean() == y.mean()


def test_fixtures_exercise_every_part1_tool():
    """The decoder's counters over the small fixtures: IntraBC, palette,
    filter intra and CfL blocks, deblocked and undeblocked frames, every
    chroma layout, several tiles, 128 x 128 superblocks."""
    seen = {"intrabc": 0, "palette": 0, "filter_intra": 0, "cfl": 0, "deblocked": 0,
            "not_deblocked": 0}
    layouts = set()
    for name in SMALL:
        _, row, planes = _planes(_read(os.path.join(SMALL_DIR, name)))
        seen["intrabc"] += int(row[11] > 0)
        seen["palette"] += int(row[12] > 0)
        seen["filter_intra"] += int(row[13] > 0)
        seen["cfl"] += int(row[14] > 0)
        seen["deblocked" if row[15] else "not_deblocked"] += 1
        layouts.add((int(row[2]), int(row[3]), int(row[4])))
    assert all(v >= 3 for v in seen.values()), seen
    assert layouts == {(1, 1, 1), (0, 1, 1), (0, 1, 0), (0, 0, 0)}


def test_fixtures_exercise_every_part2_tool():
    """The decoder's info row over the small fixtures: 10- and 12-bit
    streams in every layout, CDEF, Wiener and self-guided units, frames
    whose restoration type is Wiener, self-guided or switchable, superres;
    and every conversion route a file without alpha reaches (libyuv; the
    float matrix, identity, YCgCo and YCgCo-Re; monochrome). The RGBA routes
    of 10- and 12-bit files are held to libavif on random planes below."""
    seen = {"cdef": 0, "wiener": 0, "sgrproj": 0, "superres": 0}
    depths, frame_lr, routes = set(), set(), set()
    for name in SMALL:
        data = _read(os.path.join(SMALL_DIR, name))
        info, row, planes = _planes(data)
        depths.add((int(row[5]), len(planes), int(row[3]), int(row[4])))
        seen["cdef"] += int(row[18] > 0)
        seen["wiener"] += int(row[19] > 0)
        seen["sgrproj"] += int(row[20] > 0)
        seen["superres"] += int(row[17] != 8)
        frame_lr |= {(int(row[21]) >> (2 * p)) & 3 for p in range(len(planes))}
        matrix, primaries, full = avif.cicp(info, row)
        route = avif.conversion(int(row[5]), len(planes) == 1, int(row[3]), int(row[4]),
                                matrix, primaries, full, info.alpha is not None)
        routes.add(route[:2] if route[0] == "libyuv" or len(planes) > 1 else ("float", "mono"))
    assert all(v >= 3 for v in seen.values()), seen
    assert {d[:2] for d in depths} >= {(b, n) for b in (10, 12) for n in (1, 3)}
    assert {d for d in depths if d[0] > 8 and d[1] == 3} >= {
        (b, 3, x, y) for b in (10, 12) for x, y in ((1, 1), (1, 0), (0, 0))}
    assert frame_lr >= {0, 1, 2, 3}, frame_lr
    assert routes == {("libyuv", 0), ("float", 0), ("float", 1), ("float", 2), ("float", 3),
                      ("float", "mono")}, routes


def test_fixtures_exercise_every_part3_tool():
    """From the decoder's info row and the container: film grain (luma and
    chroma points, every AR lag, overlap, chroma scaling from luma,
    restricted range, at 10 and 12 bits, in every layout), grid items (with
    an alpha grid), avis tracks (with an alpha track), premultiplied alpha,
    limited-range alpha, and frames rescaled to their ispe or tkhd size,
    larger and smaller, at 8 and 10 bits."""
    seen = {"grid": 0, "alpha grid": 0, "track": 0, "alpha track": 0, "premultiplied": 0,
            "limited alpha": 0, "larger": 0, "smaller": 0, "rescaled 10-bit": 0,
            "grain chroma": 0, "grain overlap": 0, "grain cfl": 0, "grain clip": 0}
    lags, grain_depths, grain_layouts = set(), set(), set()
    for name in SMALL:
        data = _read(os.path.join(SMALL_DIR, name))
        info = avif.open_avif(data)
        frames = avif.colour_frames(data, info)
        row = frames[0][1]
        seen["grid"] += info.color_src.grid is not None
        seen["alpha grid"] += info.alpha_src is not None and info.alpha_src.grid is not None
        seen["track"] += info.color is None
        seen["alpha track"] += info.color is None and info.alpha_src is not None
        seen["premultiplied"] += info.premultiplied
        if info.alpha is not None:
            alpha_row = avif._frame(avif._obus(info.alpha_src.tiles[0], info.meta, data), "",
                                    *info.alpha_src.tiles[0][1:])[0]
            seen["limited alpha"] += not alpha_row[7]
        for _, (w, h), (_, r, _) in zip(info.color_src.tiles, [t[1:] for t in
                                                                 info.color_src.tiles], frames):
            if (int(r[0]), int(r[1])) != (w, h):
                seen["larger" if w * h > r[0] * r[1] else "smaller"] += 1
                seen["rescaled 10-bit"] += r[5] == 10
        if row[22]:
            lags.add(int(row[25]) & 3)
            seen["grain chroma"] += int(row[24]) > 0
            seen["grain overlap"] += bool(int(row[25]) & 4)
            seen["grain cfl"] += bool(int(row[25]) & 8)
            seen["grain clip"] += bool(int(row[25]) & 16)
            grain_depths.add(int(row[5]))
            grain_layouts.add((int(row[2]), int(row[3]), int(row[4])))
    assert all(v >= 1 for v in seen.values()), seen
    assert lags == {0, 1, 2, 3} and grain_depths == {8, 10, 12}, (lags, grain_depths)
    assert grain_layouts == {(1, 1, 1), (0, 1, 1), (0, 1, 0), (0, 0, 0)}, grain_layouts


def _random_grain(rng, mono, ssx, ssy, lag, overlap, cfl, clip):
    """Random valid film grain parameters in dav1d's Dav1dFilmGrainData
    form (fuzz_avif.dav1d_grain)."""
    num_y = int(rng.integers(0, 15))
    p = {"seed": int(rng.integers(0, 65536)), "num_y_points": num_y, "y_points": [0] * 28,
         "chroma_scaling_from_luma": int(cfl and not mono), "num_uv_points": [0, 0],
         "uv_points": [0] * 40, "scaling_shift": int(rng.integers(8, 12)),
         "ar_coeff_lag": lag, "ar_coeffs_y": [0] * 24, "ar_coeffs_uv": [0] * 56,
         "ar_coeff_shift": int(rng.integers(6, 10)), "grain_scale_shift": int(rng.integers(0, 4)),
         "uv_mult": [0, 0], "uv_luma_mult": [0, 0], "uv_offset": [0, 0],
         "overlap_flag": overlap, "clip_to_restricted_range": clip}
    for i, v in enumerate(np.sort(rng.choice(256, num_y, replace=False))):
        p["y_points"][2 * i:2 * i + 2] = [int(v), int(rng.integers(0, 256))]
    if not (mono or p["chroma_scaling_from_luma"] or (ssx and ssy and num_y == 0)):
        n = [int(rng.integers(1, 11)), int(rng.integers(1, 11))]
        if not (ssx and ssy):
            n = [k * int(rng.integers(0, 2)) for k in n]
        for pl in range(2):
            for i, v in enumerate(np.sort(rng.choice(256, n[pl], replace=False))):
                p["uv_points"][20 * pl + 2 * i:20 * pl + 2 * i + 2] = [
                    int(v), int(rng.integers(0, 256))]
        p["num_uv_points"] = n
    npos = 2 * lag * (lag + 1)
    if num_y:
        p["ar_coeffs_y"][:npos] = rng.integers(-128, 128, npos).tolist()
    for pl in range(2):
        if p["num_uv_points"][pl] or p["chroma_scaling_from_luma"]:
            k = npos + (1 if num_y else 0)
            p["ar_coeffs_uv"][28 * pl:28 * pl + k] = rng.integers(-128, 128, k).tolist()
            p["uv_mult"][pl], p["uv_luma_mult"][pl] = (int(x) for x in rng.integers(-128, 128, 2))
            p["uv_offset"][pl] = int(rng.integers(-256, 256))
    return p


def _port_grain(planes, p, depth, mono, ssx, ssy, is_id):
    """citlab_av1_apply_grain on copies of the planes."""
    packed = ([p["seed"], p["num_y_points"]] + p["y_points"] + [p["chroma_scaling_from_luma"]]
              + p["num_uv_points"] + p["uv_points"] + [p["scaling_shift"], p["ar_coeff_lag"]]
              + p["ar_coeffs_y"] + p["ar_coeffs_uv"][:25] + p["ar_coeffs_uv"][28:53]
              + [p["ar_coeff_shift"], p["grain_scale_shift"]] + p["uv_mult"] + p["uv_luma_mult"]
              + p["uv_offset"] + [p["overlap_flag"], p["clip_to_restricted_range"]])
    packed = np.asarray(packed, np.int32)
    out = [np.ascontiguousarray(x.astype(np.uint16)) for x in planes]
    h, w = out[0].shape
    ptrs = [x.ctypes.data for x in out] + [None] * (3 - len(out))
    avif._lib().citlab_av1_apply_grain(*ptrs, w, h, depth, int(mono), ssx, ssy, int(is_id),
                                       packed.ctypes.data)
    return out


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout", ["4:0:0", "4:2:0", "4:2:2", "4:4:4"])
def test_grain_synthesis_is_dav1ds(depth, layout):
    """The port's film grain synthesis equals dav1d's own dav1d_apply_grain
    (SIMD on and off) on random planes of a random odd or even size, under
    random valid parameters for every AR lag, with and without overlap,
    chroma scaling from luma and clipping to the restricted range, under
    the identity matrix or another."""
    mono = layout == "4:0:0"
    ssx, ssy = {"4:0:0": (1, 1), "4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0)}[layout]
    rng = np.random.default_rng(depth * 10 + ssx + 2 * ssy + 4 * mono)
    w, h = int(rng.integers(1, 90)), int(rng.integers(1, 90))
    arr = photo_rgb(w, h, seed=w)
    carrier = (avif_bytes(arr, subsampling=layout) if depth == 8
               else depth_bytes(arr, depth, subsampling=layout))
    obus = avif.colour_frames(carrier)[0][0]
    base = fuzz_avif.dav1d_planes(obus, grain=False)
    cases = 0
    for lag in range(4):
        for overlap in (0, 1):
            for cfl in (0, 1):
                for clip in (0, 1):
                    p = _random_grain(rng, mono, ssx, ssy, lag, overlap, cfl, clip)
                    planes = [rng.integers(0, 1 << depth, x.shape) for x in base]
                    is_id = bool(rng.integers(0, 2)) and not mono
                    got = _port_grain(planes, p, depth, mono, ssx, ssy, is_id)
                    for simd in (True, False):
                        want = fuzz_avif.dav1d_apply_grain(obus, planes, p, simd=simd,
                                                           identity=is_id)
                        for a, b in zip(got, want):
                            np.testing.assert_array_equal(a, b, err_msg=str((lag, overlap, cfl,
                                                                             clip, simd)))
                        cases += 1
    assert cases == 64


def _libavif_scale(plane, depth, w, h):
    """libavif's avifImageScale of a monochrome image holding the plane
    (avifImage: yuvPlanes[0] at 24, yuvRowBytes[0] at 48), or None."""
    lib = fuzz_avif.libavif()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
    lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
    lib.avifImageScale.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint32, vp]
    lib.avifImageDestroy.argtypes = [vp]
    dtype = np.uint16 if depth > 8 else np.uint8
    im = lib.avifImageCreate(plane.shape[1], plane.shape[0], depth, 4)
    try:
        assert lib.avifImageAllocatePlanes(im, 1) == 0
        ptr = ctypes.c_void_p.from_address(im + 24).value
        rb = ctypes.c_uint32.from_address(im + 48).value
        for r, line in enumerate(plane.astype(dtype)):
            ctypes.memmove(ptr + r * rb, line.tobytes(), line.nbytes)
        if lib.avifImageScale(im, w, h, ctypes.create_string_buffer(512)):
            return None
        ptr = ctypes.c_void_p.from_address(im + 24).value
        rb = ctypes.c_uint32.from_address(im + 48).value
        size = np.dtype(dtype).itemsize
        raw = np.frombuffer(ctypes.string_at(ptr, rb * h), np.uint8).reshape(h, rb)
        return raw[:, :w * size].copy().view(dtype)
    finally:
        lib.avifImageDestroy(im)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_rescale_is_libavifs(depth):
    """avif.scale_plane equals libavif's avifImageScale (libyuv's
    ScalePlane / ScalePlane_12 with the box filter) on random planes over
    every route: a copy, the vertical-only path, 3/4, 1/2, 3/8 and 1/4
    downscales, the box filter, the exact 2x upscales, bilinear up- and
    downscales and point sampling, at sizes from 1 pixel."""
    rng = np.random.default_rng(depth)
    sizes = [1, 2, 3, 5, 8, 13, 16, 24, 31, 48, 64, 97]
    pairs = [(sw, sh, dw, dh) for sw in sizes for sh in sizes[::2] for dw in sizes[1::3]
             for dh in sizes[::3]]
    pairs += [(sw, sh, d(sw), d(sh)) for sw in (8, 16, 32, 48, 96) for sh in (8, 16, 24, 64)
              for d in (lambda v: v * 3 // 4, lambda v: v // 2, lambda v: v * 3 // 8,
                        lambda v: v // 4, lambda v: 2 * v, lambda v: 2 * v - 1)]
    pairs += [(96, 40, 96, 57), (96, 40, 96, 23), (40, 96, 80, 96), (40, 96, 13, 96),
              (120, 120, 40, 40), (17, 9, 35, 9)]
    for sw, sh, dw, dh in pairs:
        plane = rng.integers(0, 1 << depth, (sh, sw))
        want = _libavif_scale(plane, depth, dw, dh)
        got = avif.scale_plane(plane.astype(np.uint16 if depth > 8 else np.uint8), dw, dh, depth)
        np.testing.assert_array_equal(got, want, err_msg=str((sw, sh, dw, dh)))
    assert len(pairs) > 900


def test_unpremultiply_is_libavifs():
    """avif.unpremultiply equals libavif's avifRGBImageUnpremultiplyAlpha
    of 8-bit RGBA (libyuv's ARGBUnattenuate) for every value and alpha."""
    lib = fuzz_avif.libavif()
    lib.avifRGBImageUnpremultiplyAlpha.argtypes = [ctypes.c_void_p]
    v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rng = np.random.default_rng(0)
    px = np.stack([v, rng.permutation(v.reshape(-1)).reshape(v.shape), 255 - v, a],
                  -1).astype(np.uint8)
    want = px.copy()
    rgb = ctypes.create_string_buffer(64)   # avifRGBImage: pixels at 48, rowBytes at 56
    struct.pack_into("<IIIi", rgb, 0, 256, 256, 8, 1)
    struct.pack_into("<QI", rgb, 48, want.ctypes.data, 256 * 4)
    assert lib.avifRGBImageUnpremultiplyAlpha(rgb) == 0
    np.testing.assert_array_equal(avif.unpremultiply(px[..., :3], px[..., 3]), want[..., :3])


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout", ["400", "420", "422", "444"])
def test_premultiplied_conversion_is_libavifs(depth, layout):
    """A premultiplied image with alpha through avifImageYUVToRGB to PIL's
    8-bit RGBA: the port's colour route and its division by the alpha
    (inside libavif's slow float path, or afterwards on the alpha at 8 bits,
    libyuv's shift or libavif's float rescale) equal libavif's on random
    planes, for several matrices (YCgCo and YCgCo-Re too) and both
    ranges."""
    ssx, ssy = {"400": (1, 1), "420": (1, 1), "422": (1, 0), "444": (0, 0)}[layout]
    rng = np.random.default_rng(depth + ssx + 2 * ssy)
    top = 1 << depth
    for full in (True, False):
        for matrix, primaries in ((1, 1), (6, 1), (7, 1), (9, 9), (12, 12), (0, 1), (8, 1),
                                  (16, 1)):
            if (matrix == 0 and layout in ("420", "422")) or (matrix == 8 and not full) or (
                    matrix == 16 and (depth != 10 or not full)):
                continue
            h, w = 9, 13
            y = rng.integers(0, top, (h, w))
            a = rng.integers(0, top, (h, w))
            a[0, :4] = (0, top - 1, 1, top - 2)
            cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
            u, v = ((None, None) if layout == "400" else
                    (rng.integers(0, top, (ch, cw)), rng.integers(0, top, (ch, cw))))
            want = _libavif_yuv_to_rgb(y, u, v, depth, full, matrix, primaries, True, a)
            dtype = np.uint16 if depth > 8 else np.uint8
            cast = lambda p: None if p is None else p.astype(dtype)  # noqa: E731
            got = avif.yuv_to_rgb(cast(y), cast(u), cast(v), ssx, ssy, matrix, full, depth,
                                  primaries, True, cast(a))
            np.testing.assert_array_equal(got, want, err_msg=str((full, matrix)))


def _libavif_yuv_to_rgb(y, u, v, depth, full, matrix, primaries, alpha, alpha_plane=None):
    """libavif 1.3.0's avifImageYUVToRGB, as PIL's decoder calls it (8-bit
    RGB or RGBA, automatic chroma upsampling), on the given planes: the
    avifImage and avifRGBImage fields at libavif 1.3's offsets (depth at 8,
    yuvFormat 12, yuvRange 16, yuvPlanes 24, yuvRowBytes 48, alphaPlane 64,
    alphaRowBytes 72, alphaPremultiplied 80, the CICP triple 104;
    avifRGBImage depth 8, format 12, pixels 48, rowBytes 56). With
    ``alpha_plane`` the image carries it, premultiplied."""
    lib = fuzz_avif.libavif()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
    for fn, args in (("avifImageAllocatePlanes", [vp, ctypes.c_int]),
                     ("avifImageYUVToRGB", [vp, vp]), ("avifRGBImageSetDefaults", [vp, vp]),
                     ("avifImageDestroy", [vp])):
        getattr(lib, fn).argtypes = args
    h, w = y.shape
    fmt = 4 if u is None else (1 if u.shape == y.shape else (2 if u.shape[0] == h else 3))
    im = lib.avifImageCreate(w, h, depth, fmt)
    try:
        ctypes.c_int32.from_address(im + 16).value = int(full)
        for k, value in enumerate((primaries, 13, matrix)):
            ctypes.c_uint16.from_address(im + 104 + 2 * k).value = value
        assert lib.avifImageAllocatePlanes(im, 1 if alpha_plane is None else 0xFF) == 0
        dtype = np.uint16 if depth > 8 else np.uint8
        if alpha_plane is not None:
            ctypes.c_int32.from_address(im + 80).value = 1
        for k, plane in enumerate((y, u, v, alpha_plane)):
            if plane is None:
                continue
            ptr = ctypes.c_void_p.from_address(im + (24 + 8 * k if k < 3 else 64)).value
            row_bytes = ctypes.c_uint32.from_address(im + (48 + 4 * k if k < 3 else 72)).value
            raw = plane.astype(dtype).tobytes()
            step = plane.shape[1] * np.dtype(dtype).itemsize
            for r in range(plane.shape[0]):
                ctypes.memmove(ptr + r * row_bytes, raw[r * step:(r + 1) * step], step)
        rgb = ctypes.create_string_buffer(64)
        lib.avifRGBImageSetDefaults(rgb, im)
        ch = 4 if alpha else 3
        out = np.zeros((h, w, ch), np.uint8)
        struct.pack_into("<Ii", rgb, 8, 8, 1 if alpha else 0)
        struct.pack_into("<QI", rgb, 48, out.ctypes.data, w * ch)
        if lib.avifImageYUVToRGB(im, rgb):
            return None
        return out[..., :3]
    finally:
        lib.avifImageDestroy(im)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout", ["400", "420", "422", "444"])
def test_conversion_routes_are_libavifs(depth, layout):
    """avif.yuv_to_rgb equals libavif's avifImageYUVToRGB (through libyuv or
    libavif's own float code, as libavif chooses) on random planes, in both
    ranges, for every matrix (12 over several primaries, and the ones PIL
    refuses), with and without alpha, at odd and one-pixel sizes."""
    from citlab_as_tpu_torch.utils.raster_formats import Refused
    ssx, ssy = {"400": (1, 1), "420": (1, 1), "422": (1, 0), "444": (0, 0)}[layout]
    rng = np.random.default_rng(depth * 10 + ssx + 2 * ssy)
    dtype = np.uint16 if depth > 8 else np.uint8
    cases = 0
    for full in (True, False):
        for matrix, primaries in ((0, 1), (1, 1), (2, 2), (4, 1), (5, 1), (6, 1), (7, 1),
                                  (8, 1), (9, 1), (12, 1), (12, 2), (12, 5), (12, 9), (12, 4),
                                  (12, 12), (12, 22), (12, 0), (3, 1), (10, 1), (13, 1),
                                  (14, 1), (15, 1), (16, 1), (17, 1)):
            for alpha in (False, True):
                for h, w in ((9, 13), (1, 5), (6, 1)):
                    y = rng.integers(0, 1 << depth, (h, w)).astype(dtype)
                    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
                    u, v = ((None, None) if layout == "400" else
                            (rng.integers(0, 1 << depth, (ch, cw)).astype(dtype),
                             rng.integers(0, 1 << depth, (ch, cw)).astype(dtype)))
                    want = _libavif_yuv_to_rgb(y, u, v, depth, full, matrix, primaries, alpha)
                    try:
                        got = avif.yuv_to_rgb(y, u, v, ssx, ssy, matrix, full, depth,
                                              primaries, alpha)
                    except Refused:
                        got = None
                    key = (full, matrix, primaries, alpha, h, w)
                    assert (want is None) == (got is None), key
                    if want is not None:
                        np.testing.assert_array_equal(got, want, err_msg=str(key))
                    cases += 1
    assert cases == 2 * 24 * 2 * 3


# ------------------------------------------------------------ the pages

@pytest.mark.parametrize("name", PAGES)
def test_full_size_page_is_pils(name):
    path = os.path.join(PAGES_DIR, name)
    with open(os.path.join(PAGES_DIR, name[:-5] + ".json")) as f:
        rec = json.load(f)
    data = _read(path)
    with Image.open(io.BytesIO(data)) as im:
        assert list(im.size) == rec["size"]
        for mode in ("L", "RGB"):
            want = np.asarray(im.convert(mode))
            assert _digest(want) == rec[f"sha256_{mode}"]
            tio._IMAGE_CACHE.clear()
            np.testing.assert_array_equal(tio.load_image(path, mode), want)
    assert list(tio.image_size(path)) == rec["size"]
    _, row, _ = _planes(data)
    # IntraBC, palette, deblocked; CDEF, loop restoration (Wiener or
    # self-guided units), the superres denominator; and part 3's tools
    info = avif.open_avif(data)
    part3 = {"grain.avif": row[22] == 1 and row[24] > 0 and int(row[25]) & 7 == 7,
             "grid.avif": info.color_src.grid == (4, 3, 1420, 2000),
             "sequence.avif": info.color is None,
             "premultiplied.avif": info.premultiplied}
    assert part3.get(name, True), name
    tools = {"defaults.avif": (1, 1, 0, 0, 0, 8), "speed8.avif": (0, 1, 1, 0, 0, 8),
             "scan.avif": (0, 0, 1, 0, 0, 8), "restored.avif": (0, 0, 1, 1, 1, 8),
             "superres.avif": (0, 0, 1, 0, 0, 16), "grain.avif": (0, 0, 1, 0, 0, 8),
             "grid.avif": (0, 0, 1, 0, 0, 8), "sequence.avif": (0, 1, 0, 1, 0, 8),
             "premultiplied.avif": (1, 1, 0, 0, 0, 8)}[name]
    assert (int(row[11] > 0), int(row[12] > 0), int(row[15]), int(row[18] > 0),
            int(row[19] + row[20] > 0), int(row[17])) == tools
    assert os.path.exists(os.path.join(PAGES_DIR, "page", name[:-5] + ".xml"))


def _normalised(path):
    text = open(path, encoding="utf-8").read()
    text = re.sub(r"<LastChange>[^<]*</LastChange>", "", text)
    return re.sub(r'imageFilename="[^"]*"', "", text)


def test_separator_stage_page_equals_png_twin(tmp_path):
    """The port's separator stage on the CPU over the defaults page (palette
    and IntraBC) and its PNG twin (PIL's "L" pixels) writes the same
    PAGE-XML: a stand-in net (dark ink -> separator probability) keeps the
    stage's own scaling, post-processing and writing."""
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    os.makedirs(tmp_path / "page")
    images = []
    for name in ("defaults.avif",):
        stem = name[:-5]
        src = os.path.join(PAGES_DIR, name)
        avif_path = str(tmp_path / name)
        twin = str(tmp_path / f"twin_{stem}.png")
        with open(avif_path, "wb") as f:
            f.write(_read(src))
        Image.open(src).convert("L").save(twin)
        for s in (stem, f"twin_{stem}"):
            with open(os.path.join(PAGES_DIR, "page", f"{stem}.xml"), "rb") as f:
                (tmp_path / "page" / f"{s}.xml").write_bytes(f.read())
        images += [avif_path, twin]

    def net(image_grey):
        prob = np.zeros(image_grey.shape + (2,), np.float32)
        prob[..., 0] = (image_grey < 0.4).astype(np.float32) * 0.9
        prob[..., 1] = 1.0 - prob[..., 0]
        return prob

    tio._IMAGE_CACHE.clear()
    SeparatorNetPostProcessor(images, net, fixed_height=1000, device="cpu").run()
    for a, b in zip(images[::2], images[1::2]):
        xa, xb = (_normalised(tio.get_page_path(p) + ".xml") for p in (a, b))
        assert xa == xb and "SeparatorRegion" in xa


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("name", ["identity-420", "identity-422"])
def test_identity_matrix_with_subsampled_chroma_refused_as_pil_refuses(tmp_path, name):
    """libavif converts the identity matrix only where chroma is as large as
    luma: PIL fails with "Reformat failed", and the port refuses the file
    the same way, naming no later part."""
    path = str(tmp_path / f"{name}.avif")
    with open(path, "wb") as f:
        f.write(AVIF_FAULTS[name]())
    with pytest.raises(RuntimeError, match="Reformat failed"):
        with Image.open(path) as im:
            im.convert("RGB")
    with pytest.raises(tio.UnsupportedImageFormat, match="reformat failed") as e:
        tio.load_image(path, "RGB")
    assert "part" not in str(e.value)


@pytest.mark.parametrize("name", sorted(AVIF_FAULTS))
def test_container_fault_refused_where_pil_refuses(tmp_path, name):
    path = str(tmp_path / f"{name}.avif")
    with open(path, "wb") as f:
        f.write(AVIF_FAULTS[name]())
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("RGB")
    with pytest.raises(tio.UnsupportedImageFormat, match="AVIF"):
        tio.load_image(path, "RGB")


def test_decompression_bomb_refused_from_ispe(tmp_path):
    """An ispe past PIL's decompression-bomb limit is refused from the
    header; past libavif's own size limit (16384 x 16384 pixels), PIL cannot
    identify the file, and the port refuses it too."""
    for side, bomb in ((14000, True), (20000, False)):
        data = bytearray(_read(os.path.join(SMALL_DIR, "avif_page-speed6.avif")))
        i = data.find(b"ispe") + 8
        struct.pack_into(">II", data, i, side, side)
        path = str(tmp_path / f"bomb{side}.avif")
        with open(path, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(Image.DecompressionBombError if bomb else Image.UnidentifiedImageError):
            Image.open(path)
        with pytest.raises(tio.UnsupportedImageFormat,
                           match="decompression-bomb" if bomb else "size limit"):
            tio.image_size(path)


@pytest.mark.parametrize("w,h,word", [(65536, 65536, "past dav1d's frame size limit"),
                                      (65536, 48, "invalid scale for libyuv")])
def test_frame_size_refused_from_its_header(tmp_path, w, h, word):
    """A sequence header whose frame size fields say 65536 x 65536 (16 bits
    each) is past dav1d's frame size limit, which libavif sets to 16384 x
    16384 pixels: PIL refuses it, and the port refuses it from the header,
    before it allocates a plane. A 65536 x 48 frame in an item whose ispe
    says 64 x 48 is within that limit, but libavif will not rescale a frame
    wider than 16384 (its guard against libyuv's overflows): refused from
    the header too."""
    path = str(tmp_path / "frame.avif")
    with open(path, "wb") as f:
        f.write(huge_frame_bytes(w, h))
    with pytest.raises(RuntimeError):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(tio.UnsupportedImageFormat, match=re.escape(word)):
        tio.load_image(path, "RGB")


# ------------------------------------------------------------ damage

# the fuzz's disagreements left on this sample (ROADMAP Queue 3): none
KNOWN_DISAGREEMENTS = set()


# (fixture, mutations, seed, case) of scripts/fuzz_avif.py's cases where
# the port once parted from PIL over part 3's container and streams, each
# fixed: the fault the damage hits, and what PIL does
FUZZ_FAULTS = [
    ("avif_grid-3x2.avif", 20, 4, 12),                          # iloc reserved bits: refused
    ("avif_grid-2x2-alpha-per-tile.avif", 20, 2, 24),           # alpha tile's unknown property
    ("avif_avis.avif", 20, 1, 26),                              # elst past its edts
    ("avif_avis.avif", 20, 2, 10),                              # elst entry_count
    ("avif_avis.avif", 20, 4, 25),                              # no hdlr in mdia: decodes
    ("avif_grid-2x2-alpha-per-tile.avif", 40, 14, 43),          # pixi planes' depths differ
    ("avif_grid-2x2-444-alpha-premultiplied.avif", 40, 15, 38),  # auxC version
    ("avif_grid-1x2.avif", 40, 14, 27),                         # a tile's ispe past the limits
    ("avif_grain-alpha.avif", 40, 12, 15),                      # iref box size: decodes
    ("avif_grain-67x45.avif", 40, 15, 64),                      # sequence header's trailing bit
    ("avif_avis.avif", 40, 16, 65),                             # operating_point_idc
    ("avif_avis.avif", 40, 16, 19),                             # meta items checked for tracks
    ("avif_avis.avif", 40, 15, 27),                             # no mdhd: timescale 0
    ("avif_grid-2x2-444.avif", 40, 12, 15),                     # tiles' av1C not their pixi's
    ("avif_grid-grain.avif", 40, 14, 58),                       # a tile's sequence header carried
    ("avif_premultiplied-limited-alpha.avif", 40, 15, 36),      # limited alpha, then the rescale
    ("avif_sequence-alpha.avif", 40, 14, 10),                   # a track's hdlr version
    ("avif_grid-2x2-444-alpha-premultiplied.avif", 40, 21, 30),  # frames after the tile's own
    ("avif_grain-33x17.avif", 40, 31, 79),                      # a redundant frame header
]


@pytest.mark.parametrize("name,mutations,seed,case", FUZZ_FAULTS)
def test_fuzz_fault_agrees_with_pil(name, mutations, seed, case):
    """Each damaged file the fuzz found the port parting from PIL on now
    decodes to PIL's "RGB" bytes or is refused by both."""
    data = _read(os.path.join(SMALL_DIR, name))
    damaged = fuzz_avif.cases(data, mutations, np.random.RandomState(seed))[case]
    assert damaged != data
    kind = fuzz_avif.classify(fuzz_avif.pil_rgb(damaged), fuzz_avif.port_rgb(damaged), damaged)
    assert kind in ("equal", "both refuse"), kind


def test_fuzz_sample_agrees_with_pil():
    """scripts/fuzz_avif.py, seed 0, on every sixth small fixture: each
    file cut at 10 points and damaged 4 times in its container and 4 times
    in its OBUs decodes to PIL's "RGB" bytes or is refused by both."""
    paths = [os.path.join(SMALL_DIR, n) for n in SMALL[::6]]
    counts = fuzz_avif.fuzz(paths, 4, 0, verbose=False)
    assert counts["files"] == len(paths) * 18
    assert set(counts["disagreements"]) == KNOWN_DISAGREEMENTS
    assert counts["equal"] > 0 and counts["both refuse"] > 0
