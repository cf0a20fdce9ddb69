"""AVIF as PIL 12.1 reads it (libavif 1.3.0, dav1d 1.5.1, libyuv), against
PIL, the JAX package's ``load_image`` and dav1d itself.

Every small AVIF fixture of ``tests/data/torch_formats_variants/small/``
(``scripts/avif_variants.py``: a drawn page and a photo at every speed,
quality 0-100, 4:0:0 / 4:2:0 / 4:2:2 / 4:4:4, full and limited range,
tiles, aom's intra options one at a time, odd sizes, the colour box
relabelled, EXIF / XMP / ICC / alpha; loop restoration, CDEF, 10- and
12-bit streams, superres and the matrices libavif converts in floating
point) and the five full-size pages of ``tests/data/torch_formats_avif/``
decode through the port's ``load_image`` to exactly PIL's "L" and "RGB"
bytes (tolerance 0) and to PIL's recorded digests. The AV1 planes equal
dav1d's, 8- or 16-bit, read through the ``dav1d_*`` calls of the libavif
PIL ships (ctypes, tests only); on the identity-relabelled 4:4:4 files
PIL's "RGB" bytes are the planes themselves (G = Y, B = U, R = V). Every
route of the YUV to RGB conversion equals libavif's ``avifImageYUVToRGB``
on random planes of every depth, layout, range and matrix. Part 3's tools
and PIL's container refusals raise ``UnsupportedImageFormat`` by name,
and a seeded sample of ``scripts/fuzz_avif.py`` holds damaged files to
PIL.
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
from scripts.avif_variants import (AVIF_FAULTS, AVIF_REFUSED, AVIF_VARIANTS,  # noqa: E402
                                   huge_frame_bytes)

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
    data = _read(os.path.join(SMALL_DIR, name))
    info, _, planes = _planes(data)
    want = fuzz_avif.dav1d_planes(avif._item_data(info.meta, info.color, data))
    assert want is not None and len(want) == len(planes)
    for got, ref in zip(planes, want):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("speed,quality,subsampling,page", [
    (6, 75, "4:2:0", True), (8, 50, "4:4:4", False), (4, 90, "4:2:0", True),
    (10, 30, "4:0:0", False), (2, 60, "4:2:2", True)])
def test_full_sequence_header_key_frame_is_dav1ds(speed, quality, subsampling, page):
    """PIL's still images carry the reduced still-picture header; the first
    frame of an image sequence carries the full one (operating points,
    order hints, frame size and refresh fields, error resilience): its
    planes equal dav1d's."""
    from citlab_as_tpu_torch.utils.avif import _decode_av1
    from scripts.avif_variants import page_rgb, photo_rgb, sequence_key_frame
    arr = page_rgb(160, 96, seed=speed) if page else photo_rgb(160, 96, seed=speed)
    obus = sequence_key_frame(arr, speed=speed, quality=quality, subsampling=subsampling)
    assert (obus[2 + 2] >> 3) & 1 == 0                 # the sequence header is not reduced
    want = fuzz_avif.dav1d_planes(obus)
    _, y, u, v = _decode_av1(obus, "sequence key frame", 160, 96)
    got = [y] if u is None else [y, u, v]
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


def _libavif_yuv_to_rgb(y, u, v, depth, full, matrix, primaries, alpha):
    """libavif 1.3.0's avifImageYUVToRGB, as PIL's decoder calls it (8-bit
    RGB or RGBA, automatic chroma upsampling), on the given planes: the
    avifImage and avifRGBImage fields at libavif 1.3's offsets (depth at 8,
    yuvFormat 12, yuvRange 16, yuvPlanes 24, yuvRowBytes 48, the CICP
    triple 104; avifRGBImage depth 8, format 12, pixels 48, rowBytes 56)."""
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
        assert lib.avifImageAllocatePlanes(im, 1) == 0
        dtype = np.uint16 if depth > 8 else np.uint8
        for k, plane in enumerate((y, u, v)):
            if plane is None:
                continue
            ptr = ctypes.c_void_p.from_address(im + 24 + 8 * k).value
            row_bytes = ctypes.c_uint32.from_address(im + 48 + 4 * k).value
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
    # self-guided units), the superres denominator
    tools = {"defaults.avif": (1, 1, 0, 0, 0, 8), "speed8.avif": (0, 1, 1, 0, 0, 8),
             "scan.avif": (0, 0, 1, 0, 0, 8), "restored.avif": (0, 0, 1, 1, 1, 8),
             "superres.avif": (0, 0, 1, 0, 0, 16)}[name]
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

@pytest.mark.parametrize("name", sorted(AVIF_REFUSED))
def test_part2_tool_refused_by_name(tmp_path, name):
    """What is left to part 3 (film grain, grid, avis, premultiplied
    alpha), which PIL decodes, is refused by name; part 2's tools now
    decode (they are fixtures)."""
    make, word = AVIF_REFUSED[name]
    path = str(tmp_path / f"{name}.avif")
    with open(path, "wb") as f:
        f.write(make())
    with Image.open(path) as im:
        assert im.format == "AVIF"
        im.load()
    with pytest.raises(tio.UnsupportedImageFormat, match=re.escape(word)) as e:
        tio.load_image(path, "RGB")
    assert avif.PART3 in str(e.value) and "part 2" not in str(e.value)


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
                                      (65536, 48, "ispe says 64 x 48")])
def test_frame_size_refused_from_its_header(tmp_path, w, h, word):
    """A sequence header whose frame size fields say 65536 x 65536 (16 bits
    each) is past dav1d's frame size limit, which libavif sets to 16384 x
    16384 pixels: PIL refuses it, and the port refuses it from the header,
    before it allocates a plane. A frame of another size than the item's
    ispe is not decoded, and refused."""
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


def test_fuzz_sample_agrees_with_pil():
    """scripts/fuzz_avif.py, seed 0, on every sixth small fixture: each
    file cut at 10 points and damaged 4 times in its container and 4 times
    in its OBUs decodes to PIL's "RGB" bytes or is refused by both."""
    paths = [os.path.join(SMALL_DIR, n) for n in SMALL[::6]]
    counts = fuzz_avif.fuzz(paths, 4, 0, verbose=False)
    assert counts["files"] == len(paths) * 18
    assert set(counts["disagreements"]) == KNOWN_DISAGREEMENTS
    assert counts["equal"] > 0 and counts["both refuse"] > 0
