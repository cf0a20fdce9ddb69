"""The main path's page formats (JPEG, TIFF, PNG, PNM, BMP, GIF) under damage
and past PIL's decompression-bomb limit, against the JAX package's
``load_image`` (PIL 12.1) with tolerance 0.

- PIL's decompression-bomb limit: a header of 20000 x 10000 pixels in each
  format is refused by ``load_image`` and ``image_size`` alike;
- a seeded sample of ``scripts/fuzz_main_formats.py`` over the committed
  small fixtures of each format (cuts, bytes anywhere, and for JPEG and PNG
  bytes inside the entropy-coded data): the port gives PIL's pixels where
  PIL decodes and raises ``UnsupportedImageFormat`` where PIL raises;
- four Huffman-coded JPEG pages (grey, 4:2:0, progressive, restart
  markers) with bytes of their entropy-coded data changed, which PIL
  decodes through libjpeg-turbo's recovery;
- the committed damaged fixtures, and a corrupt zlib stream, which raises
  by name and not as ``zlib.error``.
"""
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts.format_variants import (  # noqa: E402
    DAMAGED_VARIANTS, jpeg2000_refused, webp_refused)
from scripts.fuzz_main_formats import DECIDED, FORMATS, damaged  # noqa: E402

SMALL = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
with open(os.path.join(SMALL, "small.json")) as _f:
    RECORDS = {r["file"]: r for r in json.load(_f)}


def _loads(path):
    """(the JAX package's {"L", "RGB"} arrays or its exception, the port's)."""
    out = []
    for module in (jio, tio):
        got = {}
        for mode in ("L", "RGB"):
            module._IMAGE_CACHE.clear()
            try:
                got[mode] = module.load_image(path, mode)
            except Exception as e:      # noqa: BLE001 - each side's failure is compared
                got = e
                break
        out.append(got)
    return out


def _agree(path):
    """The port decodes to PIL's pixels or raises UnsupportedImageFormat
    where PIL raises (or names a divergence ROADMAP.md records as decided)."""
    want, got = _loads(path)
    if isinstance(got, Exception):
        assert isinstance(got, tio.UnsupportedImageFormat), repr(got)
        assert isinstance(want, Exception) or DECIDED in str(got), (
            f"PIL decodes, the port raises {got!r}")
        return "refused"
    assert not isinstance(want, Exception), f"PIL raises {want!r}, the port decodes"
    for mode in want:
        assert got[mode].shape == want[mode].shape, mode
        diff = np.argwhere(got[mode] != want[mode])
        assert diff.size == 0, f"{mode}: {len(diff)} samples differ, first at {diff[0].tolist()}"
    return "decoded"


# ------------------------------------------------------------------ bomb

W, H = 20000, 10000           # 2e8 pixels: past 2 * Image.MAX_IMAGE_PIXELS


def _png_chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _bomb_png():
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(b"\0" * 64)) + _png_chunk(b"IEND", b""))


def _bomb_pnm():
    return f"P5\n{W} {H}\n255\n".encode() + b"\0" * 64


def _bomb_jpeg():
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, H, W, 1) + b"\x01\x11\x00"
    sos = b"\xff\xda" + struct.pack(">HB", 8, 1) + b"\x01\x00\x00\x3f\x00"
    return b"\xff\xd8" + sof + sos + b"\0" * 64 + b"\xff\xd9"


def _bomb_tiff():
    tags = [(256, 4, W), (257, 4, H), (258, 3, 8), (259, 3, 1), (262, 3, 1), (273, 4, 8),
            (277, 3, 1), (278, 4, H), (279, 4, W * H)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", tag, kind, 1, value) for tag, kind, value in tags) + b"\0" * 4
    return b"II*\0" + struct.pack("<I", 72) + b"\0" * 64 + ifd


def _bomb_bmp():
    return (b"BM" + struct.pack("<IHHI", 54, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, W, H, 1, 24, 0, 0, 0, 0, 0, 0))


def _bomb_gif():
    return (b"GIF89a" + struct.pack("<HHBBB", W, H, 0, 0, 0) + b","
            + struct.pack("<HHHHB", 0, 0, W, H, 0) + b"\x08\x02\x00\x01\x00;")


BOMBS = {"PNG": _bomb_png, "PNM": _bomb_pnm, "JPEG": _bomb_jpeg, "TIFF": _bomb_tiff,
         "BMP": _bomb_bmp, "GIF": _bomb_gif}


@pytest.mark.parametrize("entry", ["load_image", "image_size"])
@pytest.mark.parametrize("fmt", sorted(BOMBS))
def test_decompression_bomb_is_refused(tmp_path, fmt, entry):
    """PIL's open raises DecompressionBombError past 178,956,970 pixels;
    the port's one check on the header's size refuses the page in both
    entry points, before a buffer is allocated."""
    p = str(tmp_path / f"bomb.{fmt.lower()}")
    with open(p, "wb") as f:
        f.write(BOMBS[fmt]())
    with pytest.raises(Image.DecompressionBombError):
        Image.open(p)
    with pytest.raises(Image.DecompressionBombError):
        jio.load_image(p, "L")
    call = (lambda: tio.load_image(p, "L")) if entry == "load_image" else (
        lambda: tio.image_size(p))
    with pytest.raises(tio.UnsupportedImageFormat, match="decompression-bomb limit"):
        call()


@pytest.mark.parametrize("kind", ["webp", "jpeg2000"])
def test_decompression_bomb_of_webp_and_jpeg2000_through_the_same_check(tmp_path, kind):
    """The WebP and JPEG 2000 decoders no longer check the limit
    themselves: the one check in utils/io.py refuses their bombs too."""
    def read(name):
        with open(os.path.join(SMALL, name), "rb") as f:
            return f.read()
    if kind == "webp":
        faults = webp_refused(read("webp_vp8-33x47.webp"), read("webp_vp8l-method-0.webp"))
        name = "canvas-past-pils-pixel-limit"
    else:
        faults = jpeg2000_refused(read("jpeg2000_grey-17x3.j2k"), read("jpeg2000_jpx-brand.jpx"))
        name = "decompression-bomb"
    data = {f[0]: f[1] for f in faults}[name]
    p = str(tmp_path / f"bomb.{kind}")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(Exception):
        jio.load_image(p, "L")
    with pytest.raises(tio.UnsupportedImageFormat, match="decompression-bomb limit"):
        tio.load_image(p, "L")
    with pytest.raises(tio.UnsupportedImageFormat, match="decompression-bomb limit"):
        tio.image_size(p)


# ------------------------------------------------------------------ fuzz sample

def _sample(prefix, count):
    names = sorted(n for n in RECORDS if n.startswith(prefix) and "damaged" not in n)
    step = max(1, len(names) // count)
    return names[::step][:count]


SAMPLE = ([n for p in ("jpeg_", "tiff_", "png_") for n in _sample(p, 6)]
          + [n for p in ("pnm_", "bmp_", "gif_") for n in _sample(p, 3)])


@pytest.mark.parametrize("name", SAMPLE)
def test_damaged_files_decode_as_pil_or_raise(tmp_path, name):
    """A seeded sample of the fuzz: cuts, bytes anywhere and, for JPEG and
    PNG, bytes inside the entropy-coded data."""
    fmt = FORMATS[name.split("_")[0] + "_"]
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    p = str(tmp_path / ("d" + os.path.splitext(name)[1]))
    for label, body in damaged(data, fmt, 3, 4, 6 if fmt in ("JPEG", "PNG") else 0,
                               sum(map(ord, name)) + 16):
        with open(p, "wb") as f:
            f.write(body)
        try:
            _agree(p)
        except AssertionError as e:
            raise AssertionError(f"{label}: {e}") from None


# the damaged TIFF files where PIL's IFD reader and libtiff's directory
# reader part ways, as the fuzz found them at seeds 0-14: (seed, fixture,
# label of the damaged copy). A Photometric, SamplesPerPixel,
# PlanarConfiguration, StripByteCounts or TileOffsets of a bad count, type
# or value, a duplicate ImageWidth, StripOffsets of count 0, a T4Options
# PIL cannot read as a number, a BigTIFF header libtiff refuses; libtiff's
# old-style JPEG stream (wider than the image, without its length or its
# interchange format: the strips' bytes), its RGBA interface over separate
# YCbCr JPEG planes (a plane it fails on keeps the strip before), the
# CCITT decoders' error taken for success in tiles, PIL's own checks of
# libtiff's strips and tiles, a scan naming one component twice, a
# ReferenceBlackWhite of the file's own.
DIRECTORY_CASES = [
    (0, "tiff_damaged-ycbcr-lzw.tif", "bytes 2"),
    (1, "tiff_g3-1d-fillbits-fillorder2.tif", "bytes 14"),
    (1, "tiff_g3-1d.tif", "bytes 23"),
    (1, "tiff_ojpeg-420-odd.tif", "bytes 17"),
    (1, "tiff_planar-CMYK-raw.tif", "bytes 17"),
    (1, "tiff_ycbcr-21-deflate.tif", "bytes 11"),
    (2, "tiff_bigtiff-RGB16-deflate-predictor.tif", "bytes 2"),
    (2, "tiff_bigtiff-g4.tif", "bytes 23"),
    (2, "tiff_layout-jpeg-planar-ycbcr.tif", "bytes 2"),
    (3, "tiff_g3-2d-tiles.tif", "bytes 23"),
    (3, "tiff_jpeg-ycbcr-422-tiles.tif", "bytes 2"),
    (3, "tiff_ojpeg-420.tif", "bytes 23"),
    (3, "tiff_ojpeg-444.tif", "bytes 5"),
    (4, "tiff_bigtiff-RGB16-deflate-predictor.tif", "bytes 9"),
    (4, "tiff_layout-jpeg-planar-ycbcr.tif", "bytes 2"),
    (4, "tiff_layout-jpeg-planar-ycbcr.tif", "bytes 23"),
    (5, "tiff_jpeg-cmyk-tiles.tif", "bytes 9"),
    (7, "tiff_bigtiff-RGB16-deflate-predictor.tif", "bytes 20"),
    (7, "tiff_g3-2d-tiles.tif", "bytes 17"),
    (8, "tiff_ojpeg-422.tif", "bytes 20"),
    (8, "tiff_ojpeg-444.tif", "bytes 8"),
    (9, "tiff_g3-2d-tiles.tif", "bytes 2"),
    (10, "tiff_bigtiff-L.tif", "bytes 15"),
    (10, "tiff_g3-2d.tif", "bytes 2"),
    (11, "tiff_layout-ycbcr-planar-deflate.tif", "bytes 2"),
    (11, "tiff_layout-jpeg-planar-ycbcr.tif", "bytes 23"),
    (12, "tiff_g3-2d-fillbits.tif", "bytes 5"),
    (14, "tiff_P4-raw.tif", "bytes 2"),
]


@pytest.mark.parametrize("seed,name,label", DIRECTORY_CASES,
                         ids=[f"{s}-{n}-{lab.replace(' ', '')}" for s, n, lab in DIRECTORY_CASES])
def test_tiff_directory_read_as_libtiff_reads_it(tmp_path, seed, name, label):
    """PIL opens the page from its own IFD reader and decodes it through
    libtiff, which reads the directory again by its own rules
    (``csrc/image_decode.cpp::Tiff::libtiff_view``); each file the fuzz
    found the two readers part ways on decodes or is refused as PIL does."""
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    body = dict(damaged(data, "TIFF", 12, 24, 24, seed + sum(map(ord, name))))[label]
    p = str(tmp_path / "d.tif")
    with open(p, "wb") as f:
        f.write(body)
    _agree(p)


# plain PNM files the fuzz found at seeds 3 and 4: a negative sample, and a
# negative width PIL's open rejects
PNM_CASES = [(3, "pnm_P3-255.pnm", "bytes 3"), (4, "pnm_P3-7.pnm", "bytes 18")]


@pytest.mark.parametrize("seed,name,label", PNM_CASES,
                         ids=[f"{s}-{n}-{lab.replace(' ', '')}" for s, n, lab in PNM_CASES])
def test_damaged_plain_pnm_refused_as_pil_refuses(tmp_path, seed, name, label):
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    body = dict(damaged(data, "PNM", 12, 24, 24, seed + sum(map(ord, name))))[label]
    p = str(tmp_path / "d.pnm")
    with open(p, "wb") as f:
        f.write(body)
    assert _agree(p) == "refused"


# the GIF the fuzz found at seed 8: its image descriptor's width set to 0.
# PIL's decoder.setimage (decode.c) takes a tile whose x0 and x1 are both 0
# for the whole image, so PIL decodes the frame over the whole screen
GIF_CASES = [(8, "gif_no-palette.gif", "bytes 9")]


@pytest.mark.parametrize("seed,name,label", GIF_CASES,
                         ids=[f"{s}-{n}-{lab.replace(' ', '')}" for s, n, lab in GIF_CASES])
def test_gif_frame_of_width_0_decodes_as_pil(tmp_path, seed, name, label):
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    body = dict(damaged(data, "GIF", 12, 24, 24, seed + sum(map(ord, name))))[label]
    p = str(tmp_path / "d.gif")
    with open(p, "wb") as f:
        f.write(body)
    assert _agree(p) == "decoded"


@pytest.mark.parametrize("extent,outcome", [
    ((0, 0, 0, None), "decoded"), ((0, 5, 0, 0), "decoded"), ((0, 0, 0, 0), "decoded"),
    ((0, 3, 0, None), "refused"), ((2, 0, 0, None), "refused"), ((0, 0, None, 0), "refused")])
def test_gif_frame_of_width_or_height_0(tmp_path, extent, outcome):
    """The first frame's (x0, y0, width, height) with a width or height of
    0 (None keeps the file's): x0 and width both 0 decode the whole screen,
    whatever y0 and the height (y0 grows the screen, and its frame then
    runs out of data); any other width or height of 0 is refused, as PIL
    refuses a tile of no pixels."""
    with open(os.path.join(SMALL, "gif_no-palette.gif"), "rb") as f:
        data = bytearray(f.read())
    old = struct.unpack_from("<HHHH", data, 14)
    struct.pack_into("<HHHH", data, 14, *(o if e is None else e for e, o in zip(extent, old)))
    p = str(tmp_path / "d.gif")
    with open(p, "wb") as f:
        f.write(bytes(data))
    assert _agree(p) == outcome


@pytest.mark.parametrize("tile", [0, 2, 3])
def test_ccitt_tile_that_ends_early_keeps_the_tile_before(tmp_path, tile):
    """TIFFReadEncodedTile takes the CCITT decoders' error for success: a
    tile whose data ends in its first row leaves the rest of PIL's tile
    buffer as the tile before left it, which the port gives; in the first
    tile that is memory the file never wrote (a decided divergence)."""
    with open(os.path.join(SMALL, "tiff_g3-2d-tiles.tif"), "rb") as f:
        data = bytearray(f.read())
    struct.pack_into("<I", data, 858 + 4 * tile, 3)     # TileByteCounts[tile] = 3
    p = str(tmp_path / "t.tif")
    with open(p, "wb") as f:
        f.write(bytes(data))
    if tile == 0:
        with pytest.raises(tio.UnsupportedImageFormat, match=DECIDED):
            tio.load_image(p, "L")
        return
    assert _agree(p) == "decoded"


@pytest.mark.parametrize("base", ["grey", "420", "progressive", "restarts"])
def test_entropy_damaged_jpeg_decodes_as_libjpeg_recovers(tmp_path, base):
    """Huffman-coded pages with one or two bytes of their entropy-coded data
    changed: PIL decodes nearly all of them through libjpeg-turbo's recovery
    (a bad code decodes as 0, a run past coefficient 63, a marker met in
    the data, its 16-bit SIMD inverse DCT), and the port gives its pixels."""
    name = f"jpeg_huffman-{base}.jpg"
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    p = str(tmp_path / "d.jpg")
    outcomes = []
    for label, body in damaged(data, "JPEG", 0, 0, 15, 7):
        with open(p, "wb") as f:
            f.write(body)
        try:
            outcomes.append(_agree(p))
        except AssertionError as e:
            raise AssertionError(f"{label}: {e}") from None
    assert outcomes.count("decoded") >= 12, outcomes


@pytest.mark.parametrize("name", sorted(DAMAGED_VARIANTS) + ["png_damaged-adler-unchecked.png"])
def test_committed_damaged_fixture_equals_pil(name):
    """The damaged small fixtures (chip_smoke.py checks them on the card's
    host against these digests): PIL decodes each, the port to its pixels."""
    path = os.path.join(SMALL, name)
    assert _agree(path) == "decoded"
    if name in DAMAGED_VARIANTS:
        base, _ = DAMAGED_VARIANTS[name]
        assert RECORDS[name]["sha256_L"] != RECORDS[base]["sha256_L"], "no pixel changed"


def test_corrupt_zlib_stream_raises_by_name(tmp_path):
    """A PNG whose zlib stream is corrupt inside its first row: PIL raises
    (broken data stream), the port raises UnsupportedImageFormat naming the
    fault, not a bare zlib.error."""
    rows = np.zeros((4, 9), np.uint8).tobytes()
    z = bytearray(zlib.compress(rows))
    z[2] = 0xFF                                         # an invalid block type
    data = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 4, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", bytes(z)) + _png_chunk(b"IEND", b""))
    p = str(tmp_path / "z.png")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(OSError):
        jio.load_image(p, "L")
    with pytest.raises(tio.UnsupportedImageFormat, match="broken PNG data stream"):
        tio.load_image(p, "L")


def test_png_stream_ending_on_a_row_keeps_the_rows_before(tmp_path):
    """inflate reaching the end of the zlib stream in the call that
    completed a row ends PIL's image there: the rows below stay zero."""
    rows = np.full((6, 1 + 5), 200, np.uint8)
    rows[:, 0] = 0
    data = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows[:4].tobytes())) + _png_chunk(b"IEND", b""))
    p = str(tmp_path / "short.png")
    with open(p, "wb") as f:
        f.write(data)
    assert _agree(p) == "decoded"
    got = tio.load_image(p, "L")
    assert (got[:4] == 200).all() and (got[4:] == 0).all()
