"""The PNM, PNG and TIFF variants PIL 12.1 decodes, against PIL.

For every variant ``load_image(path, "L")`` and ``load_image(path, "RGB")``
equal ``np.asarray(Image.open(path).convert(mode))`` bit for bit and
``image_size(path)`` equals ``Image.open(path).size``; where PIL refuses a
file, the port raises ``UnsupportedImageFormat`` naming the variant.

PIL writes few of these variants: the files come from the test encoders of
``scripts/format_variants.py`` (PNM and PNG byte by byte, TIFF through the
libtiff Pillow bundles), whose catalog ``scripts/make_format_fixtures.py``
also commits as small fixtures for ``chip_smoke.py``; the last tests hold
those fixtures and ``chip_smoke.py``'s own page writers to PIL.
"""
import io as _io
import json
import os
import struct
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu_torch.utils import image_native
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts.format_variants import (  # noqa: E402
    OLD_JPEG_VARIANTS, PNG_LAYOUTS, PNM_CASES, TIFF_REFUSED, TIFF_VARIANTS,
    TIFF_YCBCR_VARIANTS, _values, old_style_jpeg_tiff, png_bytes, pnm_bytes,
    write_tiff, write_ycbcr_units)
from scripts.format_variants import small_variants as fv_small_variants  # noqa: E402


def _check_equal(path):
    with Image.open(path) as im:
        assert tio.image_size(path) == im.size
        want = {m: np.asarray(im.convert(m)) for m in ("L", "RGB")}
    for mode in ("L", "RGB"):
        tio._IMAGE_CACHE.clear()
        got = tio.load_image(path, mode)
        assert got.shape == want[mode].shape and got.dtype == np.uint8
        diff = np.argwhere(got != want[mode])
        assert diff.size == 0, (
            f"{mode}: {len(diff)} samples differ, first at {diff[0].tolist()}")


def _check_refused(path, word):
    """PIL refuses the file: the port raises by name. ``image_size``
    raises where ``Image.open`` already does, and gives PIL's size where
    PIL fails only on decoding the pixels."""
    try:
        with Image.open(path) as im:
            size = im.size
    except Exception:
        size = None
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("L")
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(path, "L")
    if size is None:
        with pytest.raises(tio.UnsupportedImageFormat, match=word):
            tio.image_size(path)
    else:
        assert tio.image_size(path) == size


# ------------------------------------------------------------------ PNM

@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("maxval", [1, 100, 254])
@pytest.mark.parametrize("magic", [b"P5", b"P6"], ids=["P5", "P6"])
def test_pnm_maxval_scales_as_pil(tmp_path, magic, maxval, mode):
    """A binary PGM/PPM whose maxval is under 255: PIL rescales each sample
    to round(v / maxval * 255), half to even (PpmDecoder)."""
    w, h = 9, 7
    bands = 3 if magic == b"P6" else 1
    values = np.random.RandomState(maxval).randint(0, maxval + 1, w * h * bands)
    values[:2] = (0, maxval)
    p = str(tmp_path / "m.pnm")
    with open(p, "wb") as f:
        f.write(pnm_bytes(magic, w, h, maxval, values))
    with Image.open(p) as im:
        want = np.asarray(im.convert(mode))
    tio._IMAGE_CACHE.clear()
    np.testing.assert_array_equal(tio.load_image(p, mode), want)




@pytest.mark.parametrize("magic,maxval,plain", [c[1:] for c in PNM_CASES],
                         ids=[c[0] for c in PNM_CASES])
def test_pnm_variants_equal_pil(tmp_path, magic, maxval, plain):
    """ASCII grey and colour maps at any maxval, 16-bit binary maps (a grey
    one becomes PIL's mode "I", clipped by convert("L")) and P0CMYK."""
    w, h = 13, 6
    bands = {b"P2": 1, b"P5": 1, b"P3": 3, b"P6": 3, b"P0CMYK": 4}[magic]
    values = np.random.RandomState(maxval).randint(0, maxval + 1, w * h * bands)
    values[:4] = (0, maxval, maxval // 2, 255 % (maxval + 1))
    p = str(tmp_path / "v.pnm")
    with open(p, "wb") as f:
        f.write(pnm_bytes(magic, w, h, maxval, values, plain))
    _check_equal(p)


@pytest.mark.parametrize("layout", ["P1-spaced", "P1-packed", "P4-odd-width", "P4-byte-width"])
def test_pbm_equals_pil(tmp_path, layout):
    """Bilevel maps, ASCII (digits with or without whitespace, a comment
    in the data) and binary (rows padded to whole bytes); 1 is black."""
    w = 16 if layout == "P4-byte-width" else 11
    h = 5
    bits = np.random.RandomState(w).randint(0, 2, (h, w))
    if layout.startswith("P1"):
        sep = b" " if layout == "P1-spaced" else b""
        body = b"\n# a comment\n".join(sep.join(b"%d" % v for v in row) for row in bits)
        data = b"P1\n%d %d\n" % (w, h) + body + b"\n"
    else:
        data = b"P4 %d %d\n" % (w, h) + np.packbits(bits.astype(np.uint8), axis=1).tobytes()
    p = str(tmp_path / "b.pbm")
    with open(p, "wb") as f:
        f.write(data)
    _check_equal(p)


@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5], ids=["little-endian", "big-endian",
                                                         "little-endian-scale"])
def test_pfm_equals_pil(tmp_path, scale):
    """PFM (Pf): float samples, rows bottom to top; convert("L") clips and
    truncates toward zero."""
    w, h = 7, 4
    values = np.random.RandomState(3).uniform(-30, 300, (h, w)).astype(np.float32)
    values[0, :4] = (np.nan, np.inf, 254.999, 0.5)
    p = str(tmp_path / "f.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\n%d %d\n%r\n" % (w, h, scale)
                + values.astype("<f4" if scale < 0 else ">f4").tobytes())
    _check_equal(p)


@pytest.mark.parametrize("data,word", [
    (b"P2 3 1 100\n0 200 5\n", "above maxval"),
    (b"P5 3 1 0\n\x00\x01\x02", "maxval 0"),
    (b"P5 3 2 255\n\x00\x01", "truncated"),
    (b"P1 4 1\n1 0 2 1\n", "other digits"),
    (b"P3 2 1 255\n1 2 3\n", "truncated"),
    (b"P6 2 1 65536\n" + bytes(12), "maxval 65536"),
], ids=["plain-above-maxval", "maxval-0", "binary-truncated", "pbm-digit",
        "plain-truncated", "maxval-65536"])
def test_pnm_refusals_equal_pil(tmp_path, data, word):
    p = str(tmp_path / "r.pnm")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(Exception):
        with Image.open(p) as im:
            im.convert("L")
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(p, "L")


def test_pnm_test_extensions_are_refused_by_name(tmp_path):
    """PIL's "Py" magics exist "for test purposes only" (PpmImagePlugin);
    the port refuses them by name."""
    p = str(tmp_path / "py.pnm")
    with open(p, "wb") as f:
        f.write(b"PyRGBA 2 1 255\n" + bytes(range(8)))
    with pytest.raises(tio.UnsupportedImageFormat, match="PyRGBA"):
        tio.load_image(p, "L")


# ------------------------------------------------------------------ PNG



@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (9, 13), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("interlace", [True, False], ids=["adam7", "plain"])
@pytest.mark.parametrize("ctype,depth", PNG_LAYOUTS,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_LAYOUTS])
def test_png_variants_equal_pil(tmp_path, ctype, depth, interlace, shape):
    """Every colour type at every depth, interlaced or not: 16-bit grey
    is PIL's "I;16" (clipped by convert("L")), other 16-bit samples keep
    their high byte."""
    h, w = shape
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype * 100 + depth + h)
    samples = rng.randint(0, 1 << depth, (h, w, ch))
    if depth == 16:
        samples[..., 0].flat[:3] = (0, 255, 300)[:samples[..., 0].size]
    palette = rng.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(png_bytes(samples, ctype, depth, interlace, h * w, palette))
    _check_equal(p)


@pytest.mark.parametrize("ctype,trns", [
    (0, struct.pack(">H", 0x1234)), (2, struct.pack(">HHH", 0x1234, 1000, 65535)),
], ids=["grey16", "rgb16"])
def test_png16_transparency_equals_pil(tmp_path, ctype, trns):
    """A tRNS colour on a 16-bit grey or RGB image changes no pixel of
    PIL's "L" or "RGB" conversion."""
    ch = 1 if ctype == 0 else 3
    samples = np.random.RandomState(5).randint(0, 65536, (11, 17, ch))
    samples[0, 0] = 0x1234
    p = str(tmp_path / "t.png")
    with open(p, "wb") as f:
        f.write(png_bytes(samples, ctype, 16, True, 1, trns=trns))
    _check_equal(p)


def test_png16_written_by_pil_equals_pil(tmp_path):
    """PIL's own 16-bit grey PNG (its encoder's filters): values above 255
    clip to white under convert("L")."""
    values = np.random.RandomState(2).randint(0, 400, (40, 60)).astype(np.uint16)
    p = str(tmp_path / "g16.png")
    Image.fromarray(values).save(p)
    _check_equal(p)


# ------------------------------------------------------------------ TIFF

@pytest.mark.parametrize("name", list(TIFF_VARIANTS))
def test_tiff_variants_equal_pil(tmp_path, name):
    p = str(tmp_path / "v.tif")
    rng = np.random.RandomState(sum(map(ord, name)))
    write_tiff(p, **TIFF_VARIANTS[name](rng))
    _check_equal(p)


@pytest.mark.parametrize("name", list(TIFF_REFUSED))
def test_tiff_refusals_equal_pil(tmp_path, name):
    make, word = TIFF_REFUSED[name]
    p = str(tmp_path / "r.tif")
    write_tiff(p, **make(np.random.RandomState(1)))
    _check_refused(p, word)


def test_raw_planar_16_bit_is_refused_by_name(tmp_path):
    """An uncompressed planar TIFF of 16-bit samples: PIL unpacks each plane
    with one letter of its rawmode ("R" of "RGB;16L"), as 8-bit samples,
    which misreads the file; the port refuses it by name instead of copying
    the misreading."""
    p = str(tmp_path / "p16.tif")
    write_tiff(p, _values(np.random.RandomState(2), 3, 16), 16, 2, planar=2)
    with pytest.raises(tio.UnsupportedImageFormat, match="PlanarConfiguration 2"):
        tio.load_image(p, "L")


@pytest.mark.parametrize("name", list(TIFF_YCBCR_VARIANTS))
def test_ycbcr_tiff_without_jpeg_equals_pil(tmp_path, name):
    """YCbCr under LZW, Deflate or PackBits, in sampling units of every
    subsampling libtiff's RGBA interface reads (PIL goes through it):
    each unit's chroma on its pixels, libtiff's fixed-point YCbCr -> RGB."""
    p = str(tmp_path / "y.tif")
    write_ycbcr_units(p, *TIFF_YCBCR_VARIANTS[name], seed=len(name))
    _check_equal(p)


@pytest.mark.parametrize("name", list(OLD_JPEG_VARIANTS))
def test_old_style_jpeg_in_tiff_equals_pil(tmp_path, name):
    """Old-style JPEG (compression 6) behind JPEGInterchangeFormat: PIL
    reads it through libtiff's RGBA interface, so the chroma is not
    upsampled by libjpeg but spread over each sampling unit."""
    p = str(tmp_path / "o.tif")
    with open(p, "wb") as f:
        f.write(old_style_jpeg_tiff(*OLD_JPEG_VARIANTS[name], seed=len(name)))
    _check_equal(p)


def test_old_style_jpeg_without_interchange_format_is_refused_by_name(tmp_path):
    """Compression 6 without JPEGInterchangeFormat (its tables in the
    JPEGQTables / DCTables / ACTables tags) raises by name."""
    buf = _io.BytesIO()
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(buf, format="TIFF")
    data = bytearray(buf.getvalue())
    ifd = struct.unpack("<I", data[4:8])[0]
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack("<H", data[e:e + 2])[0] == 259:
            data[e + 8:e + 10] = struct.pack("<H", 6)
    p = str(tmp_path / "o.tif")
    with open(p, "wb") as f:
        f.write(bytes(data))
    _check_refused(p, "JPEGInterchangeFormat")


def test_threads_decode_new_variants_side_by_side(tmp_path):
    """The pipelined driver's threads decode Group 3, JPEG-in-TIFF,
    16-bit, float, planar and YCbCr pages at once: every thread's pages
    equal PIL's."""
    names = ["g3-2d", "jpeg-ycbcr-420-strips", "I16-lzw-predictor", "F-deflate-predictor3",
             "planar-RGB-lzw-strips", "bigtiff-g4"]
    ycbcr = str(tmp_path / "ycbcr.tif")
    write_ycbcr_units(ycbcr, *TIFF_YCBCR_VARIANTS["ycbcr-22-lzw-tiles"])
    paths = []
    for i, name in enumerate(names):
        p = str(tmp_path / f"t{i}.tif")
        write_tiff(p, **TIFF_VARIANTS[name](np.random.RandomState(i)))
        paths.append(p)
    paths.append(ycbcr)
    want = [np.asarray(Image.open(p).convert("L")) for p in paths]
    errors = []

    def work(k):
        for j in range(len(paths)):
            i = (j + k) % len(paths)
            with open(paths[i], "rb") as f:
                got = tio._to_mode(image_native.decode(f.read()), "L")
            if not np.array_equal(got, want[i]):
                errors.append(paths[i])

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


VARIANTS_DIR = os.path.join(REPO, "tests", "data", "torch_formats_variants")


def _small_records():
    with open(os.path.join(VARIANTS_DIR, "small", "small.json")) as f:
        return json.load(f)


def test_committed_small_variants_decode_to_the_recorded_digests():
    """The small fixtures of chip_smoke.py's variants phase
    (scripts/make_format_fixtures.py): one per decodable variant of the
    catalog, each file's recorded size and "L" / "RGB" digests are PIL's,
    and the port decodes to them."""
    import hashlib
    from scripts.avif_variants import avif_small_variants
    from scripts.registry_variants import registry_small_variants
    records = _small_records()
    assert len(records) == (len(fv_small_variants()) + len(registry_small_variants())
                            + len(avif_small_variants()))
    for rec in records:
        path = os.path.join(VARIANTS_DIR, "small", rec["file"])
        with Image.open(path) as im:
            assert list(im.size) == rec["size"], rec["file"]
            for mode in ("L", "RGB"):
                pil = np.asarray(im.convert(mode)).tobytes()
                assert hashlib.sha256(pil).hexdigest() == rec[f"sha256_{mode}"], rec["file"]
        assert list(tio.image_size(path)) == rec["size"], rec["file"]
        for mode in ("L", "RGB"):
            tio._IMAGE_CACHE.clear()
            got = np.ascontiguousarray(tio.load_image(path, mode)).tobytes()
            assert hashlib.sha256(got).hexdigest() == rec[f"sha256_{mode}"], rec["file"]


@pytest.mark.parametrize("name", ["group3_2d", "jpeg_ycbcr", "lzw16_predictor"])
def test_committed_full_size_variants_decode_to_the_recorded_digest(name):
    """The three full-size pages of the variants phase: PIL's recorded size
    and "L" digest, which the port's decoder reproduces, and a page XML."""
    import hashlib
    with open(os.path.join(VARIANTS_DIR, f"{name}.json")) as f:
        rec = json.load(f)
    path = os.path.join(VARIANTS_DIR, rec["file"])
    with Image.open(path) as im:
        assert list(im.size) == rec["size"]
        assert hashlib.sha256(np.asarray(im.convert("L")).tobytes()).hexdigest() == \
            rec["sha256_L"]
    assert list(tio.image_size(path)) == rec["size"]
    tio._IMAGE_CACHE.clear()
    got = np.ascontiguousarray(tio.load_image(path, "L")).tobytes()
    assert hashlib.sha256(got).hexdigest() == rec["sha256_L"]
    assert os.path.exists(os.path.join(VARIANTS_DIR, "page", f"{name}.xml"))


@pytest.mark.parametrize("kind", ["adam7", "png16", "pbm"])
def test_smoke_page_writers_decode_as_written(tmp_path, kind):
    """chip_smoke.py writes its Adam7 PNG, 16-bit PNG and PBM pages with
    these encoders (the card's machine has no PIL), and holds the port to
    the array written: PIL decodes each file to that array (under PIL's
    conversion: 16-bit values below 256 stay, 1 is black), and so does the
    port."""
    grey = np.random.RandomState(4).randint(0, 256, (45, 67)).astype(np.uint8)
    path = str(tmp_path / ("p.pbm" if kind == "pbm" else "p.png"))
    if kind == "pbm":
        data, want = pnm_bytes(b"P4", 67, 45, None, grey < 128), np.where(grey < 128, 0, 255)
    else:
        data = png_bytes(grey[..., None], 0, 8 if kind == "adam7" else 16, kind == "adam7",
                         seed=31)
        want = grey
    with open(path, "wb") as f:
        f.write(data)
    with Image.open(path) as im:
        assert im.size == (67, 45)
        assert bool(im.info.get("interlace")) == (kind == "adam7")
        np.testing.assert_array_equal(np.asarray(im.convert("L")), want)
    tio._IMAGE_CACHE.clear()
    np.testing.assert_array_equal(tio.load_image(path, "L"), want)
