"""JPEG and TIFF pages: the port's host decoder (``csrc/image_decode.cpp``
through ``utils/io.py``) against PIL, on images PIL writes here.

``load_image(path, "L")`` and ``load_image(path, "RGB")`` equal
``np.asarray(Image.open(path).convert(mode))`` bit for bit, and
``image_size`` equals ``Image.open(path).size``. Every JPEG variant PIL
refuses raises ``UnsupportedImageFormat`` naming it; the JPEG and TIFF
variants the decoder once refused now equal PIL too (more PNM, PNG and TIFF
variants are in ``tests/test_torch_formats_variants.py``, more JPEG
variants in ``tests/test_torch_formats_jpeg_variants.py``).
"""
import io as _io
import os
import threading

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu_torch.utils import io as tio


def _page(h, w, seed, colour):
    """Text-like strokes over a smooth background, plus noise: edges and
    flat areas, as a scanned page has."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 200 + 40 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
    ink = (np.sin(xx / 3.1 + rng.rand()) > 0.6) & (np.sin(yy / 5.3) > 0.2)
    grey = np.clip(base - 150 * ink + rng.randn(h, w) * 12, 0, 255)
    if not colour:
        return grey.astype(np.uint8)
    tint = np.stack([grey, grey * 0.9 + 20 * np.sin(xx / 9.0), grey * 0.8 + 30], -1)
    return np.clip(tint + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


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


JPEG_CASES = [
    # (h, w, colour, save kwargs)
    (64, 80, False, dict(quality=75)),
    (64, 80, True, dict(quality=50, subsampling=0)),
    (64, 80, True, dict(quality=75, subsampling=1)),
    (64, 80, True, dict(quality=95, subsampling=2)),
    (1, 1, False, dict(quality=75)),
    (1, 1, True, dict(quality=75, subsampling=2)),
    (9, 17, True, dict(quality=75, subsampling=2)),
    (17, 9, True, dict(quality=90, subsampling=1)),
    (3, 2, True, dict(quality=75, subsampling=2)),
    (5, 3, True, dict(quality=75, subsampling=1)),
    (33, 47, True, dict(quality=60, subsampling=0)),
    (17, 9, False, dict(quality=95)),
    (64, 80, False, dict(quality=75, progressive=True)),
    (61, 83, True, dict(quality=85, progressive=True, subsampling=2)),
    (61, 83, True, dict(quality=50, progressive=True, subsampling=0)),
    (40, 70, True, dict(quality=75, progressive=True, subsampling=1)),
    (64, 80, False, dict(quality=75, restart_marker_blocks=3)),
    (70, 90, True, dict(quality=80, subsampling=2, restart_marker_rows=1)),
    (70, 90, True, dict(quality=80, subsampling=1, restart_marker_blocks=5)),
    (70, 90, True, dict(quality=80, progressive=True, subsampling=2,
                        restart_marker_blocks=2)),
    (64, 80, True, dict(quality=75, subsampling=2, optimize=True)),
    (2001, 1419, True, dict(quality=75, subsampling=2)),
    (2001, 1419, False, dict(quality=85, restart_marker_rows=2)),
]


@pytest.mark.parametrize("h,w,colour,kw", JPEG_CASES,
                         ids=[f"{h}x{w}-{'rgb' if c else 'l'}-" + "-".join(
                             f"{k}{v}" for k, v in kw.items())
                             for h, w, c, kw in JPEG_CASES])
def test_jpeg_equals_pil(tmp_path, h, w, colour, kw):
    p = str(tmp_path / "x.jpg")
    arr = _page(h, w, h * 7 + w, colour)
    Image.fromarray(arr).save(p, format="JPEG", **kw)
    _check_equal(p)


def test_jpeg_adobe_rgb_colour_space(tmp_path):
    """A 3-component JPEG with an Adobe APP14 marker of transform 0 holds
    RGB samples, not YCbCr (libjpeg's default_decompress_parms): the JFIF
    marker of a PIL file is swapped for such an Adobe marker, and PIL reads
    the result as RGB without the colour transform."""
    q = str(tmp_path / "adobe.jpg")
    Image.fromarray(_page(40, 56, 3, True)).save(q, format="JPEG", quality=90,
                                                 subsampling=0)
    with open(q, "rb") as f:
        data = f.read()
    assert data[2:4] == b"\xff\xe0"
    n = (data[4] << 8) | data[5]
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    with open(q, "wb") as f:
        f.write(data[:2] + adobe + data[4 + n:])
    _check_equal(q)


TIFF_CASES = [
    # (mode, h, w, save kwargs)
    ("L", 37, 53, dict()),
    ("L", 37, 53, dict(compression="packbits")),
    ("L", 37, 53, dict(compression="tiff_lzw")),
    ("L", 37, 53, dict(compression="tiff_deflate")),
    ("L", 37, 53, dict(compression="tiff_adobe_deflate")),
    ("L", 120, 97, dict(compression="tiff_lzw", predictor=2)),
    ("RGB", 120, 97, dict(compression="tiff_lzw", predictor=2)),
    ("RGB", 120, 97, dict(compression="tiff_deflate", predictor=2)),
    ("RGB", 45, 61, dict()),
    ("RGB", 45, 61, dict(compression="packbits")),
    ("L", 130, 100, dict(compression="tiff_lzw", tile=(32, 48))),
    ("RGB", 130, 100, dict(compression="tiff_deflate", tile=(64, 64))),
    ("L", 130, 100, dict(tile=(16, 16))),
    ("L", 100, 77, dict(compression="tiff_lzw", rows_per_strip=7)),
    ("RGB", 100, 77, dict(compression="packbits", rows_per_strip=9)),
    ("1", 97, 133, dict(compression="group4")),
    ("1", 301, 517, dict(compression="group4")),
    ("1", 97, 133, dict(compression="group4", rows_per_strip=10)),
    ("1", 40, 61, dict()),
    ("1", 40, 61, dict(compression="packbits")),
    ("1", 40, 61, dict(compression="tiff_lzw")),
    ("P", 50, 70, dict()),
    ("P", 50, 70, dict(compression="tiff_lzw")),
    ("RGBA", 33, 41, dict(compression="tiff_deflate")),
    ("L", 2001, 1419, dict(compression="tiff_lzw", predictor=2)),
    ("1", 2001, 1419, dict(compression="group4")),
]


def _tiff_image(mode, h, w, seed):
    if mode in ("L", "RGB"):
        return Image.fromarray(_page(h, w, seed, mode == "RGB"))
    if mode == "1":
        return Image.fromarray(_page(h, w, seed, False) < 128).convert("1")
    if mode == "P":
        return Image.fromarray(_page(h, w, seed, True)).quantize(37)
    rgba = np.concatenate([_page(h, w, seed, True),
                           np.full((h, w, 1), 200, np.uint8)], axis=-1)
    return Image.fromarray(rgba, "RGBA")


@pytest.mark.parametrize("mode,h,w,kw", TIFF_CASES,
                         ids=[f"{m}-{h}x{w}-" + "-".join(f"{k}{v}" for k, v in kw.items())
                              for m, h, w, kw in TIFF_CASES])
def test_tiff_equals_pil(tmp_path, mode, h, w, kw):
    p = str(tmp_path / "x.tif")
    _tiff_image(mode, h, w, h + w).save(p, format="TIFF", **kw)
    _check_equal(p)


BIG_ENDIAN_CASES = [c for c in TIFF_CASES if c[1] * c[2] < 100000]


@pytest.mark.parametrize("mode,h,w,kw", BIG_ENDIAN_CASES,
                         ids=[f"{m}-{h}x{w}-" + "-".join(f"{k}{v}" for k, v in kw.items())
                              for m, h, w, kw in BIG_ENDIAN_CASES])
def test_big_endian_tiff_equals_pil(tmp_path, mode, h, w, kw):
    """PIL writes 8-bit and bilevel TIFFs little-endian; the same file with
    its header and tags rewritten big-endian (the strips are byte streams
    and stay as they are) must decode as PIL reads it."""
    buf = _io.BytesIO()
    _tiff_image(mode, h, w, h + w).save(buf, format="TIFF", **kw)
    p = str(tmp_path / "x.tif")
    with open(p, "wb") as f:
        f.write(_to_big_endian(buf.getvalue()))
    _check_equal(p)


def _to_big_endian(data):
    """A little-endian TIFF rewritten big-endian: the header, the first
    IFD's entries and their out-of-line values (next IFD dropped)."""
    import struct
    assert data[:4] == b"II*\x00"
    out = bytearray(data)
    out[:8] = b"MM\x00*" + struct.pack(">I", struct.unpack("<I", data[4:8])[0])
    ifd = struct.unpack("<I", data[4:8])[0]
    (count,) = struct.unpack("<H", data[ifd:ifd + 2])
    out[ifd:ifd + 2] = struct.pack(">H", count)
    sizes = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 7: ("B", 1)}
    for i in range(count):
        e = ifd + 2 + 12 * i
        tag, typ, n = struct.unpack("<HHI", data[e:e + 8])
        fmt, size = sizes[typ]
        n_items = n * (2 if typ == 5 else 1)
        out[e:e + 8] = struct.pack(">HHI", tag, typ, n)
        inline = n_items * size <= 4
        at = e + 8 if inline else struct.unpack("<I", data[e + 8:e + 12])[0]
        if not inline:
            out[e + 8:e + 12] = struct.pack(">I", at)
        vals = struct.unpack(f"<{n_items}{fmt}", data[at:at + n_items * size])
        out[at:at + n_items * size] = struct.pack(f">{n_items}{fmt}", *vals)
    end = ifd + 2 + 12 * count
    out[end:end + 4] = b"\x00\x00\x00\x00"
    return bytes(out)


def test_tiff_min_is_white(tmp_path):
    """Photometric 0 (MinIsWhite), 8-bit and bilevel: PIL inverts both."""
    for mode in ("L", "1"):
        p = str(tmp_path / f"w_{mode}.tif")
        img = _tiff_image(mode, 31, 45, 2)
        img.save(p, format="TIFF", tiffinfo={262: 0},
                 compression="tiff_lzw" if mode == "L" else "group4")
        with Image.open(p) as im:
            assert im.tag_v2[262] == 0
        _check_equal(p)


def _cmyk_jpeg(p):
    Image.fromarray(_page(16, 16, 1, True)).convert("CMYK").save(p, format="JPEG")


def _group3_tiff(p):
    Image.fromarray(_page(16, 24, 1, False) < 128).convert("1").save(
        p, format="TIFF", compression="group3")


def _tiff16(p):
    Image.fromarray((_page(16, 24, 1, False).astype(np.uint16) * 257)).save(
        p, format="TIFF")


def _planar2(p):
    Image.fromarray(_page(16, 24, 1, True)).save(p, format="TIFF",
                                                 tiffinfo={284: 2})


def _jpeg_in_tiff(p):
    Image.fromarray(_page(16, 24, 1, True)).save(p, format="TIFF", compression="jpeg")


def _bigtiff(p):
    Image.fromarray(_page(16, 24, 1, False)).save(p, format="TIFF", big_tiff=True)


def _float_tiff(p):
    Image.fromarray(_page(16, 24, 1, False).astype(np.float32)).save(p, format="TIFF")


def _twelve_bit_jpeg(p):
    """A 12-bit frame header on an 8-bit file's data (the decoder refuses
    at the header)."""
    _cmyk_jpeg(p)
    buf = _io.BytesIO()
    Image.fromarray(_page(16, 16, 1, False)).save(buf, format="JPEG")
    data = bytearray(buf.getvalue())
    i = data.index(b"\xff\xc0")
    data[i + 4] = 12
    open(p, "wb").write(bytes(data))


def _arithmetic_jpeg(p):
    """A baseline file's Huffman-coded data under an arithmetic frame
    header: libjpeg decodes it as arithmetic-coded data, whatever comes
    out, and so does the port."""
    buf = _io.BytesIO()
    Image.fromarray(_page(16, 16, 1, False)).save(buf, format="JPEG")
    data = bytearray(buf.getvalue())
    i = data.index(b"\xff\xc0")
    data[i + 1] = 0xC9
    open(p, "wb").write(bytes(data))


def _lossless_jpeg(p):
    buf = _io.BytesIO()
    Image.fromarray(_page(16, 16, 1, False)).save(buf, format="JPEG")
    data = bytearray(buf.getvalue())
    i = data.index(b"\xff\xc0")
    data[i + 1] = 0xC3
    open(p, "wb").write(bytes(data))


def _smoothed_progressive(p):
    """A progressive JPEG whose refinement scans are cut away: its AC
    coefficients miss their low bits, which libjpeg block-smooths."""
    buf = _io.BytesIO()
    Image.fromarray(_page(32, 32, 1, False)).save(buf, format="JPEG", progressive=True)
    data = buf.getvalue()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    open(p, "wb").write(data[:sos[2]] + b"\xff\xd9")


# JPEG variants PIL refuses (more in tests/test_torch_formats_jpeg_variants.py)
UNSUPPORTED = [
    ("twelve_bit_jpeg", _twelve_bit_jpeg, "12-bit"),
    ("lossless_jpeg", _lossless_jpeg, "lossless"),
]


@pytest.mark.parametrize("kind,make,word", UNSUPPORTED, ids=[u[0] for u in UNSUPPORTED])
def test_unsupported_variants_raise_by_name(tmp_path, kind, make, word):
    """A 12-bit frame header (PIL refuses it when opening) and a lossless
    frame header over DCT scans (PIL opens it and libjpeg refuses the
    scan's predictor 0): the port raises by name, and ``image_size`` gives
    PIL's size where PIL opens the file."""
    p = str(tmp_path / f"{kind}.img")
    make(p)
    with pytest.raises(Exception):
        with Image.open(p) as im:
            im.load()
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(p, "L")
    if kind == "twelve_bit_jpeg":
        with pytest.raises(tio.UnsupportedImageFormat, match=word):
            tio.image_size(p)
    else:
        with Image.open(p) as im:
            assert tio.image_size(p) == im.size


def _fill_order_2(p):
    _tiff_image("1", 16, 24, 1).save(p, format="TIFF", tiffinfo={266: 2})


# variants the decoder once refused and now reads as PIL does
# (tests/test_torch_formats_variants.py and
# tests/test_torch_formats_jpeg_variants.py hold many more)
FORMER_REFUSALS = [
    ("cmyk_jpeg", _cmyk_jpeg),
    ("arithmetic_jpeg", _arithmetic_jpeg),
    ("smoothed_progressive_jpeg", _smoothed_progressive),
    ("group3_tiff", _group3_tiff),
    ("tiff16", _tiff16),
    ("planar2_tiff", _planar2),
    ("jpeg_in_tiff", _jpeg_in_tiff),
    ("bigtiff", _bigtiff),
    ("float_tiff", _float_tiff),
    ("fill_order_2", _fill_order_2),
]


@pytest.mark.parametrize("kind,make", FORMER_REFUSALS, ids=[f[0] for f in FORMER_REFUSALS])
def test_former_refusals_equal_pil(tmp_path, kind, make):
    p = str(tmp_path / f"{kind}.img")
    make(p)
    _check_equal(p)


def test_truncated_jpeg_raises(tmp_path):
    p = str(tmp_path / "t.jpg")
    Image.fromarray(_page(64, 64, 1, True)).save(p, format="JPEG")
    data = open(p, "rb").read()
    open(p, "wb").write(data[:len(data) // 2])
    with pytest.raises(tio.UnsupportedImageFormat, match="truncated"):
        tio.load_image(p, "L")


def test_threads_decode_side_by_side(tmp_path):
    """The pipelined driver's threads call load_image at once: every
    thread's pages equal PIL's."""
    paths = []
    for i in range(6):
        p = str(tmp_path / (f"t{i}.jpg" if i % 2 else f"t{i}.tif"))
        arr = _page(300, 220, i, True)
        if i % 2:
            Image.fromarray(arr).save(p, format="JPEG", progressive=i == 3)
        else:
            Image.fromarray(arr).save(p, format="TIFF", compression="tiff_deflate")
        paths.append(p)
    want = [np.asarray(Image.open(p).convert("L")) for p in paths]
    errors = []

    def work(k):
        for j in range(len(paths)):
            i = (j + k) % len(paths)
            from citlab_as_tpu_torch.utils import image_native
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


def test_workflow_sibling_lookup_finds_jpeg_and_tiff(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "page"))
    for name, ext in (("a", "jpg"), ("b", "tif")):
        Image.fromarray(_page(20, 30, 1, False)).save(os.path.join(root, f"{name}.{ext}"))
        open(os.path.join(root, "page", f"{name}.xml"), "w").write("<x/>")
        img = tio.get_img_from_page_path(os.path.join(root, "page", f"{name}.xml"))
        assert img.endswith(ext) and tio.load_image(img).shape == (20, 30)


def _fixture_records():
    import glob
    import json
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_formats")
    out = []
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        with open(path) as f:
            out.append((os.path.join(root, json.load(f)["file"]), path))
    return out


@pytest.mark.parametrize("image,record", _fixture_records(),
                         ids=[os.path.basename(i) for i, _ in _fixture_records()])
def test_committed_fixtures_decode_to_the_recorded_digest(image, record):
    """The full-size fixtures of chip_smoke.py's formats phase
    (scripts/make_format_fixtures.py): their recorded size and "L" digest
    are PIL's, and the port decodes to them."""
    import hashlib
    import json
    with open(record) as f:
        rec = json.load(f)
    with Image.open(image) as im:
        assert list(im.size) == rec["size"]
        pil = np.asarray(im.convert("L"))
    assert hashlib.sha256(pil.tobytes()).hexdigest() == rec["sha256_L"]
    assert list(tio.image_size(image)) == rec["size"]
    tio._IMAGE_CACHE.clear()
    got = tio.load_image(image, "L")
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == rec["sha256_L"]
    assert os.path.exists(os.path.join(os.path.dirname(image), "page",
                                       os.path.splitext(os.path.basename(image))[0] + ".xml"))
