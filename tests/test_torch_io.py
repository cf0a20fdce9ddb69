"""Image loading parity: the port decodes PNG with the standard library and
numpy; the JAX package (and this test) with PIL. ``load_image`` must equal
PIL's ``convert("L")`` / ``convert("RGB")`` exactly on every supported PNG
colour type, and refuse the formats it does not take by name (JPEG and
TIFF decoding is tested in ``tests/test_torch_formats.py``, the PNM, PNG
and TIFF variants in ``tests/test_torch_formats_variants.py``, the JPEG
variants in ``tests/test_torch_formats_jpeg_variants.py``, BMP and GIF in
``tests/test_torch_formats_bmp_gif.py``, WebP in
``tests/test_torch_formats_webp.py``, JPEG 2000 in
``tests/test_torch_formats_jpeg2000.py``)."""
import os

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio

H, W = 37, 53


def _pixels(seed, channels):
    rng = np.random.RandomState(seed)
    # smooth ramps + noise, so that PIL's encoder picks every scanline filter
    yy, xx = np.mgrid[0:H, 0:W]
    base = (yy * 3 + xx * 5)[..., None] + 40 * np.arange(channels)
    noise = rng.randint(0, 30, (H, W, channels))
    noise[H // 2:] = rng.randint(0, 256, (H - H // 2, W, channels))
    return ((base + noise) % 256).astype(np.uint8)


def _save(tmp_path, kind):
    p = str(tmp_path / f"{kind}.png")
    if kind == "grey":
        Image.fromarray(_pixels(0, 1)[..., 0], "L").save(p)
    elif kind == "grey_alpha":
        Image.fromarray(_pixels(1, 2), "LA").save(p)
    elif kind == "rgb":
        Image.fromarray(_pixels(2, 3), "RGB").save(p)
    elif kind == "rgba":
        Image.fromarray(_pixels(3, 4), "RGBA").save(p)
    elif kind == "palette":
        Image.fromarray(_pixels(4, 3), "RGB").quantize(64).save(p)
    elif kind == "palette_trns":
        im = Image.fromarray(_pixels(5, 3), "RGB").quantize(16)
        im.save(p, transparency=3)
    elif kind == "bilevel":
        Image.fromarray(_pixels(12, 1)[..., 0] > 127).save(p)
    elif kind == "grey4":
        Image.fromarray(_pixels(13, 1)[..., 0], "L").save(p, bits=4)
    elif kind == "rgb_unfiltered":
        Image.fromarray(_pixels(6, 3), "RGB").save(p, compress_level=0)
    return p


KINDS = ["grey", "grey_alpha", "rgb", "rgba", "palette", "palette_trns",
         "bilevel", "grey4", "rgb_unfiltered"]


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("kind", KINDS)
def test_load_png_equals_pil(tmp_path, kind, mode):
    p = _save(tmp_path, kind)
    got = tio.load_image(p, mode)
    ref = np.asarray(Image.open(p).convert(mode))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jio.load_image(p, mode))
    assert tio.image_size(p) == Image.open(p).size == (W, H)
    assert not got.flags.writeable


def _encode_png(arr, filters):
    """A reference PNG encoder with a chosen filter per scanline (PIL's own
    encoder never picks Average on these images)."""
    import struct
    import zlib
    h, w, ch = arr.shape
    flat = arr.reshape(h, w * ch).astype(np.int32)
    rows = bytearray()
    for y in range(h):
        cur = flat[y]
        up = flat[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        f = filters[y % len(filters)]
        if f == 4:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        else:
            pred = [0 * cur, left, up, (left + up) // 2][f]
        rows += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 1, 2, 0), (2, 1), (3, 4)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_each_scanline_filter_equals_pil(tmp_path, channels, filters):
    arr = _pixels(20 + channels, channels)
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_encode_png(arr, filters))
    ref = np.asarray(Image.open(p))
    np.testing.assert_array_equal(ref.reshape(arr.shape), arr)      # the encoder is right
    np.testing.assert_array_equal(
        tio._decode(p).reshape(arr.shape), arr)


def test_luma_formula_on_all_greys_and_extremes():
    rgb = np.zeros((4, 256, 3), np.uint8)
    rgb[0] = np.arange(256)[:, None]
    rgb[1, :, 0], rgb[2, :, 1], rgb[3, :, 2] = (np.arange(256),) * 3
    ref = np.asarray(Image.fromarray(rgb, "RGB").convert("L"))
    np.testing.assert_array_equal(tio._to_mode(rgb, "L"), ref)


def test_pnm_and_npy(tmp_path):
    grey, rgb = _pixels(7, 1)[..., 0], _pixels(8, 3)
    Image.fromarray(grey, "L").save(str(tmp_path / "a.pgm"))
    Image.fromarray(rgb, "RGB").save(str(tmp_path / "b.ppm"))
    np.save(str(tmp_path / "c.npy"), rgb)
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "a.pgm"), "L"), grey)
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "b.ppm"), "RGB"), rgb)
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "c.npy"), "RGB"), rgb)
    np.testing.assert_array_equal(
        tio.load_image(str(tmp_path / "b.ppm"), "L"),
        np.asarray(Image.fromarray(rgb, "RGB").convert("L")))
    for name in ("a.pgm", "b.ppm", "c.npy"):
        assert tio.image_size(str(tmp_path / name)) == (W, H)


def test_save_png_roundtrip_and_pil_reads_it(tmp_path):
    for arr in (_pixels(9, 1)[..., 0], _pixels(10, 3)):
        p = str(tmp_path / f"s{arr.ndim}.png")
        tio.save_png(p, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), arr)
        np.testing.assert_array_equal(
            tio.load_image(p, "L" if arr.ndim == 2 else "RGB"), arr)


@pytest.mark.parametrize("kind,word", [("riff", "RIFF, not WebP"),
                                       ("jpeg2000", "JPEG 2000: the JP2 header is malformed")])
def test_unsupported_formats_raise_by_name(tmp_path, kind, word):
    import struct
    p = str(tmp_path / f"x_{kind}.img")
    if kind == "riff":     # a RIFF file of another form than WebP: a WAVE header
        with open(p, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt " + struct.pack(
                "<IHHIIHH", 16, 1, 1, 8000, 8000, 1, 8) + b"data" + struct.pack("<I", 0))
    else:
        # PIL's own JP2 file with its jp2h box holding no ihdr box: PIL
        # refuses the malformed header
        Image.fromarray(_pixels(11, 1)[..., 0], "L").save(p, format="JPEG2000")
        with open(p, "rb") as f:
            data = f.read()
        at = data.index(b"jp2h") - 4
        end = at + struct.unpack_from(">I", data, at)[0]
        ihdr = data.index(b"ihdr") - 4
        data = (data[:at] + struct.pack(">I", end - at - 22) + data[at + 4:ihdr]
                + data[ihdr + 22:])
        with open(p, "wb") as f:
            f.write(data)
        with pytest.raises(Exception):
            Image.open(p).load()
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(p, "L")
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.image_size(p)


@pytest.mark.parametrize("kind", ["group3_tiff", "interlaced", "png16", "cmyk_jpeg", "bmp",
                                  "webp", "jpeg2000"])
def test_former_refusals_equal_pil(tmp_path, kind):
    """Variants the port once refused by name, now decoded as PIL decodes
    them: a Group 3 TIFF, an Adam7 PNG, a 16-bit grey PNG, a CMYK JPEG, a
    BMP, PIL's own lossy WebP and PIL's own JP2 file."""
    grey = _pixels(11, 1)[..., 0]
    p = str(tmp_path / f"x_{kind}.img")
    if kind == "webp":
        Image.fromarray(grey, "L").save(p, format="WEBP")
    elif kind == "jpeg2000":
        Image.fromarray(grey, "L").save(p, format="JPEG2000")
    elif kind == "cmyk_jpeg":
        Image.fromarray(grey, "L").convert("CMYK").save(p, format="JPEG")
    elif kind == "bmp":
        Image.fromarray(grey, "L").save(p, format="BMP")
    elif kind == "group3_tiff":
        Image.fromarray(grey, "L").convert("1").save(p, format="TIFF", compression="group3")
    elif kind == "png16":
        Image.fromarray(grey.astype(np.uint16) * 257).save(p, format="PNG")
    else:
        # PIL cannot write Adam7: the scanlines of the seven passes, each
        # with filter 0, behind a header whose interlace byte is 1
        import struct
        import zlib
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2))
        raw = b"".join(b"\x00" + row.tobytes() for x0, y0, dx, dy in passes
                       for row in grey[y0::dy, x0::dx] if row.size)

        def chunk(name, body):
            return (struct.pack(">I", len(body)) + name + body
                    + struct.pack(">I", zlib.crc32(name + body)))
        with open(p, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 1))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with Image.open(p) as im:
        assert tio.image_size(p) == im.size
        want = {m: np.asarray(im.convert(m)) for m in ("L", "RGB")}
    for mode in ("L", "RGB"):
        tio._IMAGE_CACHE.clear()
        np.testing.assert_array_equal(tio.load_image(p, mode), want[mode])


def test_cache_is_keyed_by_mtime_and_bounded(tmp_path):
    p = str(tmp_path / "c.png")
    tio.save_png(p, np.zeros((4, 4), np.uint8))
    a = tio.load_image(p)
    assert tio.load_image(p) is a
    tio.save_png(p, np.full((4, 4), 9, np.uint8))
    os.utime(p, (1, 1))
    assert tio.load_image(p)[0, 0] == 9
    for i in range(tio._IMAGE_CACHE_MAX + 3):
        q = str(tmp_path / f"k{i}.png")
        tio.save_png(q, np.zeros((2, 2), np.uint8))
        tio.load_image(q)
    assert len(tio._IMAGE_CACHE) <= tio._IMAGE_CACHE_MAX


def test_path_helpers_equal(tmp_path):
    (tmp_path / "page").mkdir()
    (tmp_path / "a.png").write_bytes(b"")
    (tmp_path / "page" / "a.xml").write_text("x")
    img = str(tmp_path / "a.png")
    for fn, arg in (("get_page_path", img), ("get_page_from_img_path", img),
                    ("get_img_from_page_path", str(tmp_path / "page" / "a.xml")),
                    ("prepend_folder_name", img)):
        assert getattr(tio, fn)(arg) == getattr(jio, fn)(arg)
    assert tio.get_page_path(img, append_extension=True) == jio.get_page_path(img, append_extension=True)
    lst = tmp_path / "l.lst"
    lst.write_text("a.png \nb.png\n")
    assert tio.load_list_file(str(lst)) == jio.load_list_file(str(lst)) == ["a.png", "b.png"]
    assert tio.load_text_file(str(lst)) == jio.load_text_file(str(lst))


def _registry_file(kind, path):
    """A small file of a format in PIL's registry, as PIL writes it or byte
    by byte: PIL identifies each."""
    import struct
    grey = Image.fromarray(_pixels(7, 1)[..., 0], "L")
    if kind in ("AVIF", "BLP", "DDS", "ICNS", "EPS"):
        mode = {"AVIF": "RGB", "DDS": "RGB", "ICNS": "RGB", "BLP": "P"}.get(kind, "L")
        grey.convert(mode).save(path, format=kind)
        return
    data = {
        "BUFR": b"BUFR" + bytes(60),
        "GRIB": b"GRIB\0\0\0\x01" + bytes(60),
        "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(60),
        "MPEG": b"\x00\x00\x01\xb3\x01\x00\x10" + bytes(60),
        "PCD": bytes(2048) + b"PCD_" + bytes(1540),
        "FITS": b"".join(c.ljust(80).encode() for c in (
            "SIMPLE  =                    T", "BITPIX  =                    8",
            "NAXIS   =                    2", "NAXIS1  =                    4",
            "NAXIS2  =                    3", "END")).ljust(2880) + bytes(12),
        "FTEX": b"FTEX" + struct.pack("<7i", 1, 4, 4, 1, 1, 1, 32) + struct.pack("<i", 48)
        + bytes(48),
        "IPTC": (b"\x1c\x03\x3c\x00\x02\x01\x00" + b"\x1c\x03\x14\x00\x01\x04"
                 + b"\x1c\x03\x1e\x00\x01\x03" + b"\x1c\x03\x78\x00\x01\x01"
                 + b"\x1c\x08\x0a\x00\x0c" + bytes(12)),
        "WMF": (b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<hhhhH", 0, 0, 100, 50, 1440)
                + bytes(6) + b"\x01\x00\x09\x00" + bytes(60)),
        "FLI": (struct.pack("<IHHHHHHI", 128 + 16, 0xAF11, 1, 4, 3, 8, 0, 5) + bytes(108)
                + struct.pack("<IHH", 16, 0xF1FA, 0) + bytes(8)),
    }[kind]
    with open(path, "wb") as f:
        f.write(data)


# the formats the port refused by name until it decoded them (None), and
# the ones it still refuses, with the start of the reason it names
NOT_DECODED = {"AVIF": None, "BLP": None, "DDS": None, "FTEX": None, "ICNS": None,
               "PCD": None, "FITS": None, "FLI": None, "IPTC": None,
               "EPS": "EPS (PIL needs Ghostscript)", "WMF": "WMF (PIL draws it only",
               "MPEG": "MPEG (PIL identifies", "BUFR": "BUFR (PIL's stub",
               "GRIB": "GRIB (PIL's stub", "HDF5": "HDF5 (PIL's stub"}


@pytest.mark.parametrize("kind", sorted(NOT_DECODED))
def test_registry_formats_not_decoded_are_named(tmp_path, kind):
    """Every format of PIL's registry that PIL identifies and the port does
    not decode is refused by its name and why, never as "unknown"; the ones
    the port now decodes give PIL's pixels, or are refused where PIL
    refuses the file."""
    path = str(tmp_path / f"x.{kind.lower()}")
    _registry_file(kind, path)
    with Image.open(path) as im:
        assert im.format == kind
    if NOT_DECODED[kind] is None:
        for mode in ("L", "RGB"):
            jio._IMAGE_CACHE.clear()
            tio._IMAGE_CACHE.clear()
            try:
                want = jio.load_image(path, mode)
            except Exception:       # noqa: BLE001 - PIL refuses: so must the port
                with pytest.raises(tio.UnsupportedImageFormat, match=kind):
                    tio.load_image(path, mode)
                continue
            np.testing.assert_array_equal(tio.load_image(path, mode), want)
        with Image.open(path) as im:
            assert tio.image_size(path) == im.size
        return
    import re
    word = re.escape(NOT_DECODED[kind])
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(path, "L")
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.image_size(path)
