"""The TIFF sample layouts at the edges of PIL 12.1's ``OPEN_INFO`` and the
JPEG-in-TIFF and planar layouts, against the JAX package's ``load_image``
(PIL 12.1) with tolerance 0, in files libtiff writes
(``scripts/format_variants.py``'s TIFF writer):

- a palette index with an extra sample (PIL's "PA" and "P" read with
  rawmode "PX"), 12-bit grey ("I;16" from rawmode "I;12");
- JPEG-in-TIFF with extra samples ("LA", "RGBA", "RGBX", "RGBa") and with
  separate planes (grey, RGB, RGBA, and YCbCr, which PIL reads through
  libtiff's RGBA interface), separate YCbCr planes under LZW, Deflate and
  PackBits;
- the layouts PIL refuses, refused by name (and CIELAB, whose "RGB" PIL
  gets only from LittleCMS: a divergence ROADMAP.md records as decided);
- the full-size pages of ``chip_smoke.py``'s variants phase in these
  layouts, held to PIL's recorded digests;
- YCbCr under libtiff's RGBA interface with YCbCrCoefficients and
  ReferenceBlackWhite of their own, in every type libtiff reads them as.
"""
import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts.format_variants import (  # noqa: E402
    TIFF_LAYOUT_REFUSED, TIFF_LAYOUT_VARIANTS, write_tiff)

SMALL = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
MAIN = os.path.join(REPO, "tests", "data", "torch_formats_main")


def _write(tmp_path, catalog, name):
    p = str(tmp_path / f"{name}.tif")
    make = catalog[name]
    make = make[0] if isinstance(make, tuple) else make
    write_tiff(p, **make(np.random.RandomState(sum(map(ord, name)))))
    return p


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", sorted(TIFF_LAYOUT_VARIANTS))
def test_layout_equals_jax(tmp_path, name, mode):
    p = _write(tmp_path, TIFF_LAYOUT_VARIANTS, name)
    jio._IMAGE_CACHE.clear()
    tio._IMAGE_CACHE.clear()
    want, got = jio.load_image(p, mode), tio.load_image(p, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"{len(diff)} samples differ, first at {diff[0].tolist()}"


@pytest.mark.parametrize("name", sorted(TIFF_LAYOUT_VARIANTS))
def test_layout_size_and_mode_are_pils(tmp_path, name):
    p = _write(tmp_path, TIFF_LAYOUT_VARIANTS, name)
    with Image.open(p) as im:
        assert tio.image_size(p) == im.size
        assert im.mode in ("PA", "P", "I;16", "LA", "RGBA", "RGB", "L"), im.mode


@pytest.mark.parametrize("name", sorted(TIFF_LAYOUT_REFUSED))
def test_refused_layout_raises_by_name(tmp_path, name):
    """PIL refuses each (LAB in "L" only), the port raises by name in both
    modes; the size is PIL's where PIL's open succeeds."""
    p = _write(tmp_path, TIFF_LAYOUT_REFUSED, name)
    word = TIFF_LAYOUT_REFUSED[name][1]
    with pytest.raises(Exception):
        jio.load_image(p, "L")
    for mode in ("L", "RGB"):
        tio._IMAGE_CACHE.clear()
        with pytest.raises(tio.UnsupportedImageFormat, match=word):
            tio.load_image(p, mode)
    try:
        with Image.open(p) as im:
            size = im.size
    except Exception:       # noqa: BLE001 - PIL's open refuses it too
        with pytest.raises(tio.UnsupportedImageFormat):
            tio.image_size(p)
    else:
        assert tio.image_size(p) == size


def test_lab_is_a_recorded_divergence(tmp_path):
    """PIL converts CIELAB to "RGB" through LittleCMS (ImageCms), which the
    port does not carry; its refusal says the divergence is decided."""
    p = _write(tmp_path, TIFF_LAYOUT_REFUSED, "LAB")
    jio._IMAGE_CACHE.clear()
    assert jio.load_image(p, "RGB").shape == (37, 53, 3)
    with pytest.raises(tio.UnsupportedImageFormat, match="decided divergence"):
        tio.load_image(p, "RGB")


def test_every_catalogued_layout_is_a_committed_fixture():
    with open(os.path.join(SMALL, "small.json")) as f:
        files = {r["file"] for r in json.load(f)}
    assert {f"tiff_layout-{name}.tif" for name in TIFF_LAYOUT_VARIANTS} <= files


@pytest.mark.parametrize("name", ["damaged", "jpeg_rgba", "ycbcr_planar_lzw", "palette_alpha"])
def test_committed_full_size_page_decodes_to_pils_digests(name):
    """The full-size pages of the variants phase: a JPEG PIL decodes through
    libjpeg-turbo's recovery, an RGBA JPEG-in-TIFF, separate YCbCr planes
    under LZW and a "PA" page; PIL's size and "L" / "RGB" digests."""
    with open(os.path.join(MAIN, f"{name}.json")) as f:
        rec = json.load(f)
    path = os.path.join(MAIN, rec["file"])
    assert list(tio.image_size(path)) == rec["size"] == [1420, 2000]
    for mode in ("L", "RGB"):
        tio._IMAGE_CACHE.clear()
        got = np.ascontiguousarray(tio.load_image(path, mode)).tobytes()
        assert hashlib.sha256(got).hexdigest() == rec[f"sha256_{mode}"], mode
    assert os.path.isfile(os.path.join(MAIN, "page", f"{name}.xml"))


def _with_tags(data, extra):
    """A classic little-endian TIFF whose first IFD is written again at the
    end of the file with the entries of ``extra`` ({tag: (type, count,
    value bytes)}) added or replacing the file's."""
    ifd = struct.unpack_from("<I", data, 4)[0]
    entries = {}
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        tag, typ, cnt = struct.unpack_from("<HHI", data, at)
        entries[tag] = (typ, cnt, data[at + 8:at + 12])
    out = bytearray(data)
    for tag, (typ, cnt, raw) in extra.items():
        if len(raw) > 4:
            out += b"\0" * (len(out) % 2)
            raw, out = struct.pack("<I", len(out)), out + raw
        entries[tag] = (typ, cnt, raw.ljust(4, b"\0"))
    out += b"\0" * (len(out) % 2)
    struct.pack_into("<I", out, 4, len(out))
    out += struct.pack("<H", len(entries))
    for tag in sorted(entries):
        typ, cnt, raw = entries[tag]
        out += struct.pack("<HHI", tag, typ, cnt) + raw
    return bytes(out + struct.pack("<I", 0))


def _rationals(values, den=1000000, signed=False):
    return (10 if signed else 5, len(values),
            b"".join(struct.pack("<ii" if signed else "<II", int(round(v * den)), den)
                     for v in values))


# YCbCrCoefficients (529) and ReferenceBlackWhite (532) of their own
YCC_TAGS = {
    "refbw-video-range": {532: _rationals([16, 235, 128, 240, 128, 240])},
    "refbw-fractions": {532: _rationals([3.3, 200.7, 50.1, 180.9, 90.25, 150.5], 7)},
    "refbw-empty-range": {532: _rationals([10, 10, 128, 128, 0, 255])},
    "refbw-srational": {532: _rationals([-20, 300, 100, 255, 128, 200], 1, signed=True)},
    "refbw-five-values": {532: _rationals([16, 235, 128, 240, 128])},
    "luma-bt709": {529: _rationals([0.2126, 0.7152, 0.0722])},
    "luma-fractions": {529: _rationals([0.333, 0.5, 0.4], 999983)},
    "luma-shorts": {529: (3, 3, struct.pack("<3H", 1, 2, 1))},
    "luma-floats": {529: (11, 3, struct.pack("<3f", 0.25, 0.6, 0.15))},
    "luma-doubles": {529: (12, 3, struct.pack("<3d", 0.25, 0.6, 0.15))},
    "luma-green-zero": {529: _rationals([0.3, 0, 0.1])},
    "both-bt709-video": {529: _rationals([0.2126, 0.7152, 0.0722]),
                         532: _rationals([16, 235, 128, 240, 128, 240])},
}


@pytest.mark.parametrize("tags", sorted(YCC_TAGS))
@pytest.mark.parametrize("name", ["tiff_ycbcr-22-lzw-tiles.tif", "tiff_layout-ycbcr-planar-lzw.tif",
                                  "tiff_layout-jpeg-planar-ycbcr.tif", "tiff_ojpeg-420.tif",
                                  "tiff_jpeg-ycbcr-420-strips.tif"])
def test_ycbcr_coefficients_and_reference_black_white_equal_pil(tmp_path, name, tags):
    """libtiff's RGBA interface converts YCbCr with the file's coefficients
    and reference black and white (TIFFYCbCrToRGBInit), and refuses a green
    coefficient of 0; libjpeg's conversion of contiguous JPEG-in-TIFF uses
    neither."""
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    p = str(tmp_path / "y.tif")
    with open(p, "wb") as f:
        f.write(_with_tags(data, YCC_TAGS[tags]))
    for mode in ("L", "RGB"):
        jio._IMAGE_CACHE.clear()
        tio._IMAGE_CACHE.clear()
        try:
            want = jio.load_image(p, mode)
        except OSError:
            with pytest.raises(tio.UnsupportedImageFormat, match="YCbCrCoefficients"):
                tio.load_image(p, mode)
            return
        np.testing.assert_array_equal(tio.load_image(p, mode), want)
