"""The lossless raster formats of PIL's registry (PCX, DCX, PSD, TGA, ICO,
CUR, DIB, SGI, SUN, QOI, MSP, IM, XBM, XPM, PIXAR, SPIDER, GBR, IMT,
MCIDAS, XVTHUMB) and PIL's identification of a file, against the JAX
package's ``load_image`` (PIL 12.1) with tolerance 0.

The files come from the byte-by-byte encoders of
``scripts/format_variants.py`` (no PIL): the committed small fixtures of
``tests/data/torch_formats_variants/small/`` (``small.json`` holds PIL's
size and digests), the full-size pages ``chip_smoke.py`` writes, one file
for each way PIL refuses, files that more than one plugin's test lets in,
and a seeded sample of damaged files.
"""
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
    RASTER_VARIANTS, raster_identified, raster_pages, raster_refused)

SMALL = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PREFIXES = ("pcx_", "dcx_", "psd_", "tga_", "ico_", "cur_", "dib_", "sgi_", "sun_", "qoi_",
            "msp_", "im_", "xbm_", "xpm_", "pixar_", "spider_", "gbr_", "imt_", "mcidas_",
            "xvthumb")
with open(os.path.join(SMALL, "small.json")) as _f:
    RECORDS = {r["file"]: r for r in json.load(_f) if r["file"].startswith(PREFIXES)}


def _loads(path, mode):
    """(the JAX package's array or its exception, the port's array or its
    exception), caches cleared."""
    out = []
    for module in (jio, tio):
        module._IMAGE_CACHE.clear()
        try:
            out.append(module.load_image(path, mode))
        except Exception as e:      # noqa: BLE001 - each side's failure is compared
            out.append(e)
    return out


def _assert_same(want, got):
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"{len(diff)} samples differ, first at {diff[0].tolist()}"


def test_every_catalogued_variant_is_a_committed_fixture():
    assert set(RECORDS) == set(RASTER_VARIANTS)
    kinds = {name.split("_")[0].split(".")[0] for name in RECORDS}
    assert kinds == {p.rstrip("_") for p in PREFIXES}


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", sorted(RECORDS))
def test_fixture_equals_jax(name, mode):
    want, got = _loads(os.path.join(SMALL, name), mode)
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    _assert_same(want, got)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_image_size_equals_pil(name):
    path = os.path.join(SMALL, name)
    with Image.open(path) as im:
        assert tio.image_size(path) == im.size
    assert list(im.size) == RECORDS[name]["size"]


def _page(seed, h=2000, w=1420):
    """A seeded grey page: paper, strokes of ink and grey, scattered 0x80
    bytes (the SUN escape value)."""
    rng = np.random.RandomState(seed)
    page = np.full((h, w), 255, np.uint8)
    ys, xs = rng.randint(0, h, 20000), rng.randint(0, w - 24, 20000)
    lens, vals = rng.randint(1, 24, 20000), rng.randint(0, 256, 20000)
    for y, x, n, v in zip(ys, xs, lens, vals):
        page[y, x:x + n] = v
    page[rng.rand(h, w) < 0.01] = 0x80
    return page


@pytest.fixture(scope="module")
def full_pages(tmp_path_factory):
    root = tmp_path_factory.mktemp("raster_pages")
    out = {}
    for name, data, want in raster_pages([_page(s) for s in (1, 2, 3)]):
        path = str(root / name)
        with open(path, "wb") as f:
            f.write(data)
        out[name] = (path, want)
    return out


@pytest.mark.parametrize("name", ["pcx_grey_rle.pcx", "dcx_bilevel.dcx", "tga_grey_rle.tga",
                                  "psd_grey_packbits.psd", "sgi_grey_rle.sgi",
                                  "sun_grey_rle.sun", "qoi_grey_as_rgb.qoi"])
def test_full_size_page_equals_jax_and_the_array_written(full_pages, name):
    """The pages chip_smoke.py writes with the same encoders: PIL and the
    port decode each to the array it was written from (all lossless)."""
    path, written = full_pages[name]
    for mode in ("L", "RGB"):
        want, got = _loads(path, mode)
        _assert_same(want, got)
    np.testing.assert_array_equal(got[..., 0], written)
    with Image.open(path) as im:
        assert tio.image_size(path) == im.size == (1420, 2000)


REFUSED = raster_refused()


@pytest.mark.parametrize("name,data,word", REFUSED, ids=[r[0] for r in REFUSED])
def test_refusal_equals_pil(tmp_path, name, data, word):
    """PIL refuses the file: the port raises UnsupportedImageFormat naming
    the format and the reason. ``image_size`` raises where ``Image.open``
    does, and gives PIL's size where PIL fails only on the pixels."""
    path = str(tmp_path / f"{name}.img")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with Image.open(path) as im:
            size = im.size
    except Exception:           # noqa: BLE001
        size = None
    want, got = _loads(path, "L")
    assert isinstance(want, Exception), "PIL decodes the file"
    assert isinstance(got, tio.UnsupportedImageFormat) and word in str(got), got
    if size is None:
        with pytest.raises(tio.UnsupportedImageFormat):
            tio.image_size(path)
    else:
        assert tio.image_size(path) == size


IDENTIFIED = raster_identified()


@pytest.mark.parametrize("name,data,expect", IDENTIFIED, ids=[r[0] for r in IDENTIFIED])
def test_identification_follows_pil(tmp_path, name, data, expect):
    """Files more than one plugin's test lets in: PIL's order and the
    exceptions it catches decide, and the port ends where PIL ends."""
    fmt, word = expect
    path = str(tmp_path / f"{name}.img")
    with open(path, "wb") as f:
        f.write(data)
    if fmt is None:
        with pytest.raises(Exception):
            Image.open(path).load()
        want, got = _loads(path, "L")
        assert isinstance(want, Exception)
        assert isinstance(got, tio.UnsupportedImageFormat) and word in str(got), got
        return
    with Image.open(path) as im:
        assert im.format == fmt
        assert tio.image_size(path) == im.size
    for mode in ("L", "RGB"):
        want, got = _loads(path, mode)
        _assert_same(want, got)


def _damaged(data, rng):
    """Three cuts and three single-byte mutations of the first 64 bytes."""
    out = [data[:int(len(data) * f)] for f in (0.3, 0.6, 0.95)]
    for _ in range(3):
        at = int(rng.randint(0, min(64, len(data))))
        out.append(data[:at] + bytes([int(rng.randint(0, 256))]) + data[at + 1:])
    return out


@pytest.mark.parametrize("prefix", PREFIXES)
def test_damaged_files_decode_as_pil_or_raise(tmp_path, prefix):
    """Each fixture cut short and with header bytes changed (seeded): where
    PIL still decodes, the port gives its pixels; where PIL raises, the
    port raises UnsupportedImageFormat; nothing else escapes."""
    rng = np.random.RandomState(sum(map(ord, prefix)))
    checked = decoded = 0
    for name in sorted(n for n in RECORDS if n.startswith(prefix)):
        with open(os.path.join(SMALL, name), "rb") as f:
            data = f.read()
        for k, bad in enumerate(_damaged(data, rng)):
            path = str(tmp_path / f"{k}_{name}")
            with open(path, "wb") as f:
                f.write(bad)
            want, got = _loads(path, "L")
            checked += 1
            if isinstance(want, Exception):
                assert isinstance(got, tio.UnsupportedImageFormat), (name, k, got)
            else:
                decoded += 1
                assert not isinstance(got, Exception), (name, k, got)
                _assert_same(want, got)
    assert checked >= 6 and decoded >= 1


def test_dib_header_sizes_and_rle_parity(tmp_path):
    """A DIB's RLE8 samples after a 40-byte header: PIL's reader pads an
    absolute run to an even file position, counted from the DIB's start."""
    from scripts.format_variants import bmp_bytes, bmp_rle_bytes
    idx = np.random.RandomState(3).randint(0, 5, (9, 13)).astype(np.uint8)
    pal = np.random.RandomState(4).randint(0, 256, (256, 3))
    data = bmp_bytes(idx, 8, palette=pal, compression=1,
                     rle_body=bmp_rle_bytes(idx, False, seed=2))[14:]
    path = str(tmp_path / "rle8.dib")
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 40) + data[4:])
    for mode in ("L", "RGB"):
        want, got = _loads(path, mode)
        _assert_same(want, got)
