"""BMP and GIF as PIL 12.1 reads them (``BmpImagePlugin`` and the first
frame of ``GifImagePlugin``), against the JAX package and PIL.

For every variant the JAX package's ``load_image(path, mode)`` (PIL) and the
port's equal each other bit for bit in "L" and "RGB", and the port's
``image_size`` equals PIL's; where PIL refuses a file (JPEG- or
PNG-in-BMP, other header sizes, depths and bitfields layouts, RLE of
colour samples, a GIF without a frame, truncated data), the port raises
``UnsupportedImageFormat`` naming the variant. The files come from the
byte-by-byte encoders of ``scripts/format_variants.py``, which
``chip_smoke.py`` also uses for its full-size BMP and GIF pages.
"""
import os
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts.format_variants import (  # noqa: E402
    BMP_REFUSED, BMP_VARIANTS, GIF_VARIANTS, bmp_bytes, bmp_rle_bytes, gif_bytes,
    gif_refused)

CASES = ([(f"bmp-{n}", "bmp") for n in BMP_VARIANTS]
         + [(f"gif-{n}", "gif") for n in GIF_VARIANTS])


def _bytes(case):
    kind, name = case.split("-", 1)
    if kind == "bmp":
        return bmp_bytes(**BMP_VARIANTS[name](np.random.RandomState(len(name))))
    return gif_bytes(**GIF_VARIANTS[name]())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("bmp_gif")
    out = {}
    for case, ext in CASES:
        out[case] = str(root / f"{case}.{ext}")
        with open(out[case], "wb") as f:
            f.write(_bytes(case))
    return out


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_load_image_equals_jax(files, case, mode):
    jio._IMAGE_CACHE.clear()
    tio._IMAGE_CACHE.clear()
    want, got = jio.load_image(files[case], mode), tio.load_image(files[case], mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"{len(diff)} samples differ, first at {diff[0].tolist()}"


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_image_size_equals_pil(files, case):
    with Image.open(files[case]) as im:
        assert tio.image_size(files[case]) == im.size


REFUSED = ([(f"bmp-{n}", "bmp", word) for n, (_, word) in BMP_REFUSED.items()]
           + [(f"gif-{n}", "gif", word) for n, _, word in gif_refused()])


@pytest.mark.parametrize("case,ext,word", REFUSED, ids=[r[0] for r in REFUSED])
def test_refusal_equals_pil(tmp_path, case, ext, word):
    """PIL refuses the file: the port raises by name. ``image_size``
    raises where ``Image.open`` already does, and gives PIL's size where
    PIL fails only on the pixels."""
    kind, name = case.split("-", 1)
    if kind == "bmp":
        data = bmp_bytes(**BMP_REFUSED[name][0](np.random.RandomState(len(name))))
    else:
        data = dict((n, d) for n, d, _ in gif_refused())[name]
    path = str(tmp_path / f"r.{ext}")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with Image.open(path) as im:
            size = im.size
    except Exception:
        size = None
    with pytest.raises(Exception):
        jio._IMAGE_CACHE.clear()
        jio.load_image(path, "L")
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio._IMAGE_CACHE.clear()
        tio.load_image(path, "L")
    if size is None:
        with pytest.raises(tio.UnsupportedImageFormat, match=word):
            tio.image_size(path)
    else:
        assert tio.image_size(path) == size


@pytest.mark.parametrize("kind", ["bmp-rle8", "gif-interlaced"])
def test_smoke_page_writers_decode_as_written(tmp_path, kind):
    """chip_smoke.py writes its RLE8 BMP page (a grey-ramp palette, which
    PIL opens as "L") and its interlaced GIF page (a grey palette that is
    not the identity, so PIL opens "P") with these encoders (the card's
    machine has no PIL), and holds the port to the array written: PIL
    decodes each file to that array, and so does the port."""
    grey = np.random.RandomState(4).randint(0, 256, (45, 67)).astype(np.uint8)
    grey[:, 10:30] = 255                     # runs, as a page's paper has
    if kind == "bmp-rle8":
        path = str(tmp_path / "p.bmp")
        ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
        data = bmp_bytes(grey, 8, palette=ramp, compression=1, rle_body=bmp_rle_bytes(
            grey, False, seed=5))
    else:
        path = str(tmp_path / "p.gif")
        palette = np.repeat(np.arange(256)[::-1, None], 3, axis=1)   # index i is 255 - i
        data = gif_bytes(255 - grey, palette, interlace=True)
    with open(path, "wb") as f:
        f.write(data)
    with Image.open(path) as im:
        assert im.size == (67, 45)
        np.testing.assert_array_equal(np.asarray(im.convert("L")), grey)
    tio._IMAGE_CACHE.clear()
    np.testing.assert_array_equal(tio.load_image(path, "L"), grey)
