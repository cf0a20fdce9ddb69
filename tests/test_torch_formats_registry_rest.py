"""The rest of PIL's registry that the port decodes, ICNS, PCD, FITS, FLI
and IPTC (``utils/registry_formats.py``), against the JAX package's
``load_image`` (PIL 12.1) with tolerance 0.

The files come from ``scripts/registry_variants.py``: the committed small
fixtures of ``tests/data/torch_formats_variants/small/`` (``small.json``
holds PIL's size and digests), PCD image packs made here from a seed (786
KB each, none committed) in each orientation, one file for each way PIL
refuses, and a seeded sample of ``scripts/fuzz_textures.py``.
"""
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import registry_variants as rv  # noqa: E402
from scripts.fuzz_textures import _too_large, damaged  # noqa: E402

SMALL = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PREFIXES = ("icns_", "fits_", "fli_", "iptc_")
with open(os.path.join(SMALL, "small.json")) as _f:
    RECORDS = {r["file"]: r for r in json.load(_f) if r["file"].startswith(PREFIXES)}


def _loads(path, mode):
    """(the JAX package's array or its exception, the port's)."""
    out = []
    for module in (jio, tio):
        module._IMAGE_CACHE.clear()
        try:
            out.append(module.load_image(path, mode))
        except Exception as e:      # noqa: BLE001 - each side's failure is compared
            out.append(e)
    return out


def _agree(path):
    for mode in ("L", "RGB"):
        want, got = _loads(path, mode)
        if isinstance(want, Exception):
            assert isinstance(got, tio.UnsupportedImageFormat), (want, got)
            return
        assert not isinstance(got, Exception), (want.shape, got)
        assert got.shape == want.shape and np.array_equal(got, want), mode


def test_every_catalogued_variant_is_a_committed_fixture():
    assert set(RECORDS) == set(rv.REGISTRY_VARIANTS)
    kinds = {name.split("_")[0] for name in RECORDS}
    assert kinds == {p.rstrip("_") for p in PREFIXES}


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", sorted(RECORDS))
def test_fixture_equals_jax(name, mode):
    want, got = _loads(os.path.join(SMALL, name), mode)
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_image_size_equals_pil(name):
    path = os.path.join(SMALL, name)
    with Image.open(path) as im:
        assert tio.image_size(path) == im.size
    assert list(im.size) == RECORDS[name]["size"]


@pytest.fixture(scope="module")
def pcd_files(tmp_path_factory):
    """A PhotoCD image pack in each orientation (the byte's two low bits),
    786 KB each, from a seed."""
    root = tmp_path_factory.mktemp("pcd")
    out = {}
    for orientation in range(4):
        path = str(root / f"o{orientation}.pcd")
        with open(path, "wb") as f:
            f.write(rv.pcd_bytes(40 + orientation, orientation))
        out[orientation] = path
    return out


@pytest.mark.parametrize("orientation", range(4))
def test_pcd_equals_jax(pcd_files, orientation):
    """The base image through Pillow's PhotoYCC tables, rotated as the
    orientation byte says."""
    _agree(pcd_files[orientation])
    want = jio.load_image(pcd_files[orientation], "RGB")
    assert want.shape == ((768, 512, 3) if orientation in (1, 3) else (512, 768, 3))


@pytest.mark.parametrize("orientation", range(4))
def test_pcd_image_size_follows_the_orientation(pcd_files, orientation):
    """``image_size`` reports PIL's size: 512 x 768 for orientations 1 and
    3 (the image is rotated), 768 x 512 otherwise."""
    with Image.open(pcd_files[orientation]) as im:
        assert tio.image_size(pcd_files[orientation]) == im.size


def test_pcd_truncated_is_refused(tmp_path):
    path = str(tmp_path / "short.pcd")
    with open(path, "wb") as f:
        f.write(rv.pcd_bytes(7, 0, short=100))
    want, got = _loads(path, "L")
    assert isinstance(want, Exception)
    assert isinstance(got, tio.UnsupportedImageFormat) and "PCD" in str(got)


REFUSED = rv.registry_refused()


@pytest.mark.parametrize("name,data,word", REFUSED, ids=[r[0] for r in REFUSED])
def test_refusals_equal_pil(tmp_path, name, data, word):
    """Each way PIL refuses an ICNS, FITS, FLI or IPTC file: the port raises
    UnsupportedImageFormat naming the format and the fault."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want, got = _loads(path, "L")
    assert isinstance(want, Exception), f"PIL decodes {name}"
    assert isinstance(got, tio.UnsupportedImageFormat), got
    assert word in str(got) and name.split("_")[0].upper() in str(got), str(got)


def test_icns_entry_size_goes_through_the_bomb_check(tmp_path):
    """An ICNS entry has a size of its own: a PNG entry's header past PIL's
    decompression-bomb limit is refused, as PIL refuses it."""
    import zlib
    png = bytearray(rv.pil_png(rv.smooth(16, 16, 1)))
    png[16:24] = (20000).to_bytes(4, "big") + (10000).to_bytes(4, "big")
    png[29:33] = zlib.crc32(bytes(png[12:29])).to_bytes(4, "big")
    path = str(tmp_path / "bomb.icns")
    with open(path, "wb") as f:
        f.write(rv.icns_bytes([(b"icp4", bytes(png))]))
    want, got = _loads(path, "L")
    assert type(want).__name__ == "DecompressionBombError"
    assert isinstance(got, tio.UnsupportedImageFormat) and "decompression bomb" in str(got)


@pytest.mark.parametrize("name", ["icns_it32_mask.icns", "icns_ic07_png.icns",
                                  "icns_il32_and_is32.icns", "fits_bitpix16.fits",
                                  "fits_gzip_zbitpix16.fits", "fli_brun.fli", "fli_ss2.flc",
                                  "fli_lc.fli", "fli_copy.flc", "iptc_grey_split.iim",
                                  "iptc_cmyk_band4.iim"])
def test_damaged_files_decode_as_pil_or_raise(tmp_path, name):
    """A seeded sample of the fuzz: cuts, and one or two changed bytes in
    the headers, the FLI chunks and the RLE and gzip data."""
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    path = str(tmp_path / name)
    for label, body in damaged(data, 3, 8, sum(map(ord, name)) + 5):
        with open(path, "wb") as f:
            f.write(body)
        if _too_large(path, 1 << 20):
            continue
        try:
            _agree(path)
        except AssertionError as e:
            raise AssertionError(f"{label}: {e}") from None
