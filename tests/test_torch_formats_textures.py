"""The block-texture formats of PIL's registry (DDS, BLP, FTEX) and the
BC1-BC7 block decoder under them (``csrc/bcn_decode.cpp``), against the JAX
package's ``load_image`` (PIL 12.1) with tolerance 0.

The files come from ``scripts/registry_variants.py``: the committed small
fixtures of ``tests/data/torch_formats_variants/small/`` (``small.json``
holds PIL's size and digests; byte by byte from seeds, or by PIL's DDS and
BLP writers), one file for each way PIL refuses, the block decoder against
PIL's own BcnDecode.c on random blocks of every kind and mode, and a
seeded sample of ``scripts/fuzz_textures.py``.
"""
import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio
from citlab_as_tpu_torch.utils import textures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import registry_variants as rv  # noqa: E402
from scripts.fuzz_textures import _too_large, damaged  # noqa: E402

SMALL = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PREFIXES = ("dds_", "blp_", "ftex_")
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
    """The port gives PIL's pixels where PIL decodes and raises
    UnsupportedImageFormat where PIL raises."""
    for mode in ("L", "RGB"):
        want, got = _loads(path, mode)
        if isinstance(want, Exception):
            assert isinstance(got, tio.UnsupportedImageFormat), (want, got)
            return
        assert not isinstance(got, Exception), (want.shape, got)
        assert got.shape == want.shape and np.array_equal(got, want), mode


def test_every_catalogued_variant_is_a_committed_fixture():
    assert set(RECORDS) == set(rv.TEXTURE_VARIANTS)
    for name, make in rv.TEXTURE_VARIANTS.items():
        if "_pil_" in name:
            continue        # PIL's writers: the committed bytes are the oracle's input
        with open(os.path.join(SMALL, name), "rb") as f:
            assert f.read() == make(name), name


def test_every_bc_kind_and_mode_is_covered():
    names = set(RECORDS)
    for m in range(14):
        assert f"dds_bc6h_uf16_mode{m}.dds" in names and f"dds_bc6h_sf16_mode{m}.dds" in names
    assert all(f"dds_bc7_mode{m}.dds" in names for m in range(8))
    for kind in ("dxt1", "dxt3", "dxt5", "bc4u", "ati1", "bc5u", "ati2", "bc5s"):
        assert f"dds_fourcc_{kind}_13x9.dds" in names     # an edge past whole blocks


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


REFUSED = rv.texture_refused()


@pytest.mark.parametrize("name,data,word", REFUSED, ids=[r[0] for r in REFUSED])
def test_refusals_equal_pil(tmp_path, name, data, word):
    """Each way PIL refuses a DDS, BLP or FTEX file: the port raises
    UnsupportedImageFormat naming the format and the fault."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want, got = _loads(path, "L")
    assert isinstance(want, Exception), f"PIL decodes {name}"
    assert isinstance(got, tio.UnsupportedImageFormat), got
    assert word in str(got) and name.split("_")[0].upper() in str(got), str(got)


# BcnDecode.c through PIL's own "bcn" decoder: (kind, PIL's pixel format,
# PIL's mode, signed)
BCN_KINDS = [(1, "DXT1", "RGBA", False), (2, "DXT3", "RGBA", False),
             (3, "DXT5", "RGBA", False), (4, "BC4", "L", False), (5, "BC5", "RGB", False),
             (5, "BC5S", "RGB", True), (6, "BC6H", "RGB", False), (6, "BC6HS", "RGB", True),
             (7, "BC7", "RGBA", False)]


@pytest.mark.parametrize("kind,fmt,mode,sign", BCN_KINDS, ids=[k[1] for k in BCN_KINDS])
def test_block_decoder_equals_pil_on_random_blocks(kind, fmt, mode, sign):
    """Random bytes are valid blocks: 4,096 blocks of each kind (BC6H and
    BC7 in every mode, a few hundred blocks each) through PIL's BcnDecode.c
    and the port's, at a size that is not a multiple of 4."""
    w, h = 253, 255
    modes = range(14) if kind == 6 else range(8) if kind == 7 else [None]
    for m in modes:
        data = rv.bc_blocks(kind, w, h, 100 + kind + (m or 0), m)
        want = np.asarray(Image.frombytes(mode, (w, h), data, "bcn", (kind, fmt)))
        got = textures.bcn("DDS", data, kind, sign, w, h)
        if mode == "RGB":
            got = got[..., :3]
        assert np.array_equal(got, want), (fmt, m)


@pytest.mark.parametrize("name", ["dds_fourcc_dxt5_13x9.dds", "dds_bc7_mode4.dds",
                                  "dds_bc6h_sf16_mode11.dds", "dds_rgb_565.dds",
                                  "dds_palette.dds", "blp_blp2_dxt_ae7_ad8_13x9.blp",
                                  "blp_blp1_jpeg_rgb.blp", "blp_pil_blp2_alpha.blp",
                                  "ftex_bc1_13x9.ftc"])
def test_damaged_textures_decode_as_pil_or_raise(tmp_path, name):
    """A seeded sample of the fuzz: cuts, and one or two changed bytes in
    the headers and in the blocks."""
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    path = str(tmp_path / name)
    for label, body in damaged(data, 3, 8, sum(map(ord, name)) + 3):
        with open(path, "wb") as f:
            f.write(body)
        if _too_large(path, 1 << 20):
            continue
        try:
            _agree(path)
        except AssertionError as e:
            raise AssertionError(f"{label}: {e}") from None


def test_registry_formats_leave_not_decoded():
    """DDS, BLP and FTEX (and AVIF) are decoded: only the six formats PIL
    cannot decode either are refused by name."""
    assert set(tio._NOT_DECODED) == {"EPS", "WMF", "MPEG", "BUFR", "GRIB", "HDF5"}
    from citlab_as_tpu_torch.utils import raster_formats
    assert {"DDS", "BLP", "FTEX"} <= set(raster_formats.FORMATS)


def test_blp1_jpeg_is_read_as_bgr():
    """PIL reads the RGB of a BLP1 JPEG stream as BGR: the port's pixels
    are the JPEG's with red and blue swapped."""
    px = rv.smooth(9, 13, 1)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", quality=95)
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        rgb = np.asarray(im.convert("RGB"))
    with Image.open(io.BytesIO(rv.blp1_jpeg_bytes(buf.getvalue(), 13, 9))) as im:
        assert np.array_equal(np.asarray(im.convert("RGB")), rgb[..., ::-1])
