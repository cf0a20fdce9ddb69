"""JPEG 2000 as PIL 12.1 reads it (OpenJPEG 2.5.4 tile by tile, unpacked by
Pillow), against the JAX package and PIL.

Every small JPEG 2000 fixture of ``tests/data/torch_formats_variants/small/``
(raw J2K, JP2 and JPX; 5/3 and 9/7 at 0 to the most levels, RCT and ICT,
odd sizes and offsets, tiles and tile-parts, every progression order and
POC, layers by rate and by quality, code-blocks from 4 x 4 to 1024 x 4 and
every code-block style, precincts, SOP / EPH, PPM / PPT / PLT / PLM / TLM,
RGN; "L", "LA", "RGB", "RGBA", "CMYK", "I;16", "P" and "PA"; 1- to 16-bit,
signed and subsampled components, sYCC; the JP2 boxes PIL skips; written by
``scripts/format_variants.py``'s test encoders) and the three full-size
pages of ``tests/data/torch_formats_jpeg2000/`` decode through the port's
``load_image`` to exactly the bytes of the JAX package's (PIL's) in "L" and
"RGB", tolerance 0, and to PIL's recorded digests; ``image_size`` equals
PIL's size. Truncated and damaged files decode to PIL's pixels or raise
``UnsupportedImageFormat`` where PIL raises, and hand-made faults PIL
refuses are refused by name.
"""
import glob
import hashlib
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
from scripts.format_variants import (  # noqa: E402
    JPEG2000_VARIANTS, j2k_build, j2k_parse, jpeg2000_refused)
from scripts.fuzz_jpeg2000 import damaged  # noqa: E402

SMALL_DIR = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PAGES_DIR = os.path.join(REPO, "tests", "data", "torch_formats_jpeg2000")
SMALL = sorted(os.path.basename(p) for p in glob.glob(os.path.join(SMALL_DIR, "jpeg2000_*")))
PAGES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(PAGES_DIR, "*.jp2")))
# the fixtures cut and damaged at random (seeded): every kind of container,
# progression, code-block style and packed header among them
DAMAGED = ["jpeg2000_rgb-33x47-ict.j2k", "jpeg2000_style-all.j2k", "jpeg2000_ppm.j2k",
           "jpeg2000_ppt.j2k", "jpeg2000_order-rpcl.j2k", "jpeg2000_pclr-pa.jp2",
           "jpeg2000_tile-parts-interleaved.j2k", "jpeg2000_sop-eph-97.j2k",
           "jpeg2000_sycc-420-odd.jp2", "jpeg2000_boxes-skipped.jp2"]
MUTATIONS = 24


def _records():
    with open(os.path.join(SMALL_DIR, "small.json")) as f:
        return {r["file"]: r for r in json.load(f)}


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_small_fixtures_are_the_catalogue():
    assert SMALL == sorted(f"jpeg2000_{name}.{ending}"
                           for name, (ending, _) in JPEG2000_VARIANTS.items())
    modes = set()
    for name in SMALL:
        with Image.open(os.path.join(SMALL_DIR, name)) as im:
            modes.add(im.mode)
    assert {"L", "LA", "RGB", "RGBA", "CMYK", "I;16", "P", "PA"} <= modes
    assert {n.rsplit(".", 1)[1] for n in SMALL} == {"j2k", "jp2", "jpx"}


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", SMALL)
def test_small_fixture_equals_jax(name, mode):
    path = os.path.join(SMALL_DIR, name)
    jio._IMAGE_CACHE.clear()
    tio._IMAGE_CACHE.clear()
    want, got = jio.load_image(path, mode), tio.load_image(path, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"{len(diff)} samples differ, first at {diff[0].tolist()}"
    assert _digest(got) == _records()[name][f"sha256_{mode}"]


@pytest.mark.parametrize("name", SMALL)
def test_image_size_is_pils(name):
    path = os.path.join(SMALL_DIR, name)
    with Image.open(path) as im:
        assert tio.image_size(path) == im.size


@pytest.mark.parametrize("name", PAGES)
def test_full_size_page_equals_pil(name):
    path = os.path.join(PAGES_DIR, name)
    with open(os.path.join(PAGES_DIR, name.replace(".jp2", ".json"))) as f:
        rec = json.load(f)
    assert tio.image_size(path) == tuple(rec["size"]) == (1420, 2000)
    for mode in ("L", "RGB"):
        jio._IMAGE_CACHE.clear()
        tio._IMAGE_CACHE.clear()
        got = tio.load_image(path, mode)
        np.testing.assert_array_equal(got, jio.load_image(path, mode))
        assert _digest(got) == rec[f"sha256_{mode}"]


def _pil_outcome(path):
    """PIL's "RGB" image of the file, or None where PIL raises."""
    try:
        jio._IMAGE_CACHE.clear()
        return jio.load_image(path, "RGB")
    except Exception:
        return None


def _held_to_pil(path):
    want = _pil_outcome(path)
    tio._IMAGE_CACHE.clear()
    if want is None:
        with pytest.raises(tio.UnsupportedImageFormat):
            tio.load_image(path, "RGB")
        return "refused"
    np.testing.assert_array_equal(tio.load_image(path, "RGB"), want)
    return "equal"


@pytest.mark.parametrize("name", DAMAGED)
def test_damaged_files_decode_as_pil_or_raise(tmp_path, name):
    """The file cut at 16 points and with 1-3 bytes overwritten at seeded
    random places (half in the headers): each decodes to PIL's pixels or is
    refused where PIL refuses it, and the process survives every one."""
    data = _read(os.path.join(SMALL_DIR, name))
    rng = np.random.RandomState(sum(map(ord, name)))
    outcomes = {"equal": 0, "refused": 0}
    for i, case in enumerate(damaged(data, rng, MUTATIONS)):
        path = str(tmp_path / f"{i}.{name.rsplit('.', 1)[1]}")
        with open(path, "wb") as f:
            f.write(case)
        outcomes[_held_to_pil(path)] += 1
    assert outcomes["refused"] >= 16, outcomes     # PIL refuses every truncated file


FAULTS = jpeg2000_refused(_read(os.path.join(SMALL_DIR, "jpeg2000_grey-17x3.j2k")),
                          _read(os.path.join(SMALL_DIR, "jpeg2000_jpx-brand.jpx")))


@pytest.mark.parametrize("name,data,word", FAULTS, ids=[f[0] for f in FAULTS])
def test_fault_refused_by_name_as_pil_refuses(tmp_path, name, data, word):
    path = str(tmp_path / "f.jp2")
    with open(path, "wb") as f:
        f.write(data)
    assert _pil_outcome(path) is None
    tio._IMAGE_CACHE.clear()
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(path, "L")


def test_high_throughput_code_blocks_refused_by_name(tmp_path):
    """No file with high-throughput (Part 15) code-blocks can be written
    here, so the port refuses them by name rather than decode them without
    an oracle."""
    main, parts, tail = j2k_parse(_read(os.path.join(SMALL_DIR, "jpeg2000_grey-17x3.j2k")))
    main = [(c, b[:8] + bytes([b[8] | 0x40]) + b[9:] if c == 0xff52 else b) for c, b in main]
    path = str(tmp_path / "ht.j2k")
    with open(path, "wb") as f:
        f.write(j2k_build(main, parts, tail))
    with pytest.raises(tio.UnsupportedImageFormat, match="high-throughput"):
        tio.load_image(path, "L")


def test_no_jpeg2000_in_the_page_lookup():
    """The reference's page -> image lookup takes tif, jpg and png only:
    a JPEG 2000 page is reached through an image list, as in the JAX
    package."""
    assert tio._IMG_ENDINGS == jio._IMG_ENDINGS == ("tif", "jpg", "png")


def test_unpacker_reading_past_openjpegs_samples_reads_pillows_zeros(tmp_path):
    """A POC entry whose first component is out of range ends that
    progression early (OpenJPEG's packet iterator), so the top resolutions
    of two components stay undecoded and OpenJPEG hands Pillow smaller
    planes than its unpacker reads: Pillow reads the rest of its tile
    buffer, which it zeroes before every tile, and the port reads the
    same zeros."""
    main, parts, tail = j2k_parse(_read(os.path.join(SMALL_DIR, "jpeg2000_poc-three-orders.j2k")))
    isot, tp, tn, markers, data = parts[0]
    poc = next(b for c, b in markers if c == 0xff5f)
    bad = poc[:15] + bytes([7]) + poc[16:]      # the third POC's CSpoc: 7 of 3 components
    markers = [(c, bad if c == 0xff5f else b) for c, b in markers]
    path = str(tmp_path / "poc.j2k")
    with open(path, "wb") as f:
        f.write(j2k_build(main, [(isot, tp, tn, markers, data)] + parts[1:], tail))
    assert _held_to_pil(path) == "equal"
