"""WebP as PIL 12.1 reads it (libwebp 1.6.0's ``WebPAnimDecoder``), against
the JAX package and PIL.

Every small WebP fixture of ``tests/data/torch_formats_variants/small/``
(lossy VP8 at every loop filter, partition and segment setting, ALPH alpha
raw and VP8L-compressed under each filter method, lossless VP8L with
palettes and transforms, the VP8X and animated containers; written by
``scripts/format_variants.py``'s test encoders) and the three full-size
pages of ``tests/data/torch_formats_webp/`` decode through the port's
``load_image`` to exactly the bytes of the JAX package's (PIL's) in "L" and
"RGB", tolerance 0, and to PIL's recorded digests; ``image_size`` equals
PIL's size, and the decoder's own image is PIL's in mode and alpha.
Truncated files and hand-made header faults raise
``UnsupportedImageFormat`` where PIL raises.
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
from citlab_as_tpu_torch.utils import webp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts.format_variants import WEBP_VARIANTS, webp_refused  # noqa: E402

SMALL_DIR = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PAGES_DIR = os.path.join(REPO, "tests", "data", "torch_formats_webp")
SMALL = sorted(os.path.basename(p) for p in glob.glob(os.path.join(SMALL_DIR, "webp_*.webp")))
PAGES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(PAGES_DIR, "*.webp")))
# the files cut at 32 points each (a truncated file: the RIFF chunk runs
# past its end, which PIL's demuxer refuses)
TRUNCATED = ["webp_vp8-partitions-8.webp", "webp_alph-vp8l-filter3.webp",
             "webp_vp8l-palette-4.webp", "webp_anim-offset-alpha.webp"]
CUTS = 32


def _records():
    with open(os.path.join(SMALL_DIR, "small.json")) as f:
        return {r["file"]: r for r in json.load(f)}


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_small_fixtures_are_the_catalogue():
    assert SMALL == sorted(f"webp_{name}.webp" for name in WEBP_VARIANTS)
    kinds = {name.split("-")[0] for name in WEBP_VARIANTS}
    assert {"vp8", "alph", "vp8l", "vp8x", "anim"} <= kinds


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
def test_decoded_image_is_pils_in_mode_and_alpha(name):
    """PIL's "RGBA" or "RGB" (alpha included, where PIL keeps it) and its
    size."""
    path = os.path.join(SMALL_DIR, name)
    with Image.open(path) as im:
        size, mode, want = im.size, im.mode, np.asarray(im)
    assert tio.image_size(path) == size
    got = webp.decode(_read(path))
    assert got.shape[2] == len(mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PAGES)
def test_full_size_page_equals_pil(name):
    path = os.path.join(PAGES_DIR, name)
    with open(os.path.join(PAGES_DIR, name.replace(".webp", ".json"))) as f:
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


@pytest.mark.parametrize("cut", range(CUTS))
@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_file_refused_where_pil_refuses(tmp_path, name, cut):
    data = _read(os.path.join(SMALL_DIR, name))
    n = int(np.linspace(1, len(data) - 1, CUTS).astype(int)[cut])
    path = str(tmp_path / "t.webp")
    with open(path, "wb") as f:
        f.write(data[:n])
    want = _pil_outcome(path)
    tio._IMAGE_CACHE.clear()
    if want is None:
        with pytest.raises(tio.UnsupportedImageFormat):
            tio.load_image(path, "RGB")
    else:
        np.testing.assert_array_equal(tio.load_image(path, "RGB"), want)


FAULTS = webp_refused(_read(os.path.join(SMALL_DIR, "webp_vp8-33x47.webp")),
                      _read(os.path.join(SMALL_DIR, "webp_vp8l-method-0.webp")))


@pytest.mark.parametrize("name,data,word", FAULTS, ids=[f[0] for f in FAULTS])
def test_header_fault_refused_by_name_as_pil_refuses(tmp_path, name, data, word):
    path = str(tmp_path / "f.webp")
    with open(path, "wb") as f:
        f.write(data)
    assert _pil_outcome(path) is None
    with pytest.raises(Exception):
        Image.open(path).load()
    tio._IMAGE_CACHE.clear()
    with pytest.raises(tio.UnsupportedImageFormat, match=word):
        tio.load_image(path, "L")
    with pytest.raises(tio.UnsupportedImageFormat):
        tio.image_size(path)


def test_damaged_bitstreams_decode_as_pil_or_raise(tmp_path):
    """Bytes overwritten at random inside the frames (the headers intact):
    libwebp decodes many such files to some image, which the port must then
    equal, its 16-bit inverse DCT wrapping included; the rest both refuse."""
    rng = np.random.RandomState(5)
    outcomes = {"equal": 0, "refused": 0}
    for name in ("webp_vp8-partitions-4.webp", "webp_vp8l-method-6.webp",
                 "webp_alph-vp8l-filter2.webp"):
        data = _read(os.path.join(SMALL_DIR, name))
        for i in range(40):
            b = bytearray(data)
            for pos in rng.randint(40, len(b), rng.randint(1, 4)):
                b[pos] = rng.randint(0, 256)
            path = str(tmp_path / f"{i}.webp")
            with open(path, "wb") as f:
                f.write(bytes(b))
            want = _pil_outcome(path)
            tio._IMAGE_CACHE.clear()
            if want is None:
                with pytest.raises(tio.UnsupportedImageFormat):
                    tio.load_image(path, "RGB")
                outcomes["refused"] += 1
            else:
                np.testing.assert_array_equal(tio.load_image(path, "RGB"), want)
                outcomes["equal"] += 1
    assert outcomes["equal"] > 0 and outcomes["refused"] > 0, outcomes
