"""The JPEG variants PIL 12.1 reads that PIL does not write: four-component
CMYK and YCCK, arithmetic coding (sequential and progressive, DAC
conditioning, restarts), lossless (predictors 1-7, point transforms,
subsampling, restarts), progressive files that libjpeg block-smooths and
4:4:0 sampling.

For every variant the JAX package's ``load_image(path, mode)`` (PIL) and the
port's equal each other bit for bit in "L" and "RGB", and the port's
``image_size`` equals PIL's; where PIL refuses a file (12-bit, 2-component,
hierarchical, DNL, arithmetic-coded lossless), the port raises
``UnsupportedImageFormat`` naming the variant. The files come from the
test encoders of ``scripts/format_variants.py`` (Pillow's libjpeg-turbo
driven through ``scripts/jpeg_test_encoder.c``). A CMYK page goes through
``run_full_workflow`` beside its PNG twin, and the committed full-size
pages of ``chip_smoke.py``'s variants phase decode to their recorded
digests.
"""
import hashlib
import io as _io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.utils import io as jio
from citlab_as_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts.format_variants import (  # noqa: E402
    JPEG_REFUSED, JPEG_VARIANTS, jpeg_bytes, jpeg_page, libjpeg_decode)

NAMES = list(JPEG_VARIANTS)
JPEG_DIR = os.path.join(REPO, "tests", "data", "torch_formats_jpeg")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_variants")
    out = {}
    for name, make in JPEG_VARIANTS.items():
        out[name] = str(root / f"{name}.jpg")
        with open(out[name], "wb") as f:
            f.write(make())
    return out


def _load_both(path, mode):
    jio._IMAGE_CACHE.clear()
    tio._IMAGE_CACHE.clear()
    return jio.load_image(path, mode), tio.load_image(path, mode)


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", NAMES)
def test_load_image_equals_jax(files, name, mode):
    """The reference's load_image (PIL) and the port's, bit for bit; the
    first case, a CMYK JPEG with an Adobe marker, was refused by name
    before the port decoded four components."""
    want, got = _load_both(files[name], mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"{len(diff)} samples differ, first at {diff[0].tolist()}"


@pytest.mark.parametrize("name", NAMES)
def test_image_size_equals_pil(files, name):
    with Image.open(files[name]) as im:
        assert tio.image_size(files[name]) == im.size


@pytest.mark.parametrize("name", list(JPEG_REFUSED))
def test_refusal_equals_pil(tmp_path, name):
    """PIL refuses the file: the port raises by name. ``image_size``
    raises where ``Image.open`` already does (precision, components, height
    0), and gives PIL's size where PIL fails only on the pixels."""
    make, word = JPEG_REFUSED[name]
    path = str(tmp_path / "r.jpg")
    with open(path, "wb") as f:
        f.write(make())
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


def test_arithmetic_jpeg_over_64_kib_decodes_as_libjpeg(tmp_path):
    """PIL 12.1 hands libjpeg a file 64 KiB at a time, and libjpeg's
    arithmetic decoder cannot wait for more data: PIL fails on larger
    arithmetic-coded files. The port decodes them to what libjpeg-turbo
    gives for the whole file in memory (the pixels PIL gives for the same
    coefficients Huffman-coded)."""
    data = jpeg_bytes(jpeg_page(700, 300, 3, 5), arith=True, quality=90)
    assert len(data) > 65536
    path = str(tmp_path / "big.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(OSError):
        with Image.open(path) as im:
            im.load()
    want = libjpeg_decode(data)
    for mode in ("L", "RGB"):
        tio._IMAGE_CACHE.clear()
        np.testing.assert_array_equal(tio.load_image(path, mode),
                                      np.asarray(want.convert(mode)))
    assert tio.image_size(path) == want.size


def test_cmyk_page_through_the_workflow_equals_its_png_twin(tmp_path, monkeypatch):
    """A CMYK JPEG page (Adobe inverted samples) through
    ``run_full_workflow`` with injected net outputs writes the same
    clustered PAGE-XML, byte for byte, as the page's PNG twin of PIL's
    pixels."""
    from citlab_as_tpu.pagexml import page as jpage
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.pagexml import page as tpage
    from scripts.bench_e2e import make_demo_page

    for mod in (jpage, tpage):
        monkeypatch.setattr(mod, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    root = str(tmp_path)
    png, _ = make_demo_page(root, "d0", np.random.RandomState(3))
    grey = np.asarray(Image.open(png).convert("L"))
    tint = np.stack([grey, grey * 0.94 + 6, grey * 0.82 + 12], -1).clip(0, 255)
    cmy = 255 - tint.astype(np.int32)
    k = cmy.min(axis=-1, keepdims=True)
    cmyk = (255 - np.concatenate([cmy - k, k], axis=-1)).astype(np.uint8)
    page = os.path.join(root, "page", "d0.xml")
    images = [os.path.join(root, "cmyk.jpg"), os.path.join(root, "twin.png")]
    with open(images[0], "wb") as f:
        f.write(jpeg_bytes(cmyk, quality=80))
    with Image.open(images[0]) as im:
        assert im.mode == "CMYK"
        Image.fromarray(np.asarray(im.convert("L"))).save(images[1])
    for img in images:
        shutil.copy(page, os.path.join(root, "page", os.path.splitext(
            os.path.basename(img))[0] + ".xml"))

    def separator(image_grey):
        h, w = image_grey.shape
        prob = np.zeros((h, w, 2), np.float32)
        prob[10:h - 10, w // 2 - 2:w // 2 + 2, 0] = 0.9
        prob[..., 1] = 1.0 - prob[..., 0]
        return prob

    def benign(image_grey):
        prob = np.zeros(image_grey.shape + (2,), np.float32)
        prob[..., 1] = 1.0
        return prob

    tio._IMAGE_CACHE.clear()
    result = run_full_workflow(
        images, out_dir=os.path.join(root, "out"), device="cpu", batch_size=2,
        separator_predictor=separator, heading_predictor=benign,
        gnn_predictor=RelationPredictor(os.path.join(REPO, "models_ckpt_torch", "gnn.npz"),
                                        device="cpu"))
    assert result["skipped"] == [] and len(result["clustered"]) == 2
    a, b = (open(p, "rb").read() for p in result["clustered"])
    assert a == b
    assert b"TextLine" in a


def _full_size_records():
    out = []
    for name in sorted(os.listdir(JPEG_DIR)):
        if name.endswith(".json"):
            with open(os.path.join(JPEG_DIR, name)) as f:
                out.append(json.load(f))
    return out


@pytest.mark.parametrize("rec", _full_size_records(), ids=lambda r: r["file"])
def test_committed_full_size_pages_decode_to_the_recorded_digests(rec):
    """The five full-size pages of chip_smoke.py's variants phase
    (scripts/make_format_fixtures.py): their recorded size and "L" / "RGB"
    digests are PIL's (for the arithmetic-coded page, larger than PIL
    reads, libjpeg-turbo's decode of the whole file), and the port
    decodes to them; each has a page XML."""
    path = os.path.join(JPEG_DIR, rec["file"])
    with open(path, "rb") as f:
        data = f.read()
    im = libjpeg_decode(data) if "oracle" in rec else Image.open(_io.BytesIO(data))
    assert list(im.size) == rec["size"]
    for mode in ("L", "RGB"):
        want = np.asarray(im.convert(mode))
        assert hashlib.sha256(want.tobytes()).hexdigest() == rec[f"sha256_{mode}"]
        tio._IMAGE_CACHE.clear()
        got = np.ascontiguousarray(tio.load_image(path, mode))
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec[f"sha256_{mode}"]
    assert list(tio.image_size(path)) == rec["size"]
    stem = os.path.splitext(rec["file"])[0]
    assert os.path.exists(os.path.join(JPEG_DIR, "page", f"{stem}.xml"))
