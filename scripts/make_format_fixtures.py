"""Write the JPEG and TIFF page fixtures of ``chip_smoke.py``'s ``formats``
phase into ``tests/data/torch_formats/``:

- six full-size (2000 x 1420) pages of the smoke's own newspaper generator
  (``chip_smoke.synthetic_newspaper``, seed ``SEED``), one per format: a
  grey baseline JPEG with restart markers, a 4:2:0 colour JPEG, a
  progressive JPEG, a grey LZW TIFF with the horizontal predictor in
  strips, a grey Deflate TIFF in tiles and a CCITT Group 4 bilevel TIFF;
- ``page/<name>.xml`` for each: the drawn layout (one TextRegion per
  sub-column or headline, one TextLine per line);
- ``<name>.json`` for each: PIL's ``(width, height)`` and the sha256 of
  PIL's decoded ``"L"`` bytes, which the smoke holds the port's decoder to
  on the card's machine (that machine has no PIL).

Then the fixtures of the smoke's ``variants`` phase, in
``tests/data/torch_formats_variants/``:

- ``small/``: every decodable PNM, PNG and TIFF variant of
  ``scripts/format_variants.py``'s catalog at its small size, with
  ``small.json``: each file's PIL size and the sha256 of PIL's ``"L"`` and
  ``"RGB"`` bytes;
- three full-size pages of the newspaper generator (seed ``VARIANT_SEED``)
  in the variants the smoke cannot write itself: a CCITT Group 3 2-D TIFF,
  a JPEG-in-TIFF in YCbCr (4:2:0, strips of 64 rows) and a 16-bit LZW TIFF
  with the horizontal predictor whose samples hold the 8-bit values, each
  with ``page/<name>.xml`` and ``<name>.json`` as above. (The smoke writes
  its Adam7 PNG, 16-bit PNG and PNM pages itself.)

Then the full-size JPEG pages of the smoke's ``variants`` phase in
``tests/data/torch_formats_jpeg/``: five pages of the newspaper generator
(seed ``JPEG_SEED``) in the JPEG variants PIL reads and PIL does not write,
through Pillow's libjpeg-turbo (``scripts/format_variants.py``): a CMYK
JPEG with an Adobe marker, a YCCK JPEG, an arithmetic-coded progressive
colour JPEG (PIL's own progressive JPEG re-coded), a lossless grey JPEG
and a progressive colour JPEG whose last scan leaves the low coefficients
short (libjpeg block-smooths it), each with ``page/<name>.xml`` and
``<name>.json`` as above.

Then the WebP fixtures: ``--only webp`` rewrites just the ``webp_*``
files of ``tests/data/torch_formats_variants/small/`` and their records in
``small.json`` (a full ``variants`` run writes them too), and writes
three full-size pages of the newspaper generator (seed ``WEBP_SEED``) into
``tests/data/torch_formats_webp/``: a lossy colour page (quality 90, the
normal loop filter, 4 token partitions, 4 segments), a lossless grey page
and a lossy colour page with an alpha plane in a VP8L-compressed ALPH
chunk under the gradient filter, each with ``page/<name>.xml`` and
``<name>.json`` (PIL's "L" and "RGB" digests).

Then the JPEG 2000 fixtures: ``--only jpeg2000`` rewrites just the
``jpeg2000_*`` files of ``small/`` (written by PIL's save, by
``scripts/jpeg2000_test_encoder.c`` over Pillow's libopenjp2, and byte by
byte around its codestreams) and their records in ``small.json``, and
writes three full-size pages of the newspaper generator (seed
``JPEG2000_SEED``) into ``tests/data/torch_formats_jpeg2000/`` with PIL's
save: a lossy 9/7 grey page at rate 8 in RPCL order with 6 levels, 512 x
512 tiles and PLT markers (an archive access copy), a lossless 5/3 grey
page and a lossy colour page with the ICT, each with ``page/<name>.xml``
and ``<name>.json`` (PIL's "L" and "RGB" digests).

Then the raster fixtures: ``--only raster`` rewrites just the small
variants of PCX, DCX, PSD, TGA, ICO, CUR, DIB, SGI, SUN, QOI, MSP, IM,
XBM, XPM, PIXAR, SPIDER, GBR, IMT, MCIDAS and XVTHUMB (written byte by
byte by ``scripts/format_variants.py``, no PIL) and their records in
``small.json``; a full ``variants`` run writes them too.

Then the main path's formats under damage and at the edges of PIL's table:
``--only main`` rewrites just the small variants named in ``MAIN_PREFIXES``
(Huffman-coded JPEG and PIL-written PNG bases of the damaged-file fuzz, the
TIFF layouts of ``TIFF_LAYOUT_VARIANTS``, the damaged copies of
``DAMAGED_VARIANTS`` and a PNG whose zlib check is never reached) and
their records in ``small.json``, and writes four full-size pages of the
newspaper generator (seed ``MAIN_SEED``) into
``tests/data/torch_formats_main/`` (``write_main_pages``).

Then the rest of PIL's registry: ``--only registry`` rewrites just the
small variants of DDS, BLP, FTEX, ICNS, FITS, FLI and IPTC
(``scripts/registry_variants.py``: byte by byte from seeds, or by PIL's
writers) and their records in ``small.json``, and writes one full-size
page of the newspaper generator (seed ``REGISTRY_SEED``) into
``tests/data/torch_formats_registry/``: a BC1 (DXT1) DDS by PIL's writer,
with ``page/<name>.xml`` and ``<name>.json`` (PIL's "L" and "RGB"
digests). PCD's files (786 KB each) are made by the tests from a seed.

Needs PIL (and, for the TIFF, JPEG, WebP and JPEG 2000 variants, the
libraries Pillow bundles, and gcc); run from the repository root:

    python scripts/make_format_fixtures.py [--only formats variants jpeg webp jpeg2000 raster main registry avif]

(the page XMLs get new timestamps on every run).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_formats")
VARIANTS_OUT = os.path.join(REPO, "tests", "data", "torch_formats_variants")
JPEG_OUT = os.path.join(REPO, "tests", "data", "torch_formats_jpeg")
WEBP_OUT = os.path.join(REPO, "tests", "data", "torch_formats_webp")
JPEG2000_OUT = os.path.join(REPO, "tests", "data", "torch_formats_jpeg2000")
MAIN_OUT = os.path.join(REPO, "tests", "data", "torch_formats_main")
REGISTRY_OUT = os.path.join(REPO, "tests", "data", "torch_formats_registry")
AVIF_OUT = os.path.join(REPO, "tests", "data", "torch_formats_avif")
SEED = 23
VARIANT_SEED = 29
JPEG_SEED = 37
WEBP_SEED = 41
JPEG2000_SEED = 43
MAIN_SEED = 47
REGISTRY_SEED = 53
AVIF_SEED = 61
SHAPE = (2000, 1420)
# (name, file ending, pixels: "grey" | "colour" | "bilevel", PIL save options)
FIXTURES = [
    ("grey_restart", "jpg", "grey", dict(format="JPEG", quality=75, restart_marker_rows=2)),
    ("colour_420", "jpg", "colour", dict(format="JPEG", quality=75, subsampling=2)),
    ("progressive", "jpg", "grey", dict(format="JPEG", quality=75, progressive=True)),
    ("lzw_predictor_strips", "tif", "grey",
     dict(format="TIFF", compression="tiff_lzw", predictor=2, rows_per_strip=64)),
    ("deflate_tiles", "tif", "grey",
     dict(format="TIFF", compression="tiff_adobe_deflate", tile=(256, 256))),
    ("group4", "tif", "bilevel", dict(format="TIFF", compression="group4")),
]


def pixels(page: np.ndarray, kind: str) -> Image.Image:
    if kind == "grey":
        return Image.fromarray(page)
    if kind == "bilevel":
        return Image.fromarray(page >= 128)       # mode "1": paper white, ink black
    grey = page.astype(np.float32)
    tint = np.stack([grey, grey * 0.94 + 6, grey * 0.82 + 12], axis=-1)   # yellowed paper
    return Image.fromarray(tint.clip(0, 255).astype(np.uint8))


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    kinds = ("formats", "variants", "jpeg", "webp", "jpeg2000", "raster", "main", "registry",
             "avif")
    parser.add_argument("--only", nargs="+", choices=kinds, default=kinds)
    only = parser.parse_args().only
    sys.path.insert(0, REPO)
    if "formats" in only:
        write_formats()
    if "variants" in only:
        write_variants()
    if "jpeg" in only:
        write_jpeg_pages()
    from scripts import format_variants as fv
    if "webp" in only:
        if "variants" not in only:
            write_small("webp_", fv.webp_small_variants())
        write_webp_pages()
    if "jpeg2000" in only:
        if "variants" not in only:
            write_small("jpeg2000_", fv.jpeg2000_small_variants())
        write_jpeg2000_pages()
    if "raster" in only and "variants" not in only:
        write_small(RASTER_PREFIXES, fv.raster_small_variants())
    if "main" in only:
        if "variants" not in only:
            write_small(MAIN_PREFIXES, [(name, write) for name, write in fv.small_variants()
                                        if name.startswith(MAIN_PREFIXES)])
        write_main_pages()
    if "registry" in only:
        from scripts import registry_variants as rv
        write_small(REGISTRY_PREFIXES, rv.registry_small_variants())
        write_registry_pages()
    if "avif" in only:
        from scripts import avif_variants as av
        write_small("avif_", av.avif_small_variants())
        write_avif_pages()
    return 0


def write_formats() -> None:
    import chip_smoke
    pages, _, layouts = chip_smoke.synthetic_newspaper(len(FIXTURES), *SHAPE, seed=SEED)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(os.path.join(OUT, "page"))
    total = 0
    for (name, ending, kind, options), page, regions in zip(FIXTURES, pages, layouts):
        path = os.path.join(OUT, f"{name}.{ending}")
        pixels(page, kind).save(path, **options)
        h, w = page.shape
        chip_smoke.write_layout_xml(os.path.join(OUT, "page", f"{name}.xml"),
                                    os.path.basename(path), h, w, regions)
        with Image.open(path) as im:
            record = {"file": os.path.basename(path), "size": list(im.size),
                      "mode": im.mode,
                      "sha256_L": hashlib.sha256(
                          np.asarray(im.convert("L")).tobytes()).hexdigest()}
        with open(os.path.join(OUT, f"{name}.json"), "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        size = os.path.getsize(path)
        total += size
        print(f"{os.path.relpath(path, REPO)}: {size} bytes, PIL mode {record['mode']}")
    print(f"total image bytes {total}")


def record(path, modes=("L",), oracle=None):
    """PIL's size and digests of the file (or of ``oracle``, the image PIL
    would give, where PIL itself cannot read the file)."""
    with (oracle or Image.open(path)) as im:
        out = {"file": os.path.basename(path), "size": list(im.size), "mode": im.mode}
        for mode in modes:
            out[f"sha256_{mode}"] = hashlib.sha256(
                np.asarray(im.convert(mode)).tobytes()).hexdigest()
    return out


def write_variants() -> None:
    import chip_smoke
    from scripts import format_variants as fv
    shutil.rmtree(VARIANTS_OUT, ignore_errors=True)
    os.makedirs(os.path.join(VARIANTS_OUT, "small"))
    os.makedirs(os.path.join(VARIANTS_OUT, "page"))
    records = []
    for name, write in fv.small_variants():
        path = os.path.join(VARIANTS_OUT, "small", name)
        write(path)
        records.append(record(path, ("L", "RGB")))
    with open(os.path.join(VARIANTS_OUT, "small", "small.json"), "w") as f:
        json.dump(records, f, indent=0)
        f.write("\n")
    pages, _, layouts = chip_smoke.synthetic_newspaper(3, *SHAPE, seed=VARIANT_SEED)
    grey, bilevel = pages[0], (pages[1] < 128).astype(np.uint8)
    colour = np.asarray(pixels(pages[2], "colour"))
    full = [("group3_2d", dict(samples=bilevel, bps=1, photometric=0, compression=3,
                               t4options=1, rows_per_strip=128)),
            ("jpeg_ycbcr", dict(samples=colour, bps=8, photometric=6, compression=7,
                                jpegcolormode=1, rows_per_strip=64)),
            ("lzw16_predictor", dict(samples=grey.astype(np.uint16), bps=16, photometric=1,
                                     compression=5, predictor=2, rows_per_strip=64))]
    total = 0
    for (name, options), page, regions in zip(full, [pages[1], pages[2], pages[0]],
                                              [layouts[1], layouts[2], layouts[0]]):
        path = os.path.join(VARIANTS_OUT, f"{name}.tif")
        fv.write_tiff(path, **options)
        h, w = page.shape
        chip_smoke.write_layout_xml(os.path.join(VARIANTS_OUT, "page", f"{name}.xml"),
                                    os.path.basename(path), h, w, regions)
        with open(os.path.join(VARIANTS_OUT, f"{name}.json"), "w") as f:
            json.dump(record(path), f, indent=1)
            f.write("\n")
        total += os.path.getsize(path)
        print(f"{os.path.relpath(path, REPO)}: {os.path.getsize(path)} bytes")
    small = sum(os.path.getsize(os.path.join(VARIANTS_OUT, "small", r["file"]))
                for r in records)
    print(f"{len(records)} small variants, {small} bytes; full-size pages {total} bytes")


def cmyk_of(rgb: np.ndarray) -> np.ndarray:
    """RGB -> the samples a print-side CMYK JPEG stores: ink with grey
    component replacement (K = min(C, M, Y)), inverted as Adobe writes it."""
    cmy = 255 - rgb.astype(np.int32)
    k = cmy.min(axis=-1, keepdims=True)
    return (255 - np.concatenate([cmy - k, k], axis=-1)).astype(np.uint8)


def write_jpeg_pages() -> None:
    import io

    import chip_smoke
    from scripts import format_variants as fv
    shutil.rmtree(JPEG_OUT, ignore_errors=True)
    os.makedirs(os.path.join(JPEG_OUT, "page"))
    pages, _, layouts = chip_smoke.synthetic_newspaper(5, *SHAPE, seed=JPEG_SEED)
    colour = [np.asarray(pixels(p, "colour")) for p in pages]
    buf = io.BytesIO()
    Image.fromarray(colour[2]).save(buf, format="JPEG", quality=75, progressive=True)
    full = [("cmyk_adobe", fv.jpeg_bytes(cmyk_of(colour[0]), quality=50)),
            ("ycck", fv.jpeg_bytes(cmyk_of(colour[1]), colorspace="ycck", quality=50,
                                   sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])),
            ("arith_progressive", fv.jpeg_transcode(buf.getvalue(), progressive=True)),
            ("lossless_grey", fv.jpeg_bytes(pages[3], lossless=(6, 0), restart_rows=16)),
            ("smoothed_progressive", fv.jpeg_bytes(colour[4], quality=75, progressive=True,
                                                   scans=fv.SMOOTHING_SCRIPTS["final-al"]))]
    total = 0
    for (name, data), page, regions in zip(full, pages, layouts):
        path = os.path.join(JPEG_OUT, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        h, w = page.shape
        chip_smoke.write_layout_xml(os.path.join(JPEG_OUT, "page", f"{name}.xml"),
                                    os.path.basename(path), h, w, regions)
        # PIL 12.1 fails on arithmetic-coded files over 64 KiB: their
        # digests are libjpeg-turbo's own decode of the whole file
        arith = name == "arith_progressive"
        rec = record(path, ("L", "RGB"), fv.libjpeg_decode(data) if arith else None)
        if arith:
            rec["oracle"] = "libjpeg-turbo of pillow.libs, whole file in memory"
        with open(os.path.join(JPEG_OUT, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        total += len(data)
        print(f"{os.path.relpath(path, REPO)}: {len(data)} bytes")
    print(f"full-size JPEG pages {total} bytes")


RASTER_PREFIXES = ("pcx_", "dcx_", "psd_", "tga_", "ico_", "cur_", "dib_", "sgi_", "sun_",
                   "qoi_", "msp_", "im_", "xbm_", "xpm_", "pixar_", "spider_", "gbr_", "imt_",
                   "mcidas_", "xvthumb")


REGISTRY_PREFIXES = ("dds_", "blp_", "ftex_", "icns_", "fits_", "fli_", "iptc_")


def write_small(prefix, variants) -> None:
    """The small variants whose names start with ``prefix`` (a string or a
    tuple of them) and their records, the rest of ``small/`` left as it
    is."""
    small = os.path.join(VARIANTS_OUT, "small")
    with open(os.path.join(small, "small.json")) as f:
        records = [r for r in json.load(f) if not r["file"].startswith(prefix)]
    for stale in os.listdir(small):
        if stale.startswith(prefix):
            os.remove(os.path.join(small, stale))
    for name, write in variants:
        path = os.path.join(small, name)
        write(path)
        records.append(record(path, ("L", "RGB")))
    with open(os.path.join(small, "small.json"), "w") as f:
        json.dump(records, f, indent=0)
        f.write("\n")
    print(f"{len(variants)} small {prefix if isinstance(prefix, str) else prefix[0]}... variants")


def webp_alpha(h: int, w: int) -> np.ndarray:
    """An alpha plane for a page: opaque paper, the margins fading out."""
    yy, xx = np.mgrid[0:h, 0:w]
    edge = np.minimum(np.minimum(yy, h - 1 - yy), np.minimum(xx, w - 1 - xx))
    return np.clip(90 + edge * 3, 0, 255).astype(np.uint8)


def write_webp_pages() -> None:
    import chip_smoke
    from scripts import format_variants as fv
    shutil.rmtree(WEBP_OUT, ignore_errors=True)
    os.makedirs(os.path.join(WEBP_OUT, "page"))
    pages, _, layouts = chip_smoke.synthetic_newspaper(3, *SHAPE, seed=WEBP_SEED)
    colour = [np.asarray(pixels(p, "colour")) for p in pages]
    h, w = SHAPE
    full = [("lossy_q90", fv.webp_bytes(colour[0], quality=90, filter_type=1, partitions=2,
                                        segments=4)),
            ("lossless", fv.webp_bytes(pages[1], lossless=True)),
            ("lossy_alpha", fv.riff_webp(
                fv.vp8x_chunk(fv.WEBP_ALPHA, w, h),
                fv.alph_chunk(webp_alpha(h, w), compression=1, method=3),
                fv.webp_image_chunk(fv.webp_bytes(colour[2], quality=90))))]
    total = 0
    for (name, data), page, regions in zip(full, pages, layouts):
        path = os.path.join(WEBP_OUT, f"{name}.webp")
        with open(path, "wb") as f:
            f.write(data)
        chip_smoke.write_layout_xml(os.path.join(WEBP_OUT, "page", f"{name}.xml"),
                                    os.path.basename(path), h, w, regions)
        with open(os.path.join(WEBP_OUT, f"{name}.json"), "w") as f:
            json.dump(record(path, ("L", "RGB")), f, indent=1)
            f.write("\n")
        total += len(data)
        print(f"{os.path.relpath(path, REPO)}: {len(data)} bytes")
    print(f"full-size WebP pages {total} bytes")


def write_jpeg2000_pages() -> None:
    import chip_smoke
    shutil.rmtree(JPEG2000_OUT, ignore_errors=True)
    os.makedirs(os.path.join(JPEG2000_OUT, "page"))
    pages, _, layouts = chip_smoke.synthetic_newspaper(3, *SHAPE, seed=JPEG2000_SEED)
    h, w = SHAPE
    full = [("lossy_97_rpcl_tiles", pixels(pages[0], "grey"),
             dict(irreversible=True, quality_mode="rates", quality_layers=[8],
                  progression="RPCL", num_resolutions=7, tile_size=(512, 512), plt=True)),
            ("lossless_53", pixels(pages[1], "grey"), dict()),
            ("lossy_colour_ict", pixels(pages[2], "colour"),
             dict(irreversible=True, mct=1, quality_mode="rates", quality_layers=[24]))]
    total = 0
    for (name, image, options), regions in zip(full, layouts):
        path = os.path.join(JPEG2000_OUT, f"{name}.jp2")
        image.save(path, format="JPEG2000", **options)
        chip_smoke.write_layout_xml(os.path.join(JPEG2000_OUT, "page", f"{name}.xml"),
                                    os.path.basename(path), h, w, regions)
        with open(os.path.join(JPEG2000_OUT, f"{name}.json"), "w") as f:
            json.dump(record(path, ("L", "RGB")), f, indent=1)
            f.write("\n")
        total += os.path.getsize(path)
        print(f"{os.path.relpath(path, REPO)}: {os.path.getsize(path)} bytes")
    print(f"full-size JPEG 2000 pages {total} bytes")


# the small variants of the main path's formats under damage and at the
# edges of PIL's table
MAIN_PREFIXES = ("jpeg_huffman-", "png_pil-", "tiff_layout-", "jpeg_damaged-", "tiff_damaged-",
                 "gif_damaged-", "png_damaged-")


def damaged_jpeg(data: bytes, places=(0.3, 0.55, 0.8)) -> bytes:
    """``data`` with one byte of its entropy-coded data changed at each of
    ``places`` (fractions of the scan), to the first value after which PIL
    still decodes the page to other pixels (libjpeg-turbo's recovery)."""
    import io

    from scripts.fuzz_main_formats import jpeg_entropy_spans
    (start, end), = jpeg_entropy_spans(data)
    out = bytearray(data)
    with Image.open(io.BytesIO(data)) as im:
        clean = np.asarray(im.convert("L"))
    for frac in places:
        at = start + int((end - start) * frac)
        for value in range(1, 256):
            trial = bytearray(out)
            trial[at] = (out[at] + value) & 0xFF
            try:
                with Image.open(io.BytesIO(bytes(trial))) as im:
                    grey = np.asarray(im.convert("L"))
            except Exception:       # noqa: BLE001 - PIL refuses this one: try the next
                continue
            if not np.array_equal(grey, clean):
                out = trial
                break
    return bytes(out)


def write_main_pages() -> None:
    """Four full-size pages of the main path's formats that PIL 12.1 reads
    and the port read last: a JPEG with three bytes of its entropy-coded
    data changed (PIL decodes it through libjpeg-turbo's recovery), an
    RGBA JPEG-in-TIFF, separate YCbCr planes under LZW and a palette page
    with alpha ("PA", Deflate), each with ``page/<name>.xml`` and
    ``<name>.json`` (PIL's "L" and "RGB" digests)."""
    import io

    import chip_smoke
    from scripts import format_variants as fv
    shutil.rmtree(MAIN_OUT, ignore_errors=True)
    os.makedirs(os.path.join(MAIN_OUT, "page"))
    pages, _, layouts = chip_smoke.synthetic_newspaper(4, *SHAPE, seed=MAIN_SEED)
    colour = [np.asarray(pixels(p, "colour")) for p in pages]
    h, w = SHAPE
    alpha = webp_alpha(h, w)
    buf = io.BytesIO()
    Image.fromarray(pages[0]).save(buf, format="JPEG", quality=75)
    paletted = Image.fromarray(colour[3]).quantize(256)
    lut = np.asarray(paletted.getpalette()[:768], np.uint16).reshape(-1, 3).T * 257
    colormap = np.zeros((3, 256), np.uint16)
    colormap[:, :lut.shape[1]] = lut
    full = [("damaged", "jpg", lambda p: open(p, "wb").write(damaged_jpeg(buf.getvalue()))),
            ("jpeg_rgba", "tif", lambda p: fv.write_tiff(
                p, samples=np.dstack([colour[1], alpha]), bps=8, photometric=2,
                extrasamples=(2,), compression=7, rows_per_strip=64)),
            ("ycbcr_planar_lzw", "tif", lambda p: fv.write_tiff(
                p, samples=np.asarray(Image.fromarray(colour[2]).convert("YCbCr")), bps=8,
                photometric=6, planar=2, compression=5, subsampling=(1, 1), rows_per_strip=64)),
            ("palette_alpha", "tif", lambda p: fv.write_tiff(
                p, samples=np.dstack([np.asarray(paletted), alpha]), bps=8, photometric=3,
                extrasamples=(2,), colormap=colormap, compression=8, rows_per_strip=64))]
    total = 0
    for (name, ending, write), regions in zip(full, layouts):
        path = os.path.join(MAIN_OUT, f"{name}.{ending}")
        write(path)
        chip_smoke.write_layout_xml(os.path.join(MAIN_OUT, "page", f"{name}.xml"),
                                    os.path.basename(path), h, w, regions)
        with open(os.path.join(MAIN_OUT, f"{name}.json"), "w") as f:
            json.dump(record(path, ("L", "RGB")), f, indent=1)
            f.write("\n")
        total += os.path.getsize(path)
        print(f"{os.path.relpath(path, REPO)}: {os.path.getsize(path)} bytes")
    print(f"full-size main-path pages {total} bytes")


def write_registry_pages() -> None:
    """One full-size page of the block-texture formats that PIL's writer
    makes: BC1 (DXT1) of the tinted colour page in a DDS, with
    ``page/<name>.xml`` and ``<name>.json`` (PIL's "L" and "RGB"
    digests)."""
    import chip_smoke
    shutil.rmtree(REGISTRY_OUT, ignore_errors=True)
    os.makedirs(os.path.join(REGISTRY_OUT, "page"))
    pages, _, layouts = chip_smoke.synthetic_newspaper(1, *SHAPE, seed=REGISTRY_SEED)
    h, w = SHAPE
    path = os.path.join(REGISTRY_OUT, "dds_bc1.dds")
    pixels(pages[0], "colour").save(path, format="DDS", pixel_format="DXT1")
    chip_smoke.write_layout_xml(os.path.join(REGISTRY_OUT, "page", "dds_bc1.xml"),
                                os.path.basename(path), h, w, layouts[0])
    with open(os.path.join(REGISTRY_OUT, "dds_bc1.json"), "w") as f:
        json.dump(record(path, ("L", "RGB")), f, indent=1)
        f.write("\n")
    print(f"{os.path.relpath(path, REPO)}: {os.path.getsize(path)} bytes")



def write_avif_pages() -> None:
    """The nine full-size AVIF pages PIL's writer makes from the tinted
    colour pages (``scripts/avif_variants.avif_pages``: PIL's defaults with
    palette and IntraBC, speed 8 with palette and no IntraBC, a scanned
    copy with no screen content, deblocked; the scanned copy with loop
    restoration and CDEF, under superres, with film grain from aom's
    denoiser, as a 4 x 3 grid; an avis sequence; premultiplied alpha), each
    with ``page/<name>.xml`` and ``<name>.json`` (PIL's "L" and "RGB"
    digests; the grain page's film grain parameters as dav1d reads them).
    Their PNG twins are written where they are used, from the recorded
    pixels."""
    import chip_smoke
    from scripts.avif_variants import avif_pages
    shutil.rmtree(AVIF_OUT, ignore_errors=True)
    os.makedirs(os.path.join(AVIF_OUT, "page"))
    pages, _, layouts = chip_smoke.synthetic_newspaper(3, *SHAPE, seed=AVIF_SEED)
    h, w = SHAPE
    total = 0
    for name, data, k in avif_pages(pages, lambda p: np.asarray(pixels(p, "colour"))):
        layout = layouts[k]
        stem = os.path.splitext(name)[0]
        path = os.path.join(AVIF_OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        chip_smoke.write_layout_xml(os.path.join(AVIF_OUT, "page", f"{stem}.xml"), name, h, w,
                                    layout)
        rec = record(path, ("L", "RGB"))
        if name == "grain.avif":
            # the film grain parameters dav1d reads from the frame header
            from citlab_as_tpu_torch.utils import avif
            from scripts.fuzz_avif import dav1d_grain
            info = avif.open_avif(data)
            rec["film_grain"] = dav1d_grain(avif._item_data(info.meta, info.color, data))
        with open(os.path.join(AVIF_OUT, f"{stem}.json"), "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        total += len(data)
        print(f"{os.path.relpath(path, REPO)}: {len(data)} bytes")
    print(f"full-size AVIF pages {total} bytes")


if __name__ == "__main__":
    sys.exit(main())
