"""The AVIF test files of the port's AV1 intra-frame decoder, written by PIL
12.1's AVIF writer (libavif 1.3.0 over aom 3.12.1) and, where PIL's save
has no switch for it, patched or put together byte by byte around its
output.

- ``AVIF_VARIANTS``: the small fixtures (``avif_<name>.avif`` in
  ``tests/data/torch_formats_variants/small/``): a drawn page and a photo
  at every speed, at quality 0 to 100, in 4:0:0 / 4:2:0 / 4:2:2 / 4:4:4,
  full and limited range, with tile rows and columns and autotiling, aom's
  intra options one at a time, 128 x 128 superblocks, odd sizes; the
  ``colr`` box relabelled to the identity matrix (PIL's "RGB" bytes are
  then the AV1 planes: G = Y, B = U, R = V), to BT.709 and BT.2020 in both
  ranges, or taken away (the sequence header's colour config applies);
  EXIF (with an orientation PIL writes as ``irot`` / ``imir``), XMP, ICC
  and alpha. Each returns the file's bytes.
  Since part 2 also loop restoration, CDEF (4:2:2, 128 x 128
  superblocks), 10- and 12-bit streams in every layout and range (8-bit
  streams PIL wrote, their sequence header rewritten: PIL's aom has no
  high bit depth), superres (a half-width encode, its headers rewritten)
  and the matrices libavif converts in floating point.
  Since part 3 also film grain (aom's test vectors, its denoiser, every
  depth and layout, odd sizes), ``grid`` items (cropped edges, an alpha
  grid; ``grid_bytes``), ``avis`` sequences (``sequence_bytes``, an alpha
  track, a rewritten tkhd size), premultiplied and limited-range alpha,
  and ``ispe`` sizes libavif rescales the frame to (``ispe_bytes``).
- ``AVIF_FAULTS``: container faults PIL refuses (a brand, a missing or
  malformed box, an extent past the file's end, a truncated file, the
  identity matrix over subsampled chroma);
  ``huge_frame_bytes``: a frame past dav1d's size limit.
- ``avif_pages``: the nine full-size pages of ``chip_smoke.py``'s variants
  phase (``tests/data/torch_formats_avif/``).
"""
from __future__ import annotations

import io
import struct
from typing import Callable, Dict, Optional

import numpy as np
from PIL import Image, ImageDraw

PAGE = (160, 120)     # (width, height) of the small drawn pages
PHOTO = (96, 72)


def page_rgb(w: int, h: int, seed: int = 0, photo: bool = True) -> np.ndarray:
    """A drawn newspaper-like page in colour: columns of word-like bars,
    rules, and a photo block; screen content to aom (palette, IntraBC)."""
    rng = np.random.default_rng(seed)
    im = Image.new("RGB", (w, h), (250, 248, 240))
    d = ImageDraw.Draw(im)
    cols = max(1, w // 300)
    cw = w // cols
    for c in range(cols):
        x0, y = c * cw + 10, 20
        while y < h - 20:
            if rng.random() < 0.08:
                y += 14
                continue
            x = x0
            while x < x0 + cw - 30:
                lw = int(rng.integers(4, 30))
                d.rectangle([x, y, x + lw, y + 7], fill=(20, 20, 25))
                x += lw + int(rng.integers(3, 8))
            y += 12
        d.line([c * cw + 2, 10, c * cw + 2, h - 10], fill=(0, 0, 0), width=2)
    d.line([5, 12, w - 5, 12], fill=(0, 0, 0), width=3)
    if photo:
        pw, ph = w // 4, h // 5
        px, py = int(rng.integers(0, w - pw)), int(rng.integers(0, h - ph))
        yy, xx = np.mgrid[0:ph, 0:pw]
        grey = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
                + rng.normal(0, 12, (ph, pw))).clip(0, 255).astype(np.uint8)
        im.paste(Image.fromarray(np.stack([grey, (grey * 0.9).astype(np.uint8),
                                           (grey * 0.7).astype(np.uint8)], -1)), (px, py))
    return np.asarray(im)


def photo_rgb(w: int, h: int, seed: int = 0) -> np.ndarray:
    """A smooth photo with grain: no screen content, so aom deblocks it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (120 + 50 * np.sin(xx / 13.0 + yy / 29.0) + 40 * np.cos(yy / 17.0)
            + rng.normal(0, 6, (h, w)))
    rgb = np.stack([base, base * 0.8 + 30, 255 - base * 0.6], -1)
    return rgb.clip(0, 255).astype(np.uint8)


def mix_rgb(w: int, h: int, seed: int = 0) -> np.ndarray:
    """A photo whose top half is a drawn page."""
    out = photo_rgb(w, h, seed=seed).copy()
    out[: h // 2] = page_rgb(max(w, 40), max(h, 40), seed=seed)[: h // 2, :w]
    return out


def avif_bytes(arr: np.ndarray, **save) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "AVIF", **save)
    return buf.getvalue()


def patch_nclx(data: bytes, matrix=None, full=None, primaries=None, transfer=None) -> bytes:
    """The file with its ``colr`` ``nclx`` values replaced."""
    off = data.find(b"colrnclx") + 8
    p, t, m = struct.unpack_from(">HHH", data, off)
    f = data[off + 6] >> 7
    out = bytearray(data)
    struct.pack_into(">HHHB", out, off, p if primaries is None else primaries,
                     t if transfer is None else transfer, m if matrix is None else matrix,
                     (f if full is None else full) << 7)
    return bytes(out)


def drop_colr(data: bytes) -> bytes:
    """The ``colr`` property renamed ``free`` (an unknown property, which
    libavif ignores): the sequence header's colour config applies."""
    i = data.find(b"colrnclx")
    return data[:i] + b"free" + data[i + 4:]


def add_properties(data: bytes, boxes) -> bytes:
    """A single-item file PIL wrote with property ``boxes`` appended to its
    ``ipco`` and associated with item 1 (the transformative ``clap``,
    ``irot`` and ``imir`` marked essential, as libavif requires); the boxes
    around them and the ``iloc`` offsets into ``mdat`` are moved to match."""
    grow = sum(len(b) for b in boxes)
    out = bytearray(data)

    def box_at(kind, start=0):
        i = out.find(kind, start) - 4
        return i, struct.unpack_from(">I", out, i)[0]
    meta, _ = box_at(b"meta")
    ipco, ipco_size = box_at(b"ipco", meta)
    count = len(_ipco_children(bytes(out[ipco + 8:ipco + ipco_size])))
    ipma, ipma_size = box_at(b"ipma", meta)
    # ipma v0 flags 0: entry_count(4), then item 1: id(2), n(1), indices(1 each)
    n_at = ipma + 12 + 4 + 2
    n = out[n_at]
    new_idx = bytes((count + 1 + k) | (0x80 if b[4:8] in (b"clap", b"irot", b"imir") else 0)
                    for k, b in enumerate(boxes))
    out[n_at] = n + len(boxes)
    out[n_at + 1 + n:n_at + 1 + n] = new_idx
    struct.pack_into(">I", out, ipma, ipma_size + len(boxes))
    out[ipco + ipco_size:ipco + ipco_size] = b"".join(boxes)
    struct.pack_into(">I", out, ipco, ipco_size + grow)
    iprp, iprp_size = box_at(b"iprp", meta)
    struct.pack_into(">I", out, iprp, iprp_size + grow + len(boxes))
    meta_size = struct.unpack_from(">I", out, meta)[0]
    struct.pack_into(">I", out, meta, meta_size + grow + len(boxes))
    # iloc v0, offset/length 4 bytes, no base: move every extent
    iloc, _ = box_at(b"iloc", meta)
    items = struct.unpack_from(">H", out, iloc + 14)[0]
    pos = iloc + 16
    for _ in range(items):
        extents = struct.unpack_from(">H", out, pos + 4)[0]
        pos += 6
        for _ in range(extents):
            off = struct.unpack_from(">I", out, pos)[0]
            struct.pack_into(">I", out, pos, off + grow + len(boxes))
            pos += 8
    return bytes(out)


def _ipco_children(payload: bytes):
    kids, pos = [], 0
    while pos + 8 <= len(payload):
        size = struct.unpack_from(">I", payload, pos)[0]
        kids.append(payload[pos + 4:pos + 8])
        pos += size
    return kids


def clap_box(w: int, h: int, dw: int, dh: int) -> bytes:
    """A clean aperture ``dw`` x ``dh`` centred in a ``w`` x ``h`` image."""
    return struct.pack(">I4s8I", 40, b"clap", dw, 1, dh, 1, 0, 1, 0, 1)


def pasp_box(h_spacing: int, v_spacing: int) -> bytes:
    return struct.pack(">I4sII", 16, b"pasp", h_spacing, v_spacing)


def _exif(orientation: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    exif[0x010F] = "citlab"
    return exif.tobytes()


def _icc() -> bytes:
    from PIL import ImageCms
    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def _rgba(arr: np.ndarray) -> np.ndarray:
    h, w = arr.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip(80 + 3 * np.minimum(np.minimum(yy, h - 1 - yy), np.minimum(xx, w - 1 - xx)),
                    0, 255).astype(np.uint8)
    return np.dstack([arr, alpha])


def _variants() -> Dict[str, Callable[[], bytes]]:
    pg = lambda seed=3: page_rgb(*PAGE, seed=seed)   # noqa: E731
    ph = lambda seed=4: photo_rgb(*PHOTO, seed=seed)  # noqa: E731
    v: Dict[str, Callable[[], bytes]] = {}
    # speed 0 turns on loop restoration for the page, speeds 0-4 for the
    # photo (part 2's variants)
    for speed in range(1, 11):
        v[f"page-speed{speed}"] = lambda s=speed: avif_bytes(pg(), speed=s)
    for speed in range(5, 11):
        v[f"photo-speed{speed}"] = lambda s=speed: avif_bytes(ph(), speed=s)
    for q in (0, 10, 50, 90, 100):
        v[f"page-q{q}"] = lambda q=q: avif_bytes(pg(), quality=q)
        v[f"photo-q{q}"] = lambda q=q: avif_bytes(ph(), quality=q)
    for ss in ("4:0:0", "4:2:0", "4:2:2", "4:4:4"):
        tag = ss.replace(":", "")
        v[f"page-{tag}"] = lambda ss=ss: avif_bytes(pg(), subsampling=ss)
        v[f"photo-{tag}"] = lambda ss=ss: avif_bytes(ph(), subsampling=ss)
        v[f"photo-{tag}-limited"] = lambda ss=ss: avif_bytes(ph(), subsampling=ss,
                                                             range="limited")
    v["page-limited"] = lambda: avif_bytes(pg(), range="limited")
    wide = lambda: page_rgb(320, 192, seed=5)  # noqa: E731
    v["tiles-r1c1"] = lambda: avif_bytes(wide(), tile_rows=1, tile_cols=1)
    v["tiles-r2c2"] = lambda: avif_bytes(wide(), tile_rows=2, tile_cols=2)
    v["tiles-c2-speed8"] = lambda: avif_bytes(wide(), tile_cols=2, speed=8)
    v["autotiling"] = lambda: avif_bytes(wide(), autotiling=True)
    # aom's intra options, one at a time, on the page and the photo
    options = [("enable-filter-intra", "0"), ("enable-smooth-intra", "0"),
               ("enable-paeth-intra", "0"), ("enable-cfl-intra", "0"),
               ("enable-angle-delta", "0"), ("enable-intra-edge-filter", "0"),
               ("enable-tx64", "0"), ("enable-flip-idtx", "0"), ("enable-rect-tx", "0"),
               ("reduced-tx-type-set", "1"), ("enable-qm", "1"), ("deltaq-mode", "2"),
               ("enable-chroma-deltaq", "1"), ("sharpness", "7"), ("tune-content", "screen"),
               ("sb-size", "128"), ("min-partition-size", "16"), ("max-partition-size", "32"),
               ("cdf-update-mode", "0"), ("enable-palette", "0"), ("enable-intrabc", "0")]
    for key, value in options:
        v[f"page-{key}-{value}"] = lambda k=key, x=value: avif_bytes(pg(), advanced={k: x})
        v[f"photo-{key}-{value}"] = lambda k=key, x=value: avif_bytes(ph(), advanced={k: x})
    v["photo-qm-0-8"] = lambda: avif_bytes(ph(), advanced={"enable-qm": "1", "qm-min": "0",
                                                           "qm-max": "8"})
    v["page-qm-4-12"] = lambda: avif_bytes(pg(), advanced={"enable-qm": "1", "qm-min": "4",
                                                           "qm-max": "12"})
    v["page-sb128-speed5"] = lambda: avif_bytes(wide(), speed=5, advanced={"sb-size": "128"})
    v["photo-cdef-off-restoration-on"] = lambda: avif_bytes(
        ph(), advanced={"enable-restoration": "1", "enable-cdef": "0"})
    # IntraBC reading past the frame's width or height, within its 8-pixel
    # alignment (dav1d reads the reconstructed pixels there)
    v["intrabc-edge-444"] = lambda: avif_bytes(
        mix_rgb(474, 67, seed=243), speed=1, quality=40, subsampling="4:4:4",
        advanced={"enable-intra-edge-filter": "1", "deltaq-mode": "0", "tune-content": "screen"})
    v["intrabc-edge-400"] = lambda: avif_bytes(
        mix_rgb(851, 58, seed=131), speed=2, quality=90, subsampling="4:0:0",
        advanced={"enable-cfl-intra": "1", "enable-intrabc": "1"})
    # odd sizes
    for w, h in ((1, 1), (3, 5), (17, 33), (65, 7)):
        v[f"noise-{w}x{h}"] = lambda w=w, h=h: avif_bytes(
            np.random.default_rng(w * 100 + h).integers(0, 256, (h, w, 3), np.uint8))
    # colour relabelled: identity (the planes oracle), BT.709, BT.2020
    rgb444 = lambda: avif_bytes(ph(), subsampling="4:4:4")  # noqa: E731
    v["identity-444"] = lambda: patch_nclx(rgb444(), matrix=0)
    v["identity-444-limited"] = lambda: patch_nclx(rgb444(), matrix=0, full=0)
    for matrix, tag in ((1, "bt709"), (9, "bt2020"), (5, "bt470bg"), (2, "unspecified")):
        for full in (1, 0):
            rng_tag = "full" if full else "limited"
            v[f"{tag}-{rng_tag}"] = lambda m=matrix, f=full: patch_nclx(
                avif_bytes(pg()), matrix=m, full=f)
    v["no-colr"] = lambda: drop_colr(avif_bytes(pg()))
    v["no-colr-400"] = lambda: drop_colr(avif_bytes(ph(), subsampling="4:0:0"))
    # metadata and alpha
    v["exif-orientation6"] = lambda: avif_bytes(pg(), exif=_exif(6))
    v["exif-orientation3"] = lambda: avif_bytes(pg(), exif=_exif(3))
    v["exif-orientation2"] = lambda: avif_bytes(pg(), exif=_exif(2))
    v["exif-orientation7"] = lambda: avif_bytes(pg(), exif=_exif(7))
    # a clean aperture and a pixel aspect ratio: PIL neither crops nor scales
    v["clap-pasp"] = lambda: add_properties(avif_bytes(pg()), [clap_box(*PAGE, 120, 80),
                                                               pasp_box(4, 3)])
    v["xmp"] = lambda: avif_bytes(pg(), xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    v["icc"] = lambda: avif_bytes(pg(), icc_profile=_icc())
    v["alpha"] = lambda: avif_bytes(_rgba(pg()))
    v["alpha-444"] = lambda: avif_bytes(_rgba(ph()), subsampling="4:4:4")
    # libyuv's I400 to RGBA (monochrome with alpha, limited range)
    v["alpha-400-limited"] = lambda: avif_bytes(_rgba(ph()), subsampling="4:0:0",
                                                range="limited")
    v.update(_part2_variants())
    v.update(_part3_variants())
    return v


def _part2_variants() -> Dict[str, Callable[[], bytes]]:
    """The files of the decoder's part 2: loop restoration (aom turns it on
    at speed 0 for the page and 0-4 for the photo), CDEF, 10- and 12-bit
    samples, superres, and the matrices libavif converts in floating point
    or through libyuv's I400."""
    pg = lambda seed=3: page_rgb(*PAGE, seed=seed)   # noqa: E731
    ph = lambda seed=4: photo_rgb(*PHOTO, seed=seed)  # noqa: E731
    wide = lambda: photo_rgb(320, 192, seed=6)       # noqa: E731
    both = {"enable-cdef": "1", "enable-restoration": "1"}
    v: Dict[str, Callable[[], bytes]] = {}
    v["page-speed0"] = lambda: avif_bytes(pg(), speed=0)
    for speed in range(5):
        v[f"photo-speed{speed}"] = lambda s=speed: avif_bytes(ph(), speed=s)
    v["photo-cdef"] = lambda: avif_bytes(ph(), advanced={"enable-cdef": "1"})
    v["photo-cdef-422"] = lambda: avif_bytes(ph(), subsampling="4:2:2",
                                             advanced={"enable-cdef": "1"})
    v["photo-cdef-sb128"] = lambda: avif_bytes(wide(), speed=4, advanced={
        "enable-cdef": "1", "sb-size": "128"})
    v["page-cdef-restoration"] = lambda: avif_bytes(pg(), speed=2, advanced=both)
    # loop restoration over several units: tiles, every layout, 128 x 128
    # superblocks, a low quality (self-guided and switchable frames)
    v["restoration-tiles"] = lambda: avif_bytes(wide(), speed=2, tile_rows=1, tile_cols=1,
                                                advanced=both)
    for ss in ("4:0:0", "4:2:0", "4:2:2", "4:4:4"):
        v[f"restoration-{ss.replace(':', '')}"] = lambda ss=ss: avif_bytes(
            wide(), speed=1, subsampling=ss, advanced={"enable-restoration": "1"})
    v["restoration-sb128"] = lambda: avif_bytes(wide(), speed=2, advanced={
        "enable-restoration": "1", "sb-size": "128"})
    for q in (20, 40, 80):
        v[f"restoration-q{q}"] = lambda q=q: avif_bytes(wide(), speed=0, quality=q)
    # 10 and 12 bits in every layout and range, CDEF and loop restoration on
    v["ten-bit"] = lambda: depth_bytes(ph(), 10)
    v["twelve-bit"] = lambda: depth_bytes(ph(), 12)
    for depth in (10, 12):
        for ss in ("4:0:0", "4:2:0", "4:2:2", "4:4:4"):
            for rng in ("full", "limited"):
                v[f"depth{depth}-{ss.replace(':', '')}-{rng}"] = (
                    lambda d=depth, ss=ss, r=rng: depth_bytes(
                        ph(), d, subsampling=ss, range=r, speed=3, advanced=both))
    v["depth10-restoration"] = lambda: depth_bytes(wide(), 10, speed=1, advanced=both)
    v["depth12-restoration-444"] = lambda: depth_bytes(wide(), 12, speed=1,
                                                       subsampling="4:4:4", advanced=both)
    # superres (denominator 16), with CDEF and loop restoration, in 4:4:4 and 4:0:0
    v["superres"] = superres_bytes
    v["superres-cdef-restoration"] = lambda: superres_bytes(speed=2, advanced=both)
    v["superres-444"] = lambda: superres_bytes(wide(), speed=2, subsampling="4:4:4",
                                               advanced=both)
    v["superres-400"] = lambda: superres_bytes(wide(), subsampling="4:0:0",
                                               advanced={"enable-cdef": "1"})
    # the matrices libavif converts in floating point: FCC, SMPTE 240M,
    # YCgCo, chroma-derived over DCI-P3 (12 over BT.709 and BT.2020 goes
    # through libyuv), YCgCo-Re of 10-bit samples, and 15 (BT.601's Kr, Kb)
    v["matrix-ycgco"] = lambda: patch_nclx(avif_bytes(pg()), matrix=8)
    v["matrix-fcc"] = lambda: patch_nclx(avif_bytes(pg()), matrix=4)
    for ss in ("4:0:0", "4:2:0", "4:2:2", "4:4:4"):
        tag = ss.replace(":", "")
        v[f"matrix-smpte240-{tag}"] = lambda ss=ss: patch_nclx(
            avif_bytes(ph(), subsampling=ss), matrix=7)
        v[f"matrix-derived-p3-{tag}"] = lambda ss=ss: patch_nclx(
            avif_bytes(ph(), subsampling=ss), matrix=12, primaries=12)
    v["matrix-derived-bt709"] = lambda: patch_nclx(avif_bytes(pg()), matrix=12, primaries=1)
    v["matrix-derived-bt2020-limited"] = lambda: patch_nclx(avif_bytes(pg()), matrix=12,
                                                            primaries=9, full=0)
    v["matrix-smpte240-limited"] = lambda: patch_nclx(avif_bytes(ph()), matrix=7, full=0)
    v["matrix-ycgco-re-10bit"] = lambda: patch_nclx(depth_bytes(ph(), 10, subsampling="4:4:4"),
                                                    matrix=16)
    v["matrix-15"] = lambda: patch_nclx(avif_bytes(ph()), matrix=15)
    v["matrix-smpte240-12bit"] = lambda: patch_nclx(depth_bytes(ph(), 12, subsampling="4:2:2"),
                                                    matrix=7)
    return v


def noisy_photo(w: int, h: int, seed: int = 0, sigma: float = 12.0) -> np.ndarray:
    """The photo with seeded sensor noise (per pixel, the same in R, G, B),
    for aom's denoiser to take out and describe as film grain."""
    noise = np.random.default_rng(seed).normal(0, sigma, (h, w, 1))
    return (photo_rgb(w, h, seed=seed).astype(np.float64) + noise).clip(0, 255).astype(np.uint8)


def _part3_variants() -> Dict[str, Callable[[], bytes]]:
    """The files of the decoder's part 3: film grain (aom's film-grain-test
    vectors 1-16, its denoiser, at 10 and 12 bits, in every layout, at odd
    sizes), grid items (cropped edges, 4:2:0 and 4:4:4, an alpha grid),
    avis sequences (with and without an alpha track, a frame libavif
    rescales to tkhd), premultiplied alpha (limited-range alpha too) and
    frames libavif rescales to their item's ispe."""
    ph = lambda seed=4: photo_rgb(*PHOTO, seed=seed)   # noqa: E731
    pg = lambda seed=3: page_rgb(*PAGE, seed=seed)     # noqa: E731
    v: Dict[str, Callable[[], bytes]] = {}
    # PIL decodes what part 2 refused: film grain, a grid, a sequence,
    # premultiplied alpha
    v["film-grain"] = lambda: avif_bytes(ph(), advanced={"film-grain-test": "1"})
    v["grid"] = lambda: grid_bytes(page_rgb(128, 64, seed=8), 1, 2, 64, 64)
    v["avis"] = lambda: sequence_bytes([page_rgb(64, 48, seed=s) for s in (1, 2)])
    v["premultiplied"] = lambda: avif_bytes(_rgba(pg()), alpha_premultiplied=True)
    for t in range(2, 17):
        v[f"grain-test{t}"] = lambda t=t: avif_bytes(ph(), advanced={"film-grain-test": str(t)})
    for level in (10, 40):
        v[f"grain-denoise{level}"] = lambda lv=level: avif_bytes(
            noisy_photo(160, 120, seed=lv), quality=50, advanced={"denoise-noise-level": str(lv)})
    v["grain-depth10"] = lambda: depth_bytes(ph(), 10, advanced={"film-grain-test": "1"})
    v["grain-depth12-444"] = lambda: depth_bytes(ph(), 12, subsampling="4:4:4",
                                                 advanced={"film-grain-test": "10"})
    v["grain-depth10-limited"] = lambda: depth_bytes(ph(), 10, range="limited",
                                                     advanced={"film-grain-test": "16"})
    for ss, t in (("4:0:0", 2), ("4:2:2", 3), ("4:4:4", 6)):
        v[f"grain-{ss.replace(':', '')}"] = lambda ss=ss, t=t: avif_bytes(
            ph(), subsampling=ss, advanced={"film-grain-test": str(t)})
    for (w, h), t in (((67, 45), 8), ((33, 17), 11), ((131, 71), 12)):
        v[f"grain-{w}x{h}"] = lambda w=w, h=h, t=t: avif_bytes(
            photo_rgb(w, h, seed=w), advanced={"film-grain-test": str(t)})
    v["grain-clip"] = lambda: grain_bytes(avif_bytes(ph(), advanced={"film-grain-test": "3"}),
                                          clip=1)
    v["grain-clip-cfl-444"] = lambda: grain_bytes(avif_bytes(
        ph(), subsampling="4:4:4", advanced={"film-grain-test": "15"}), clip=1)
    for lag in (0, 1):
        v[f"grain-lag{lag}"] = lambda lag=lag: grain_bytes(avif_bytes(
            ph(), advanced={"film-grain-test": "2"}), lag=lag)
    v["grain-lag1-422-clip"] = lambda: grain_bytes(avif_bytes(
        ph(), subsampling="4:2:2", advanced={"film-grain-test": "16"}), lag=1, clip=1)
    v["grain-alpha"] = lambda: avif_bytes(_rgba(ph()), advanced={"film-grain-test": "5"})
    # grids: rows x columns of 64 x 64 tiles (libavif's least), the last
    # row and column cropped
    v["grid-1x2"] = lambda: grid_bytes(page_rgb(120, 64, seed=8), 1, 2, 64, 64)
    v["grid-2x2-444"] = lambda: grid_bytes(photo_rgb(100, 120, seed=9), 2, 2, 64, 64,
                                           subsampling="4:4:4")
    v["grid-3x2"] = lambda: grid_bytes(page_rgb(110, 180, seed=10), 3, 2, 64, 64)
    v["grid-2x3-400"] = lambda: grid_bytes(photo_rgb(150, 99, seed=11), 2, 3, 64, 64,
                                           subsampling="4:0:0")
    v["grid-2x2-alpha"] = lambda: grid_bytes(_rgba(page_rgb(126, 100, seed=12)), 2, 2, 64, 64)
    v["grid-2x2-444-alpha-premultiplied"] = lambda: grid_bytes(
        _rgba(photo_rgb(90, 110, seed=13)), 2, 2, 64, 64, subsampling="4:4:4",
        premultiplied=True)
    v["grid-2x2-alpha-per-tile"] = lambda: grid_bytes(_rgba(photo_rgb(100, 80, seed=15)), 2, 2,
                                                      64, 64, alpha_per_tile=True)
    v["grid-grain"] = lambda: grid_bytes(photo_rgb(128, 100, seed=14), 2, 2, 64, 64,
                                         advanced={"film-grain-test": "4"})
    # sequences
    v["sequence"] = lambda: sequence_bytes([pg(1), pg(2)])
    v["sequence-alpha"] = lambda: sequence_bytes([_rgba(ph(1)), _rgba(ph(2))])
    v["sequence-444-three"] = lambda: sequence_bytes([ph(1), ph(2), ph(3)], subsampling="4:4:4")
    # an auxiliary track whose auxi names depth, not alpha: no alpha
    v["sequence-auxi-not-alpha"] = lambda: sequence_bytes([_rgba(ph(1)), _rgba(ph(2))]).replace(
        b"auxiliary:alpha", b"auxiliary:depth")
    v["sequence-tkhd-rescaled"] = lambda: tkhd_bytes(sequence_bytes([ph(1), ph(2)]), 120, 90)
    v["sequence-grain"] = lambda: sequence_bytes([ph(1), ph(2)],
                                                 advanced={"film-grain-test": "7"})
    # premultiplied alpha
    v["premultiplied-444"] = lambda: avif_bytes(_rgba(ph()), subsampling="4:4:4",
                                                alpha_premultiplied=True)
    v["premultiplied-low-alpha"] = lambda: avif_bytes(_low_alpha(ph()), alpha_premultiplied=True)
    v["premultiplied-limited-alpha"] = lambda: limited_alpha_bytes(
        avif_bytes(_low_alpha(ph()), alpha_premultiplied=True))
    v["alpha-limited"] = lambda: limited_alpha_bytes(avif_bytes(_rgba(ph())))
    # ispe rewritten larger and smaller than the frame
    for ss in ("4:0:0", "4:2:0", "4:2:2", "4:4:4"):
        tag = ss.replace(":", "")
        v[f"ispe-larger-{tag}"] = lambda ss=ss: ispe_bytes(
            avif_bytes(ph(), subsampling=ss), 131, 101)
        v[f"ispe-smaller-{tag}"] = lambda ss=ss: ispe_bytes(
            avif_bytes(ph(), subsampling=ss), 61, 47)
    v["ispe-double-420"] = lambda: ispe_bytes(avif_bytes(ph()), 192, 144)
    v["ispe-quarter-444"] = lambda: ispe_bytes(avif_bytes(ph(), subsampling="4:4:4"), 24, 18)
    v["ispe-three-quarters"] = lambda: ispe_bytes(avif_bytes(photo_rgb(128, 96, seed=5)), 96, 72)
    v["ispe-three-eighths"] = lambda: ispe_bytes(avif_bytes(photo_rgb(128, 96, seed=5)), 48, 36)
    v["ispe-depth10-larger"] = lambda: ispe_bytes(depth_bytes(ph(), 10), 120, 90)
    v["ispe-depth10-smaller-444"] = lambda: ispe_bytes(depth_bytes(ph(), 10, subsampling="4:4:4"),
                                                       50, 30)
    v["ispe-premultiplied-limited-alpha"] = lambda: ispe_bytes(limited_alpha_bytes(avif_bytes(
        _low_alpha(ph()), alpha_premultiplied=True)), 61, 47, every=True)
    v["ispe-alpha"] = lambda: ispe_bytes(avif_bytes(_rgba(ph())), 80, 60, every=True)
    return v


def grain_bytes(data: bytes, lag: Optional[int] = None, clip: Optional[int] = None) -> bytes:
    """A still image PIL wrote with film grain (a film-grain-test vector)
    whose film_grain_params() are read, changed (``lag``: ar_coeff_lag, the
    AR coefficients cut or padded with zeros to its count; ``clip``:
    clip_to_restricted_range) and written again, the frame's tile data
    after them, from the next byte."""
    seq = _seq_payload(_to_bits(next(b for _, k, b in _obus(_mdat_payload(data)) if k == 1)))
    f = _seq_fields(seq)
    w, h = (int(seq[18:18 + f["wb"]], 2) + 1, int(seq[18 + f["wb"]:f["tools"]], 2) + 1)
    profile = int(seq[:3], 2)
    mono = profile != 1 and seq[f["high_bitdepth"] + 1] == "1"
    ss420 = profile == 0 and not mono

    def edit(kind, body):
        if kind != 6:
            return body
        bits = _to_bits(body)
        start = pos = _intra_header_bits(bits, seq, w, h)

        def read(n):
            nonlocal pos
            pos += n
            return bits[pos - n:pos]
        assert read(1) == "1", "no film grain"              # apply_grain
        head = read(16)                                      # grain_seed
        ny = read(4)
        head += ny + read(16 * int(ny, 2))
        cfl = "" if mono else read(1)
        head += cfl
        nuv = [0, 0]
        if not (mono or cfl == "1" or (ss420 and int(ny, 2) == 0)):
            for pl in range(2):
                n = read(4)
                nuv[pl] = int(n, 2)
                head += n + read(16 * nuv[pl])
        head += read(2)                                      # grain_scaling_minus_8
        old_lag = int(read(2), 2)
        new_lag = old_lag if lag is None else lag
        counts = []
        if int(ny, 2):
            counts.append(2 * old_lag * (old_lag + 1))
        for pl in range(2):
            if nuv[pl] or cfl == "1":
                counts.append(2 * old_lag * (old_lag + 1) + (1 if int(ny, 2) else 0))
        coeffs = [read(8 * n) for n in counts]
        npos = 2 * new_lag * (new_lag + 1)
        luma = bool(int(ny, 2))
        out_coeffs = []
        for k, c in enumerate(coeffs):
            vals = [c[i:i + 8] for i in range(0, len(c), 8)]
            # a chroma set ends with its luma term, which it keeps
            last = vals[-1:] if luma and k > 0 else []
            out_coeffs.append("".join((vals[:len(vals) - len(last)] + ["10000000"] * npos)[:npos]
                                      + last))
        tail = read(4)                                       # ar_coeff_shift, grain_scale_shift
        for pl in range(2):
            if nuv[pl]:
                tail += read(25)
        tail += read(1)                                      # overlap_flag
        old_clip = read(1)
        new = ("1" + head + f"{new_lag:02b}" + "".join(out_coeffs) + tail
               + (old_clip if clip is None else str(clip)))
        header = bits[:start] + new
        header += "0" * (-len(header) % 8)
        return _to_bytes(header) + body[(pos + 7) // 8:]
    return _edit_obus(data, edit)


def _low_alpha(arr: np.ndarray) -> np.ndarray:
    """An alpha from 0 to 255 across the image (every value, 0 and 255
    included), the colour premultiplied by it as a compositor stores it."""
    h, w = arr.shape[:2]
    alpha = (np.arange(w)[None, :] * 255 // max(w - 1, 1) + np.zeros((h, 1), int)).astype(np.uint8)
    alpha[: h // 4] = 255
    alpha[h // 4: h // 3] = 0
    rgb = (arr.astype(np.int32) * alpha[..., None] + 127) // 255
    return np.dstack([rgb.astype(np.uint8), alpha])


def ispe_bytes(data: bytes, w: int, h: int, every: bool = False) -> bytes:
    """The file with its (first, or ``every``) ispe property saying w x h:
    libavif rescales the frame to it."""
    out = bytearray(data)
    at = out.find(b"ispe")
    while at >= 0:
        struct.pack_into(">II", out, at + 8, w, h)
        at = out.find(b"ispe", at + 4) if every else -1
    return bytes(out)


def tkhd_bytes(data: bytes, w: int, h: int) -> bytes:
    """A sequence with its colour track's tkhd size (16.16) set to w x h:
    libavif rescales the track's frames to it."""
    out = bytearray(data)
    i = out.find(b"tkhd") + 4
    version = out[i]
    at = i + 4 + (32 if version else 20) + 52
    struct.pack_into(">II", out, at, w << 16, h << 16)
    return bytes(out)


def limited_alpha_bytes(data: bytes) -> bytes:
    """A file PIL wrote with alpha whose alpha item's sequence header says
    limited range (one bit flipped in place): libavif brings such alpha to
    full range."""
    from citlab_as_tpu_torch.utils import avif
    info = avif.open_avif(data)
    off, length = info.alpha.extents[0]
    out = bytearray(data)
    obus = _obus(bytes(out[off:off + length]))
    pos = off
    for hdr, kind, body in obus:
        head = 1 + len(_leb128(len(body)))
        if kind == 1:
            bits = _to_bits(body)
            at = _seq_fields(bits)["high_bitdepth"] + 1
            mono = bits[at] == "1"
            assert mono, "an alpha item is monochrome"
            desc = bits[at + 1] == "1"
            rng_at = at + 2 + (24 if desc else 0)
            bits = bits[:rng_at] + "0" + bits[rng_at + 1:]
            out[pos + head:pos + head + len(body)] = _to_bytes(bits)
        pos += head + len(body)
    return bytes(out)


def sequence_bytes(frames, **save) -> bytes:
    """PIL's save_all of the frames: an avis image sequence (an alpha
    track where the frames have alpha)."""
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "AVIF", save_all=True, append_images=ims[1:], duration=100, **save)
    return buf.getvalue()


def avif_small_variants():
    """(file name, write(path)) of every small fixture."""
    def writer(fn):
        def write(path):
            with open(path, "wb") as f:
                f.write(fn())
        return write
    return [(f"avif_{name}.avif", writer(fn)) for name, fn in AVIF_VARIANTS.items()]


# ------------------------------------------------------------------ part 2

def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def _props(data: bytes) -> Dict[bytes, bytes]:
    """The whole property boxes of a single-item file PIL wrote."""
    out = {}
    for kind in (b"ispe", b"pixi", b"av1C", b"colr"):
        i = data.find(kind) - 4
        size = struct.unpack_from(">I", data, i)[0]
        out[kind] = data[i:i + size]
    return out


def _mdat_payload(data: bytes) -> bytes:
    i = data.find(b"mdat") - 4
    size = struct.unpack_from(">I", data, i)[0]
    return data[i + 8:i + size]


def _items(data: bytes):
    """(properties, payload) of each AV1 item of a file PIL wrote, in the
    order of its iinf: the colour item, then the alpha item."""
    from citlab_as_tpu_torch.utils import avif
    meta = avif._parse_file(data)[0]
    out = []
    for item_id in meta.order:
        item = meta.items[item_id]
        if item.type != b"av01":
            continue
        out.append((item, avif._item_data(meta, item, data)))
    return out


def _prop_boxes(data: bytes, item) -> Dict[bytes, bytes]:
    """The whole property boxes of ``item`` (a file PIL wrote), by type."""
    meta = _box_path(data, [b"meta"])
    iprp = _box_path(data, [b"iprp"], meta[0] + 4, meta[1])
    ipco = _box_path(data, [b"ipco"], *iprp)
    ipma = _box_path(data, [b"ipma"], *iprp)
    boxes, pos = [], ipco[0]
    while pos < ipco[1]:
        size = struct.unpack_from(">I", data, pos)[0]
        boxes.append(data[pos:pos + size])
        pos += size
    p = ipma[0] + 8
    out = {}
    for _ in range(struct.unpack_from(">I", data, ipma[0] + 4)[0]):
        item_id, n = struct.unpack_from(">HB", data, p)
        idx = data[p + 3:p + 3 + n]
        if item_id == item.id:
            for i in idx:
                box = boxes[(i & 0x7F) - 1]
                out[box[4:8]] = box
        p += 3 + n
    return out


def grid_bytes(arr: np.ndarray, rows: int, cols: int, tile_w: int, tile_h: int,
               premultiplied: bool = False, alpha_per_tile: bool = False, **save) -> bytes:
    """``arr`` (h x w x 3 or 4) as a ``grid`` item of rows x cols tiles of
    tile_w x tile_h, each tile written by PIL (``save`` passed on), the
    last row and column cropped to the image (its edge pixels repeated in
    the tile); with alpha, an alpha grid of the tiles' alpha items, the
    colour marked premultiplied by it where asked (``alpha_per_tile``: no
    alpha grid item, each alpha item auxiliary to its colour tile)."""
    h, w = arr.shape[:2]
    padded = np.pad(arr, ((0, rows * tile_h - h), (0, cols * tile_w - w), (0, 0)), mode="edge")
    tiles = [avif_bytes(np.ascontiguousarray(
        padded[r * tile_h:(r + 1) * tile_h, c * tile_w:(c + 1) * tile_w]),
        alpha_premultiplied=premultiplied, **save) for r in range(rows) for c in range(cols)]
    items = [_items(t) for t in tiles]
    n = rows * cols
    alpha = arr.shape[2] == 4
    color_props = _prop_boxes(tiles[0], items[0][0][0])
    grid_payload = struct.pack(">BBBBHH", 0, 0, rows - 1, cols - 1, w, h)
    ispe_grid = _full(b"ispe", 0, 0, struct.pack(">II", w, h))
    boxes = [color_props[b"ispe"], color_props[b"pixi"], color_props[b"av1C"],
             color_props[b"colr"], ispe_grid]
    ipma = [(1, [5, 4])] + [(2 + k, [1, 2, 0x83]) for k in range(n)]
    infe = [(1, b"grid")] + [(2 + k, b"av01") for k in range(n)]
    refs = [_box(b"dimg", struct.pack(">HH", 1, n) + b"".join(
        struct.pack(">H", 2 + k) for k in range(n)))]
    payloads = [grid_payload] + [it[0][1] for it in items]
    idat = [True] + [False] * n
    if alpha:
        alpha_props = _prop_boxes(tiles[0], items[0][1][0])
        boxes += [alpha_props[b"pixi"], alpha_props[b"av1C"], alpha_props[b"auxC"]]
        ga = 2 + n
        if alpha_per_tile:
            ipma += [(ga + 1 + k, [1, 6, 0x87, 8]) for k in range(n)]
            infe += [(ga + 1 + k, b"av01") for k in range(n)]
            refs += [_box(b"auxl", struct.pack(">HHH", ga + 1 + k, 1, 2 + k)) for k in range(n)]
            payloads += [it[1][1] for it in items]
            idat += [False] * n
        else:
            ipma += [(ga, [5, 8])] + [(ga + 1 + k, [1, 6, 0x87]) for k in range(n)]
            infe += [(ga, b"grid")] + [(ga + 1 + k, b"av01") for k in range(n)]
            refs += [_box(b"auxl", struct.pack(">HHH", ga, 1, 1)),
                     _box(b"dimg", struct.pack(">HH", ga, n) + b"".join(
                         struct.pack(">H", ga + 1 + k) for k in range(n)))]
            if premultiplied:
                refs.append(_box(b"prem", struct.pack(">HHH", 1, 1, ga)))
            payloads += [grid_payload] + [it[1][1] for it in items]
            idat += [True] + [False] * n
    ipco = _box(b"ipco", b"".join(boxes))
    ipma_box = _full(b"ipma", 0, 0, struct.pack(">I", len(ipma)) + b"".join(
        struct.pack(">HB", i, len(ix)) + bytes(ix) for i, ix in ipma))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(infe)) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i, 0) + kind + b"\0") for i, kind in infe))
    iref = _full(b"iref", 0, 0, b"".join(refs))
    hdlr = _full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    idat_bytes = b"".join(p for p, i in zip(payloads, idat) if i)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")

    def meta(mdat_start):
        entries, idat_off, mdat_off = [], 0, mdat_start
        for (item_id, _), p, in_idat in zip(infe, payloads, idat):
            if in_idat:
                entries.append(struct.pack(">HHHH", item_id, 1, 0, 1)
                               + struct.pack(">II", idat_off, len(p)))
                idat_off += len(p)
            else:
                entries.append(struct.pack(">HHHH", item_id, 0, 0, 1)
                               + struct.pack(">II", mdat_off, len(p)))
                mdat_off += len(p)
        iloc = _full(b"iloc", 1, 0, bytes([0x44, 0x00]) + struct.pack(">H", len(entries))
                     + b"".join(entries))
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref
                     + _box(b"iprp", ipco + ipma_box) + _box(b"idat", idat_bytes))
    head = len(ftyp) + len(meta(0)) + 8
    media = b"".join(p for p, i in zip(payloads, idat) if not i)
    return ftyp + meta(head) + _box(b"mdat", media)


# ---------------------------------------------------------------- OBU edits
# A still image PIL writes is one item whose extent is the whole ``mdat``
# payload: a temporal delimiter, a sequence header OBU (the reduced
# still-picture header) and a frame OBU, each with its size field.

def _to_bits(b: bytes) -> str:
    return "".join(f"{x:08b}" for x in b)


def _to_bytes(bits: str) -> bytes:
    assert len(bits) % 8 == 0
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n >> 7 else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _obus(payload: bytes):
    """[(header byte, OBU type, body)] of OBUs that carry their size."""
    out, i = [], 0
    while i < len(payload):
        hdr = payload[i]
        assert hdr & 2 and not hdr & 4, "an OBU without its size, or with an extension"
        size, n = 0, 0
        while True:
            b = payload[i + 1 + n]
            size |= (b & 0x7F) << (7 * n)
            n += 1
            if not b & 0x80:
                break
        body = payload[i + 1 + n:i + 1 + n + size]
        out.append((hdr, (hdr >> 3) & 15, body))
        i += 1 + n + size
    return out


def _edit_obus(data: bytes, edit: Callable[[int, bytes], bytes]) -> bytes:
    """The file with each OBU's body replaced by ``edit(type, body)``, its
    size field, the ``mdat`` box and the item's ``iloc`` extent length
    (version 0, 4-byte offsets and lengths) made to match."""
    i = data.find(b"mdat") - 4
    size = struct.unpack_from(">I", data, i)[0]
    old = data[i + 8:i + size]
    new = b"".join(bytes([hdr]) + _leb128(len(b)) + b
                   for hdr, kind, b in ((h, k, edit(k, body)) for h, k, body in _obus(old)))
    out = bytearray(data[:i] + _box(b"mdat", new) + data[i + size:])
    j = out.find(b"iloc") + 4
    assert out[j] == 0 and out[j + 4] == 0x44 and out[j + 5] == 0, "not a version 0 iloc"
    at = j + 4 + 2 + 2 + 2 + 2 + 2 + 4
    assert struct.unpack_from(">I", out, at)[0] == len(old)
    struct.pack_into(">I", out, at, len(new))
    return bytes(out)


def _seq_payload(bits: str) -> str:
    """A sequence header's bits without its trailing bits."""
    body = bits.rstrip("0")
    assert body.endswith("1")
    return body[:-1]


def _trailing(bits: str) -> str:
    """``bits`` with the OBU's trailing bits: a one, then zeros to a byte."""
    bits += "1"
    return bits + "0" * (-len(bits) % 8)


def _seq_fields(bits: str) -> Dict[str, int]:
    """The bit positions of a reduced still-picture sequence header:
    profile(3) still(1) reduced(1) level(5) wbits(4) hbits(4) w(wbits)
    h(hbits) sb128 filter_intra edge_filter superres cdef restoration, then
    the colour config from high_bitdepth."""
    assert bits[4] == "1", "not a reduced still-picture header"
    wb, hb = int(bits[10:14], 2) + 1, int(bits[14:18], 2) + 1
    tools = 18 + wb + hb
    return {"wb": wb, "hb": hb, "tools": tools, "superres": tools + 3,
            "high_bitdepth": tools + 6}


def _with_frame_size(bits: str, w: int, h: int) -> str:
    """Sequence header bits whose frame size fields say w x h."""
    f = _seq_fields(bits)
    wb, hb = max(f["wb"], (w - 1).bit_length()), max(f["hb"], (h - 1).bit_length())
    return (bits[:10] + f"{wb - 1:04b}{hb - 1:04b}" + f"{w - 1:0{wb}b}" + f"{h - 1:0{hb}b}"
            + bits[f["tools"]:])


def _edit_seq(data: bytes, edit: Callable[[str], str]) -> bytes:
    return _edit_obus(data, lambda kind, body: _to_bytes(_trailing(edit(_seq_payload(
        _to_bits(body))))) if kind == 1 else body)


def _set_depth(data: bytes, depth: int) -> bytes:
    """``av1C``'s profile and depth bits and ``pixi``'s depths set to
    ``depth`` (profile 2 for 12 bits)."""
    d = bytearray(data)
    i = d.find(b"av1C") + 4
    if depth == 12:
        d[i + 1] = (2 << 5) | (d[i + 1] & 31)
    d[i + 2] = (d[i + 2] & ~0x60) | (0x40 if depth > 8 else 0) | (0x20 if depth == 12 else 0)
    j = d.find(b"pixi") + 8
    d[j + 1:j + 1 + d[j]] = bytes([depth] * d[j])
    return bytes(d)


def _with_depth(bits: str, depth: int) -> str:
    """The bits of a reduced still-picture sequence header PIL wrote (8-bit,
    any layout, not the sRGB special case) with its colour config set to
    ``depth`` bits and the layout kept: at 10 bits high_bitdepth is set
    (profiles 0, 1 and 2 each keep their layout; profile 2 then reads
    twelve_bit, 0); at 12 bits the profile is
    2, with twelve_bit, the mono_chrome bit profile 1 lacks and the
    subsampling bits profile 2 reads at 12 bits."""
    at = _seq_fields(bits)["high_bitdepth"]
    assert bits[at] == "0", "not an 8-bit header"
    profile = int(bits[:3], 2)
    if depth == 10:                                      # profile 2 reads twelve_bit = 0
        return bits[:at] + ("10" if profile == 2 else "1") + bits[at + 1:]
    pos = at + 1
    mono = profile != 1 and bits[pos] == "1"
    if profile != 1:
        pos += 1
    desc = bits[pos] == "1"
    end = pos + 1 + (24 if desc else 0) + 1             # the description and color_range
    ss = "" if mono else {0: "11", 1: "0", 2: "10"}[profile]
    return ("010" + bits[3:at] + "11" + ("1" if mono else "0") + bits[pos:end] + ss
            + bits[end:])


def depth_bytes(arr: np.ndarray, depth: int, **save) -> bytes:
    """A file PIL wrote (8-bit: PIL's aom is built without high bit depth)
    rewritten to a ``depth``-bit stream of the same layout: the sequence
    header's colour config, av1C and pixi. The tile data is the 8-bit
    encoder's, read at ``depth`` bits: prediction, dequantisation, CDEF,
    loop restoration and the conversion run at that depth."""
    data = avif_bytes(arr, **save)
    return _set_depth(_edit_seq(data, lambda bits: _with_depth(bits, depth)), depth)


def huge_frame_bytes(w: int = 65536, h: int = 65536) -> bytes:
    """A file PIL wrote whose sequence header's frame size fields say w x h
    (16 bits each at most): past dav1d's frame size limit, which libavif
    sets to 16384 x 16384 pixels, at the default size."""
    return _edit_seq(avif_bytes(page_rgb(64, 48, seed=2)), lambda b: _with_frame_size(b, w, h))


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _intra_header_bits(bits: str, seq: str, w: int, h: int) -> int:
    """The length of the uncompressed header, in bits, of the key frame of a
    reduced still picture (w x h) that PIL wrote without screen content
    tools or segmentation."""
    f = _seq_fields(seq)
    t = f["tools"]
    sb128, superres, cdef, lr = (int(seq[t + k]) for k in (0, 3, 4, 5))
    assert not superres
    pos = 0

    def read(n):
        nonlocal pos
        pos += n
        return int(bits[pos - n:pos], 2) if n else 0
    read(1)                                              # disable_cdf_update
    assert read(1) == 0, "screen content tools"
    if read(1):                                          # render_and_frame_size_different
        read(32)
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    sb_shift = 5 if sb128 else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    min_cols = _tile_log2(4096 >> sb_size, sb_cols)
    max_cols = _tile_log2(1, min(sb_cols, 64))
    max_rows = _tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, _tile_log2((4096 * 2304) >> (2 * sb_size), sb_rows * sb_cols))
    assert read(1) == 1, "explicit tile sizes"
    cols = min_cols
    while cols < max_cols and read(1):
        cols += 1
    rows = max(min_tiles - cols, 0)
    while rows < max_rows and read(1):
        rows += 1
    if cols or rows:
        read(cols + rows + 2)                            # context_update_tile_id, tile size bytes
    mono = seq[f["high_bitdepth"] + 1] == "1"
    base_q = read(8)
    deltas = []

    def delta_q():
        deltas.append(read(7) if read(1) else 0)
    delta_q()
    separate_uv = seq.rstrip("0")[-3] == "1"   # separate_uv_delta_q, then film grain, then 1
    if not mono:
        diff_uv = read(1) if separate_uv else 0
        delta_q()
        delta_q()
        if diff_uv:
            delta_q()
            delta_q()
    if read(1):                                          # using_qmatrix
        read(8 if separate_uv else 4) if not mono else read(4)
    assert read(1) == 0, "segmentation"
    if base_q > 0 and read(1):                           # delta_q_present
        read(2)
        if read(1):                                      # delta_lf_present
            read(3)
    lossless = base_q == 0 and not any(deltas)
    if not lossless:
        l0, l1 = read(6), read(6)
        if not mono and (l0 or l1):
            read(12)
        read(3)                                          # sharpness
        if read(1) and read(1):                          # mode ref delta enabled, update
            for _ in range(10):
                if read(1):
                    read(7)
    if cdef and not lossless:
        read(2)                                          # cdef_damping_minus_3
        for _ in range(1 << read(2)):                    # cdef_bits
            read(6 if mono else 12)                      # y (and uv) strengths
    if lr and not lossless:
        types = [read(2) for _ in range(1 if mono else 3)]
        if any(types):
            if read(1) and not sb128:                    # lr_unit_shift
                read(1)                                  # lr_unit_extra_shift
            if not mono and any(types[1:]) and int(seq[:3], 2) == 0:
                read(1)                                  # lr_uv_shift (4:2:0)
    if not lossless:
        read(1)                                          # tx_mode_select
    read(1)                                              # reduced_tx_set
    return pos


def superres_bytes(full: Optional[np.ndarray] = None, **save) -> bytes:
    """An image (by default the 96 x 72 photo; an even width) coded as AV1
    superres codes it: PIL wrote it at half its width (``save`` passed on),
    then the sequence header says the full width with enable_superres, the
    frame header use_superres with the denominator 16 (coded width (w * 8 +
    8) // 16 = w / 2), and ispe the full size. dav1d decodes it and upscales
    it to the full width. With loop restoration on, the units are counted
    on the upscaled width, so the tile data is read past what the encoder
    meant: the stream stays one that dav1d decodes."""
    full = photo_rgb(*PHOTO, seed=4) if full is None else full
    half = ((full[:, 0::2].astype(np.int32) + full[:, 1::2]) // 2).astype(np.uint8)
    w, h = half.shape[1], half.shape[0]
    data = avif_bytes(np.ascontiguousarray(half), **save)
    seq = _seq_payload(_to_bits(next(b for _, k, b in _obus(_mdat_payload(data)) if k == 1)))

    def edit(kind, body):
        bits = _to_bits(body)
        if kind == 1:
            new = _with_frame_size(seq, 2 * w, h)
            at = _seq_fields(new)["superres"]
            return _to_bytes(_trailing(new[:at] + "1" + new[at + 1:]))
        if kind != 6:
            return body
        end = _intra_header_bits(bits, seq, w, h)
        assert "1" not in bits[end:-end % 8 + end], "frame header parsed to a wrong length"
        head = bits[:2] + "1" + "111" + bits[2:end]      # use_superres, coded_denom 7
        return _to_bytes(head + "0" * (-len(head) % 8)) + body[(end + 7) // 8:]
    i = data.find(b"ispe") + 8
    return _edit_obus(data[:i] + struct.pack(">II", 2 * w, h) + data[i + 8:], edit)


def _box_path(data: bytes, path, off: int = 0, end=None):
    """(payload start, end) of the box at ``path`` (plain boxes only)."""
    end = len(data) if end is None else end
    while off + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, off)
        if kind == path[0]:
            if len(path) == 1:
                return off + 8, off + size
            return _box_path(data, path[1:], off + 8, off + size)
        off += size
    raise KeyError(path[0])


def sequence_key_frame(arr: np.ndarray, **save) -> bytes:
    """The OBUs of the first sample of a two-frame ``avis`` sequence PIL
    wrote: a key frame under a full sequence header (not the reduced one of
    a still image), CDEF and loop restoration off."""
    frames = [Image.fromarray(arr), Image.fromarray(arr[::-1].copy())]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], duration=100,
                   advanced={"enable-cdef": "0", "enable-restoration": "0"}, **save)
    data = buf.getvalue()
    stbl = [b"moov", b"trak", b"mdia", b"minf", b"stbl"]
    stsz = _box_path(data, stbl + [b"stsz"])[0]
    size = struct.unpack_from(">I", data, stsz + 4)[0] or struct.unpack_from(">I", data,
                                                                            stsz + 12)[0]
    offset = struct.unpack_from(">I", data, _box_path(data, stbl + [b"stco"])[0] + 8)[0]
    return data[offset:offset + size]


AVIF_VARIANTS = _variants()


# ------------------------------------------------------------------ faults

def _replace(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.find(old)
    assert i >= 0, old
    return data[:i] + new + data[i + len(old):]


def _faults() -> Dict[str, Callable[[], bytes]]:
    base = lambda: avif_bytes(page_rgb(64, 48, seed=2))  # noqa: E731

    def iloc_past_end():
        d = bytearray(base())
        i = d.find(b"iloc") + 4
        # version 0: 4 bytes version/flags, 2 sizes, count, then item 1's
        # extent offset (4) and length (4): push the offset past the end
        struct.pack_into(">I", d, i + 4 + 2 + 2 + 2 + 2 + 2, len(d) + 100)
        return bytes(d)

    def pixi_mismatch():
        return _replace(base(), b"pixi\0\0\0\0\x03\x08\x08\x08", b"pixi\0\0\0\0\x03\x08\x0a\x08")

    return {
        "brand-mif1-only": lambda: _replace(base(), b"avif\0\0\0\0avifmif1",
                                            b"mif1\0\0\0\0mif1mif1"),
        "hdlr-not-pict": lambda: _replace(base(), b"pict", b"vide"),
        "no-ispe": lambda: _replace(base(), b"ispe", b"xspe"),
        "no-av1C": lambda: _replace(base(), b"av1C", b"xv1C"),
        "av1C-bad-marker": lambda: _replace(base(), b"av1C\x81", b"av1C\x01"),
        "pixi-mismatch": pixi_mismatch,
        "iloc-past-end": iloc_past_end,
        "iinf-not-infe": lambda: _replace(base(), b"infe", b"infx"),
        "no-pitm-item": lambda: _replace(base(), b"pitm\0\0\0\0\0\x01", b"pitm\0\0\0\0\0\x07"),
        "meta-version1": lambda: _replace(base(), b"meta\0", b"meta\x01"),
        "truncated-meta": lambda: base()[:150],
        "truncated-mdat": lambda: base()[:-40],
        "av1-garbage": lambda: base()[:-60] + bytes(60),
        # the identity matrix needs chroma as large as luma
        "identity-420": lambda: patch_nclx(base(), matrix=0),
        "identity-422": lambda: patch_nclx(avif_bytes(page_rgb(64, 48, seed=2),
                                                      subsampling="4:2:2"), matrix=0),
    }


AVIF_FAULTS = _faults()


# ------------------------------------------------------------------ pages

def avif_pages(pages, tint):
    """The nine full-size AVIF pages of the variants phase: (name, bytes,
    index of the generator's page it shows). The generator's pages cleaned
    of their scan noise (ink and paper at two levels, as a born-digital
    page) and tinted: at PIL's defaults (palette and IntraBC), at speed 8
    (palette, no IntraBC), and as a scanned copy (blurred twice, with
    uneven paper shading: no screen content, so the frame is deblocked) at
    quality 50; the scanned copy again at speed 4 with CDEF on (loop
    restoration and CDEF over the whole page), and coded at half its width
    with a superres denominator of 16 (upscaled to the full width). Then
    part 3's: the scanned copy with seeded sensor noise, coded at quality 50
    with aom's denoiser, which sends the noise as film grain (luma and
    chroma points, an AR lag of 3, overlapped blocks); the scanned copy as a
    4 x 3 grid of 512 x 512 tiles at quality 50 (the last column and row
    cropped to 2000 x 1420); PIL's save_all of the defaults page followed by
    the speed-8 page (an avis sequence: its first frame is the page); and
    the speed-8 page with alpha (opaque, a band of falling alpha over its
    right third), its colour premultiplied by the alpha as a compositor
    stores it."""
    clean = [tint(np.where(p < 128, 40, 248).astype(np.uint8)) for p in pages[:3]]
    scan = clean[2].astype(np.float32)
    for _ in range(2):
        scan = (scan + np.roll(scan, 1, 0) + np.roll(scan, 1, 1)
                + np.roll(scan, (1, 1), (0, 1))) / 4
    h, w = scan.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    scan += (10 * np.sin(xx / 170.0) * np.cos(yy / 230.0) - 8 * (yy / h))[..., None]
    scan = scan.clip(0, 255).astype(np.uint8)
    noise = np.random.default_rng(21).normal(0, 10, (h, w, 1))
    noisy = (scan.astype(np.float64) + noise).clip(0, 255).astype(np.uint8)
    alpha = np.full((h, w), 255, np.uint8)
    band = np.arange(w - 2 * w // 3)
    alpha[:, 2 * w // 3:] = (255 - band * 127 // max(len(band) - 1, 1)).astype(np.uint8)
    premultiplied = (clean[1].astype(np.int32) * alpha[..., None] + 127) // 255
    return [("defaults.avif", avif_bytes(clean[0]), 0),
            ("speed8.avif", avif_bytes(clean[1], speed=8), 1),
            ("scan.avif", avif_bytes(scan, quality=50), 2),
            ("restored.avif", avif_bytes(scan, quality=50, speed=4,
                                         advanced={"enable-cdef": "1"}), 2),
            ("superres.avif", superres_bytes(scan, quality=50), 2),
            ("grain.avif", avif_bytes(noisy, quality=50,
                                      advanced={"denoise-noise-level": "25"}), 2),
            ("grid.avif", grid_bytes(scan, 4, 3, 512, 512, quality=50), 2),
            ("sequence.avif", sequence_bytes([clean[0], clean[1]]), 0),
            ("premultiplied.avif", avif_bytes(np.dstack([premultiplied.astype(np.uint8), alpha]),
                                              alpha_premultiplied=True), 1)]
