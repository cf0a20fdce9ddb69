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
- ``AVIF_REFUSED``: files whose decoding needs a tool of part 3 (film
  grain, a ``grid`` item, an ``avis`` sequence, premultiplied alpha):
  ``(bytes, the word the port's refusal names)``.
- ``AVIF_FAULTS``: container faults PIL refuses (a brand, a missing or
  malformed box, an extent past the file's end, a truncated file, the
  identity matrix over subsampled chroma);
  ``huge_frame_bytes``: a frame past dav1d's size limit.
- ``avif_pages``: the full-size pages of ``chip_smoke.py``'s variants
  phase (``tests/data/torch_formats_avif/``).
"""
from __future__ import annotations

import io
import struct
from typing import Callable, Dict, Optional, Tuple

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
    # photo (AVIF_REFUSED)
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


def grid_bytes() -> bytes:
    """A 2 x 1 ``grid`` item over two 64 x 64 AV1 tiles that PIL wrote (PIL
    decodes it; its output is 128 x 64)."""
    a = page_rgb(128, 64, seed=8)
    tiles = [avif_bytes(np.ascontiguousarray(a[:, :64])), avif_bytes(np.ascontiguousarray(
        a[:, 64:]))]
    props = _props(tiles[0])
    payloads = [_mdat_payload(t) for t in tiles]
    grid = struct.pack(">BBBBHH", 0, 0, 0, 1, 128, 64)   # 1 row, 2 columns, 16-bit size
    ispe_full = _full(b"ispe", 0, 0, struct.pack(">II", 128, 64))
    ipco = _box(b"ipco", props[b"ispe"] + props[b"pixi"] + props[b"av1C"] + props[b"colr"]
                + ispe_full)
    # items: 1 grid (ispe 5, colr 4), 2 and 3 tiles (ispe 1, pixi 2, av1C 3 essential)
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", 3)
                 + struct.pack(">HB", 1, 2) + bytes([5, 4])
                 + struct.pack(">HB", 2, 3) + bytes([1, 2, 0x83])
                 + struct.pack(">HB", 3, 3) + bytes([1, 2, 0x83]))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 3) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i, 0) + kind + b"\0")
        for i, kind in ((1, b"grid"), (2, b"av01"), (3, b"av01"))))
    iref = _full(b"iref", 0, 0, _box(b"dimg", struct.pack(">HHHH", 1, 2, 2, 3)))
    hdlr = _full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    idat = _box(b"idat", grid)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")

    def meta(offsets):
        iloc = _full(b"iloc", 1, 0, bytes([0x44, 0x00]) + struct.pack(">H", 3)
                     + struct.pack(">HHHH", 1, 1, 0, 1) + struct.pack(">II", 0, len(grid))
                     + b"".join(struct.pack(">HHHH", i + 2, 0, 0, 1)
                                + struct.pack(">II", off, len(p))
                                for i, (off, p) in enumerate(zip(offsets, payloads))))
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref
                     + _box(b"iprp", ipco + ipma) + idat)
    head = len(ftyp) + len(meta([0, 0])) + 8
    offsets = [head, head + len(payloads[0])]
    return ftyp + meta(offsets) + _box(b"mdat", b"".join(payloads))


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


def _refused() -> Dict[str, Tuple[Callable[[], bytes], str]]:
    pg = lambda: page_rgb(*PAGE, seed=3)      # noqa: E731
    ph = lambda: photo_rgb(*PHOTO, seed=4)    # noqa: E731
    return {
        "film-grain": (lambda: avif_bytes(ph(), advanced={"film-grain-test": "1"}),
                       "film grain"),
        "grid": (grid_bytes, "grid"),
        "avis": (lambda: _sequence(), "avis"),
        "premultiplied": (lambda: avif_bytes(_rgba(pg()), alpha_premultiplied=True),
                          "premultiplied"),
    }


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


def _sequence() -> bytes:
    frames = [Image.fromarray(page_rgb(64, 48, seed=s)) for s in (1, 2)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], duration=100)
    return buf.getvalue()


AVIF_VARIANTS = _variants()
AVIF_REFUSED = _refused()


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
    """The five full-size AVIF pages of the variants phase: (name, bytes).
    The generator's pages cleaned of their scan noise (ink and paper at two
    levels, as a born-digital page) and tinted: at PIL's defaults (palette
    and IntraBC), at speed 8 (palette, no IntraBC), and as a scanned copy
    (blurred twice, with uneven paper shading: no screen content, so the
    frame is deblocked) at quality 50; the scanned copy again at speed 4
    with CDEF on (loop restoration and CDEF over the whole page), and coded
    at half its width with a superres denominator of 16 (upscaled to the
    full width)."""
    clean = [tint(np.where(p < 128, 40, 248).astype(np.uint8)) for p in pages[:3]]
    scan = clean[2].astype(np.float32)
    for _ in range(2):
        scan = (scan + np.roll(scan, 1, 0) + np.roll(scan, 1, 1)
                + np.roll(scan, (1, 1), (0, 1))) / 4
    h, w = scan.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    scan += (10 * np.sin(xx / 170.0) * np.cos(yy / 230.0) - 8 * (yy / h))[..., None]
    scan = scan.clip(0, 255).astype(np.uint8)
    return [("defaults.avif", avif_bytes(clean[0])),
            ("speed8.avif", avif_bytes(clean[1], speed=8)),
            ("scan.avif", avif_bytes(scan, quality=50)),
            ("restored.avif", avif_bytes(scan, quality=50, speed=4,
                                         advanced={"enable-cdef": "1"})),
            ("superres.avif", superres_bytes(scan, quality=50))]
