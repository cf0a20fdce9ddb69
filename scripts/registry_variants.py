"""Test encoders of the formats of PIL's registry that the port decodes in
``utils/textures.py`` (DDS, BLP, FTEX) and ``utils/registry_formats.py``
(ICNS, PCD, FITS, FLI, IPTC), and their catalog:
``tests/test_torch_formats_textures.py`` and
``tests/test_torch_formats_registry_rest.py`` hold the port to PIL on every
variant, ``scripts/make_format_fixtures.py --only registry`` writes each
as a small fixture with PIL's digests, and ``scripts/fuzz_textures.py``
damages them.

Everything is written byte by byte from numpy arrays of a seed, except the
files PIL's own writers make (DDS in DXT1 / DXT3 / DXT5, BC2 / BC3 / BC5 and
the uncompressed L, LA, RGB and RGBA layouts, BLP palette images, ICNS),
which need PIL. Random bytes are valid BC1-BC7 blocks, so a texture is
random blocks with the mode bits of the block kind under test. Nothing here
is imported by the port.
"""
from __future__ import annotations

import io
import struct

import numpy as np

# ------------------------------------------------------------------ DDS

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PAL8, DDPF_RGB, DDPF_LUMINANCE = (
    0x1, 0x4, 0x20, 0x40, 0x20000)


def dds_bytes(w, h, pfflags, body, fourcc=b"\0\0\0\0", bitcount=0, masks=(0, 0, 0, 0),
              dxgi=None, header_size=124):
    """A DDS file: the 128-byte header (and the DX10 header's 20 bytes when
    ``dxgi`` is given) before ``body``."""
    flags = 0x1 | 0x2 | 0x4 | 0x1000
    head = b"DDS " + struct.pack("<7I", header_size, flags, h, w, 0, 0, 0) + bytes(44)
    head += struct.pack("<I", 32) + struct.pack("<I", pfflags) + fourcc + struct.pack(
        "<I", bitcount) + struct.pack("<4I", *(tuple(masks) + (0,) * 4)[:4]) + struct.pack(
        "<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def bc_blocks(kind, w, h, seed, mode=None):
    """Random blocks of BC<kind> for a w x h image; for BC6H and BC7 every
    block in ``mode`` (None: random modes)."""
    r = np.random.RandomState(seed)
    n = ((w + 3) // 4) * ((h + 3) // 4)
    size = 8 if kind in (1, 4) else 16
    blocks = r.randint(0, 256, (n, size)).astype(np.uint8)
    if kind == 7 and mode is not None:
        low = (1 << mode)
        blocks[:, 0] = (blocks[:, 0] & ~np.uint8((low << 1) - 1)) | np.uint8(low)
    if kind == 6 and mode is not None:
        code = mode if mode < 2 else ((mode - 2) << 2 | 2 if mode < 10 else (mode - 10) << 2 | 3)
        bits = 2 if mode < 2 else 5
        blocks[:, 0] = (blocks[:, 0] & ~np.uint8((1 << bits) - 1)) | np.uint8(code)
    if kind == 1 and mode is not None:
        # mode 0: four colours (c0 > c1), mode 1: three and transparent black
        c = blocks[:, :4].copy().view("<u2")
        lo, hi = np.minimum(c[:, 0], c[:, 1]), np.maximum(c[:, 0], c[:, 1])
        hi = np.where(hi == lo, np.minimum(hi + 1, 0xFFFF), hi)
        c[:, 0], c[:, 1] = (hi, lo) if mode == 0 else (lo, hi)
        blocks[:, :4] = c.view(np.uint8).reshape(-1, 4)
    return blocks.tobytes()


def dds_fourcc(fourcc, kind, w, h, seed, mode=None):
    return dds_bytes(w, h, DDPF_FOURCC, bc_blocks(kind, w, h, seed, mode), fourcc=fourcc)


def dds_dx10(dxgi, kind, w, h, seed, mode=None):
    body = (bc_blocks(kind, w, h, seed, mode) if kind else
            np.random.RandomState(seed).randint(0, 256, w * h * 4).astype(np.uint8).tobytes())
    return dds_bytes(w, h, DDPF_FOURCC, body, fourcc=b"DX10", dxgi=dxgi)


def dds_rgb(w, h, bitcount, masks, seed, alpha=False, short=0):
    n = w * h * (bitcount // 8)
    body = np.random.RandomState(seed).randint(0, 256, n).astype(np.uint8).tobytes()
    return dds_bytes(w, h, DDPF_RGB | (DDPF_ALPHAPIXELS if alpha else 0),
                     body[:len(body) - short], bitcount=bitcount, masks=masks)


def dds_luminance(w, h, alpha, seed):
    ch = 2 if alpha else 1
    body = np.random.RandomState(seed).randint(0, 256, w * h * ch).astype(np.uint8).tobytes()
    return dds_bytes(w, h, DDPF_LUMINANCE | (DDPF_ALPHAPIXELS if alpha else 0), body,
                     bitcount=8 * ch)


def dds_palette(w, h, seed):
    r = np.random.RandomState(seed)
    palette = r.randint(0, 256, 1024).astype(np.uint8).tobytes()
    return dds_bytes(w, h, DDPF_PAL8, palette + r.randint(0, 256, w * h).astype(
        np.uint8).tobytes(), bitcount=8)


def pil_dds(w, h, mode, pixel_format, seed):
    """A DDS file PIL's writer makes of seeded pixels (needs PIL)."""
    from PIL import Image
    r = np.random.RandomState(seed)
    px = r.randint(0, 256, (h, w, len(mode))).astype(np.uint8)
    im = Image.fromarray(px[..., 0] if mode == "L" else px, mode)
    out = io.BytesIO()
    im.save(out, "DDS", **({"pixel_format": pixel_format} if pixel_format else {}))
    return out.getvalue()


# ------------------------------------------------------------------ FTEX

def ftex_bytes(w, h, fmt, body, where=32, format_count=1):
    head = b"FTEX" + struct.pack("<i2i2i", 1, w, h, 1, format_count) + struct.pack(
        "<2i", fmt, where)
    head = head.ljust(where, b"\0")
    return head + struct.pack("<i", len(body)) + body


# ------------------------------------------------------------------ BLP

def blp2_bytes(w, h, encoding, alpha_depth, alpha_encoding, body, palette=None, seed=0):
    """A BLP2 file: header, the 16 mipmap offsets and lengths (the first
    mipmap only), the 256-entry BGRA palette, the first mipmap."""
    r = np.random.RandomState(seed)
    if palette is None:
        palette = r.randint(0, 256, 1024).astype(np.uint8).tobytes()
    start = 20 + 128 + len(palette)
    head = b"BLP2" + struct.pack("<i", 1) + struct.pack("<bbbb", encoding, alpha_depth,
                                                        alpha_encoding, 0)
    head += struct.pack("<II", w, h)
    head += struct.pack("<16I", start, *([0] * 15)) + struct.pack("<16I", len(body), *([0] * 15))
    return head + palette + body


def blp1_palette_bytes(w, h, alpha, seed, encoding=4):
    r = np.random.RandomState(seed)
    palette = r.randint(0, 256, 1024).astype(np.uint8).tobytes()
    body = r.randint(0, 256, w * h).astype(np.uint8).tobytes()
    start = 28 + 128 + 1024
    head = b"BLP1" + struct.pack("<iI", 1, int(alpha)) + struct.pack("<II", w, h)
    head += struct.pack("<iI", encoding, 0)
    head += struct.pack("<16I", start, *([0] * 15)) + struct.pack("<16I", len(body), *([0] * 15))
    return head + palette + body


def blp1_jpeg_bytes(jpeg: bytes, w, h, alpha=0, split=None, gap=0):
    """A BLP1 JPEG file: the stream cut at ``split`` into the header's JPEG
    tables and the first mipmap, ``gap`` bytes between them."""
    split = split or jpeg.index(b"\xff\xda")
    header, body = jpeg[:split], jpeg[split:]
    start = 28 + 128 + 4 + len(header) + gap
    head = b"BLP1" + struct.pack("<iI", 0, alpha) + struct.pack("<II", w, h)
    head += struct.pack("<iI", 5, 0)
    head += struct.pack("<16I", start, *([0] * 15)) + struct.pack("<16I", len(body), *([0] * 15))
    return head + struct.pack("<I", len(header)) + header + bytes(gap) + body


def pil_blp(w, h, version, seed, transparency=False):
    """A BLP file PIL's writer makes of a seeded palette image (needs PIL)."""
    from PIL import Image
    r = np.random.RandomState(seed)
    im = Image.fromarray(r.randint(0, 256, (h, w)).astype(np.uint8), "L").convert("P")
    im.putpalette(r.randint(0, 256, 768).astype(np.uint8).tobytes())
    if transparency:
        im.putpalette(r.randint(0, 256, 1024).astype(np.uint8).tobytes(), "RGBA")
    out = io.BytesIO()
    im.save(out, "BLP", blp_version=version)
    return out.getvalue()


# ------------------------------------------------------------------ ICNS

def icns_rle(band: bytes) -> bytes:
    """PIL's ICNS run-length code of one band: runs of 3-130 equal bytes as
    (count + 125, byte), the rest as literal packets of 1-128 bytes."""
    out, lit, i, n = bytearray(), bytearray(), 0, len(band)
    while i < n:
        j = i
        while j < n and j - i < 130 and band[j] == band[i]:
            j += 1
        if j - i >= 3:
            while lit:
                out += bytes([min(len(lit), 128) - 1]) + lit[:128]
                lit = lit[128:]
            out += bytes([j - i + 125, band[i]])
            i = j
        else:
            lit.append(band[i])
            i += 1
    while lit:
        out += bytes([min(len(lit), 128) - 1]) + lit[:128]
        lit = lit[128:]
    return bytes(out)


def icns_bytes(entries) -> bytes:
    """An icns container of (type, data) entries."""
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb_entry(px: np.ndarray, raw=False, lead=False) -> bytes:
    """An RLE (or raw) RGB entry of [h, w, 3] pixels; ``lead``: it32's four
    zero bytes first."""
    if raw:
        data = px.astype(np.uint8).tobytes()
    else:
        data = b"".join(icns_rle(np.ascontiguousarray(px[..., k]).tobytes()) for k in range(3))
    return (bytes(4) if lead else b"") + data


def smooth(h, w, seed, ch=3, block=4, noise=0.2):
    """Pixels with runs (blocks of a colour, a share of them noise), as
    icons and frames have."""
    r = np.random.RandomState(seed)
    coarse = r.randint(0, 256, ((h + block - 1) // block, (w + block - 1) // block, ch))
    px = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
    noise = r.rand(h, w) < noise
    px[noise] = r.randint(0, 256, (int(noise.sum()), ch))
    return px.astype(np.uint8)


def pil_png(px: np.ndarray, mode=None) -> bytes:
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(px, mode).save(out, "PNG")
    return out.getvalue()


def pil_jpeg2000(px: np.ndarray, **options) -> bytes:
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(px).save(out, "JPEG2000", **options)
    return out.getvalue()


def pil_icns(size, seed) -> bytes:
    """The ICNS file PIL's writer makes of a seeded RGBA image (needs PIL)."""
    from PIL import Image
    out = io.BytesIO()
    px = np.zeros((size, size, 4), np.uint8)
    px[:, : size // 2] = np.random.RandomState(seed).randint(0, 256, 4)
    px[:, size // 2:] = (20, 200, 90, 255)
    Image.fromarray(px, "RGBA").save(out, "ICNS")
    return out.getvalue()


# ------------------------------------------------------------------ PCD

def pcd_bytes(seed, orientation=0, short=0) -> bytes:
    """A PhotoCD image pack: "PCD_IPI" at sector 1 with the orientation
    byte, the 768 x 512 base image at sector 96 (pairs of luma rows and a
    row of each half-width chroma), seeded."""
    r = np.random.RandomState(seed)
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation | (r.randint(0, 64) << 2)
    y = smooth(512, 768, seed, 1)[..., 0]
    cb = smooth(256, 384, seed + 1, 1)[..., 0]
    cr = smooth(256, 384, seed + 2, 1)[..., 0]
    chunks = np.concatenate([y.reshape(256, 1536), cb, cr], 1)
    data = bytes(head) + chunks.tobytes()
    return data[:len(data) - short]


# ------------------------------------------------------------------ FITS

def fits_card(key, value=None) -> bytes:
    if value is None:
        return key.ljust(80).encode()
    return (key.ljust(8) + "= " + str(value).rjust(20)).ljust(80).encode()


def fits_header(cards) -> bytes:
    out = b"".join(fits_card(*c) for c in cards) + fits_card("END")
    return out.ljust(-(-len(out) // 2880) * 2880, b" ")


def fits_bytes(bitpix, shape, seed, naxis=None, extra=(), pad=True) -> bytes:
    """A FITS file of one image: big-endian samples of BITPIX, NAXIS1 the
    width; NAXIS 1 for a one-dimensional shape."""
    r = np.random.RandomState(seed)
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if bitpix < 0:
        px = (r.rand(*shape) * 300 - 20).astype(dt)
    else:
        px = r.randint(0, 1 << min(bitpix, 16), shape).astype(dt)
    dims = list(shape[::-1])
    cards = [("SIMPLE", "T"), ("BITPIX", bitpix), ("NAXIS", naxis if naxis is not None
                                                    else len(dims))]
    cards += [(f"NAXIS{k + 1}", v) for k, v in enumerate(dims)] + list(extra)
    data = px.tobytes()
    if pad:
        data = data.ljust(-(-len(data) // 2880) * 2880, b"\0")
    return fits_header(cards) + data


def fits_gzip_bytes(zbitpix, w, h, seed, cut=0) -> bytes:
    """A tile-compressed FITS image as PIL's FitsGzipDecoder reads it: an
    empty primary header, a BINTABLE extension with ZIMAGE = T and
    ZCMPTYPE = 'GZIP_1', its table, then one gzip stream of a 4-byte
    big-endian word per pixel."""
    import gzip
    r = np.random.RandomState(seed)
    words = r.randint(0, 1 << min(max(zbitpix, 8), 31), (h, w)).astype(">u4")
    z = gzip.compress(words.tobytes(), mtime=0)
    table = r.randint(0, 256, 8 * h).astype(np.uint8).tobytes()
    ext = [("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 8),
           ("NAXIS2", h), ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", zbitpix),
           ("ZNAXIS", 2), ("ZNAXIS1", w), ("ZNAXIS2", h)]
    out = fits_header([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)]) + fits_header(ext)
    out += table + z
    return out[:len(out) - cut]


# ------------------------------------------------------------------ FLI

def fli_chunk(kind, data) -> bytes:
    if len(data) % 2:
        data += b"\0"
    return struct.pack("<IH", 6 + len(data), kind) + data


def fli_frame(chunks) -> bytes:
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body


def fli_bytes(w, h, frames, magic=0xAF12, n_frames=None, prefix=None) -> bytes:
    body = (prefix or b"") + b"".join(frames)
    head = struct.pack("<IHHHHHHI", 128 + len(body), magic,
                       len(frames) if n_frames is None else n_frames, w, h, 8, 3, 5)
    head = head.ljust(128, b"\0")
    return head + body


def fli_colour(palette: np.ndarray, kind=4, packets=None) -> bytes:
    """A COLOR chunk (4: 256 levels, 11: 64): packets of (skip, count,
    count triples); by default one packet of the whole palette."""
    packets = packets or [(0, palette)]
    out = struct.pack("<H", len(packets))
    for skip, entries in packets:
        out += bytes([skip, len(entries) % 256]) + np.asarray(entries, np.uint8).tobytes()
    return fli_chunk(kind, out)


def fli_brun(px: np.ndarray) -> bytes:
    out = bytearray()
    for row in px:
        packets, x, w = bytearray(), 0, len(row)
        count = 0
        while x < w:
            j = x
            while j < w and j - x < 127 and row[j] == row[x]:
                j += 1
            if j - x >= 2:
                packets += bytes([j - x, row[x]])
                x = j
            else:
                j = x
                while j < w and j - x < 128 and not (j + 1 < w and row[j + 1] == row[j]):
                    j += 1
                j = max(j, x + 1)
                packets += bytes([256 - (j - x)]) + bytes(row[x:j])
                x = j
            count += 1
        out += bytes([count & 255]) + packets
    return fli_chunk(15, bytes(out))


def fli_lc(px: np.ndarray, base: np.ndarray, first=None) -> bytes:
    """An LC (byte delta) chunk turning ``base`` into ``px``."""
    h, w = px.shape
    rows = [y for y in range(h) if (px[y] != base[y]).any()]
    y0 = rows[0] if rows else 0
    y1 = rows[-1] + 1 if rows else 0
    out = bytearray(struct.pack("<HH", y0 if first is None else first, y1 - y0))
    for y in range(y0, y1):
        packets, x, pos = bytearray(), 0, 0
        n = 0
        diff = np.nonzero(px[y] != base[y])[0]
        while diff.size:
            start = int(diff[0])
            end = start
            while end + 1 < w and end + 1 - start < 127 and px[y, end + 1] != base[y, end + 1]:
                end += 1
            skip = start - pos
            while skip > 255:
                packets += bytes([255, 0])
                skip -= 255
                n += 1
            seg = px[y, start:end + 1]
            if len(seg) >= 3 and (seg == seg[0]).all():
                packets += bytes([skip, 256 - len(seg), seg[0]])
            else:
                packets += bytes([skip, len(seg)]) + seg.tobytes()
            n += 1
            pos = end + 1
            diff = diff[diff > end]
        out += bytes([n]) + packets
    return fli_chunk(12, bytes(out))


def fli_ss2(px: np.ndarray) -> bytes:
    """An SS2 (word delta) chunk writing every line of ``px`` (even width)
    over black, a skip word before an empty stretch."""
    h, w = px.shape
    out = bytearray(struct.pack("<H", h))
    for y in range(h):
        words = px[y].reshape(-1, 2)
        packets = bytearray()
        n, i = 0, 0
        while i < len(words):
            j = i
            while j < len(words) and j - i < 127 and (words[j] == words[i]).all():
                j += 1
            if j - i >= 2:
                packets += bytes([0, 256 - (j - i)]) + words[i].tobytes()
            else:
                j = i + 1
                packets += bytes([0, 1]) + words[i].tobytes()
            n += 1
            i = j
        out += struct.pack("<H", n) + packets
    return fli_chunk(7, bytes(out))


# ------------------------------------------------------------------ IPTC

def iptc_field(record, dataset, data) -> bytes:
    n = len(data)
    if n < 0x8000:
        return bytes([0x1C, record, dataset]) + struct.pack(">H", n) + data
    # PIL reads a length of more than 15 bits from the 4 bytes after the
    # field's fifth byte, s[3] - 128 of them
    return bytes([0x1C, record, dataset, 0x84, 0]) + struct.pack(">I", n) + data


def iptc_bytes(w, h, layers, component, compression, body, band=None, split=0,
               extra=b"") -> bytes:
    """An IPTC/NAA image: a few descriptive fields, the image's size, layers
    and compression, and its data in one (8, 10) field or ``split`` ones."""
    out = iptc_field(1, 90, b"\x1b%G") + iptc_field(2, 5, b"a test image") + extra
    out += iptc_field(3, 20, struct.pack(">H", w)) + iptc_field(3, 30, struct.pack(">H", h))
    out += iptc_field(3, 60, bytes([layers, component]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    out += iptc_field(3, 120, bytes([compression]))
    if split:
        step = -(-len(body) // split)
        for k in range(0, len(body), step):
            out += iptc_field(8, 10, body[k:k + step])
    else:
        out += iptc_field(8, 10, body)
    return out


# ------------------------------------------------------------------ the catalog

def _patch(data, at, raw):
    return data[:at] + raw + data[at + len(raw):]


def _ycck_jpeg():
    """A YCCK JPEG of the committed fixtures (Adobe transform 2)."""
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "tests", "data", "torch_formats_variants", "small",
                           "jpeg_ycck.jpg"), "rb") as f:
        return f.read()


def _jpeg(mode, seed, w=13, h=9):
    from PIL import Image
    px = smooth(h, w, seed, {"L": 1, "RGB": 3, "CMYK": 4}[mode])
    out = io.BytesIO()
    Image.fromarray(px[..., 0] if mode == "L" else px, mode).save(out, "JPEG", quality=90)
    return out.getvalue()


def _blp_dxt(ae, ad, w, h):
    kind = 1 if ae == 0 else 3
    return blp2_bytes(w, h, 2, ad, ae, bc_blocks(kind, w, h, 31 * ae + 7 * ad + w))


# BC6H signed: the DXGI format; BC6H modes 0-13 and a reserved one
_BC6_MODES = list(range(14)) + [14]

TEXTURE_VARIANTS = {}
for _fourcc, _kind in ((b"DXT1", 1), (b"DXT3", 2), (b"DXT5", 3), (b"BC4U", 4), (b"ATI1", 4),
                       (b"BC5U", 5), (b"ATI2", 5), (b"BC5S", 5)):
    TEXTURE_VARIANTS[f"dds_fourcc_{_fourcc.decode().lower()}_13x9.dds"] = (
        lambda name, f=_fourcc, k=_kind: dds_fourcc(f, k, 13, 9, sum(map(ord, name))))
for _m in (0, 1):
    TEXTURE_VARIANTS[f"dds_bc1_{('four', 'three')[_m]}_colours.dds"] = (
        lambda name, m=_m: dds_fourcc(b"DXT1", 1, 16, 8, 5 + m, m))
for _dxgi, _kind in ((70, 1), (71, 1), (73, 2), (74, 2), (76, 3), (77, 3), (79, 4), (80, 4),
                     (82, 5), (83, 5), (84, 5), (27, 0), (28, 0), (29, 0)):
    TEXTURE_VARIANTS[f"dds_dx10_{_dxgi}_11x6.dds"] = (
        lambda name, d=_dxgi, k=_kind: dds_dx10(d, k, 11, 6, sum(map(ord, name))))
for _m in _BC6_MODES:
    for _dxgi in (95, 96):
        TEXTURE_VARIANTS[f"dds_bc6h_{'sf16' if _dxgi == 96 else 'uf16'}_mode{_m}.dds"] = (
            lambda name, d=_dxgi, m=_m: dds_dx10(d, 6, 16, 8, sum(map(ord, name)), m))
for _m in range(8):
    TEXTURE_VARIANTS[f"dds_bc7_mode{_m}.dds"] = (
        lambda name, m=_m: dds_dx10(98, 7, 16, 8, sum(map(ord, name)), m))
TEXTURE_VARIANTS.update({
    "dds_bc7_mixed_modes_13x9.dds": lambda name: dds_dx10(99, 7, 13, 9, 3),
    "dds_bc7_no_mode_bit.dds": lambda name: dds_bytes(4, 4, DDPF_FOURCC, bytes(16),
                                                      fourcc=b"DX10", dxgi=97),
    "dds_bc6h_uf16_13x9.dds": lambda name: dds_dx10(95, 6, 13, 9, 4),
    "dds_rgb_32bit.dds": lambda name: dds_rgb(7, 5, 32, (0xFF0000, 0xFF00, 0xFF), 1),
    "dds_rgb_24bit_bgr.dds": lambda name: dds_rgb(7, 5, 24, (0xFF, 0xFF00, 0xFF0000), 2),
    "dds_rgb_565.dds": lambda name: dds_rgb(7, 5, 16, (0xF800, 0x7E0, 0x1F), 3),
    "dds_rgb_332.dds": lambda name: dds_rgb(7, 5, 8, (0xE0, 0x1C, 0x3), 4),
    "dds_rgb_scattered_masks.dds": lambda name: dds_rgb(7, 5, 32, (0x50A0, 0xF000F, 0), 5),
    "dds_rgb_64bit.dds": lambda name: dds_rgb(7, 5, 64, (0xFFFF, 0xFFFF0000, 0xFF), 6),
    "dds_rgb_short_data.dds": lambda name: dds_rgb(7, 5, 32, (0xFF0000, 0xFF00, 0xFF), 7,
                                                   short=37),
    "dds_rgba_1555.dds": lambda name: dds_rgb(7, 5, 16, (0x7C00, 0x3E0, 0x1F, 0x8000), 8,
                                              alpha=True),
    "dds_rgba_32bit.dds": lambda name: dds_rgb(7, 5, 32, (0xFF0000, 0xFF00, 0xFF,
                                                          0xFF000000), 9, alpha=True),
    "dds_luminance.dds": lambda name: dds_luminance(7, 5, False, 10),
    "dds_luminance_alpha.dds": lambda name: dds_luminance(7, 5, True, 11),
    "dds_palette.dds": lambda name: dds_palette(7, 5, 12),
})
for _mode, _pf in (("L", None), ("LA", None), ("RGB", None), ("RGBA", None), ("RGBA", "DXT1"),
                   ("RGBA", "DXT3"), ("RGBA", "DXT5"), ("RGBA", "BC2"), ("RGBA", "BC3"),
                   ("RGB", "BC5")):
    TEXTURE_VARIANTS[f"dds_pil_{_mode.lower()}_{(_pf or 'raw').lower()}.dds"] = (
        lambda name, m=_mode, p=_pf: pil_dds(13, 9, m, p, sum(map(ord, name))))
for _v in ("BLP1", "BLP2"):
    for _t in (False, True):
        TEXTURE_VARIANTS[f"blp_pil_{_v.lower()}{'_alpha' if _t else ''}.blp"] = (
            lambda name, v=_v, t=_t: pil_blp(13, 9, v, sum(map(ord, name)), t))
for _a in (0, 1):
    TEXTURE_VARIANTS[f"blp_blp1_palette_alpha{_a}.blp"] = (
        lambda name, a=_a: blp1_palette_bytes(7, 5, a, 2 + a))
TEXTURE_VARIANTS["blp_blp1_palette_encoding5.blp"] = lambda name: blp1_palette_bytes(
    7, 5, 0, 4, encoding=5)
for _ae in (0, 1, 7):
    for _ad in (0, 1, 8):
        for _w, _h in ((8, 8), (13, 9)):
            TEXTURE_VARIANTS[f"blp_blp2_dxt_ae{_ae}_ad{_ad}_{_w}x{_h}.blp"] = (
                lambda name, ae=_ae, ad=_ad, w=_w, h=_h: _blp_dxt(ae, ad, w, h))
for _ad in (0, 1, 4, 8):
    TEXTURE_VARIANTS[f"blp_blp2_palette_ad{_ad}.blp"] = (
        lambda name, ad=_ad: blp2_bytes(7, 5, 1, ad, 0, np.random.RandomState(ad).randint(
            0, 256, 35).astype(np.uint8).tobytes(), seed=ad))
for _mode in ("L", "RGB", "CMYK"):
    TEXTURE_VARIANTS[f"blp_blp1_jpeg_{_mode.lower()}.blp"] = (
        lambda name, m=_mode: blp1_jpeg_bytes(_jpeg(m, 3), 13, 9))
TEXTURE_VARIANTS.update({
    "blp_blp1_jpeg_rgb_alpha.blp": lambda name: blp1_jpeg_bytes(_jpeg("RGB", 4), 13, 9, 1),
    "blp_blp1_jpeg_gap.blp": lambda name: blp1_jpeg_bytes(_jpeg("RGB", 5), 13, 9, gap=9),
    "blp_blp1_jpeg_larger_stream.blp": lambda name: blp1_jpeg_bytes(_jpeg("RGB", 6), 11, 7),
    "blp_blp1_jpeg_ycck.blp": lambda name: blp1_jpeg_bytes(_ycck_jpeg(), 53, 37),
    "ftex_bc1_8x8.ftu": lambda name: ftex_bytes(8, 8, 0, bc_blocks(1, 8, 8, 1)),
    "ftex_bc1_13x9.ftc": lambda name: ftex_bytes(13, 9, 0, bc_blocks(1, 13, 9, 2)),
    "ftex_raw_13x9.ftu": lambda name: ftex_bytes(13, 9, 1, np.random.RandomState(3).randint(
        0, 256, 13 * 9 * 3).astype(np.uint8).tobytes(), where=48),
})


def texture_refused():
    """[(name, file bytes, a word of the port's refusal)]: one file for each
    way PIL refuses a DDS, BLP or FTEX file."""
    v = {name: make(name) for name, make in TEXTURE_VARIANTS.items()}
    dxt1 = v["dds_fourcc_dxt1_13x9.dds"]
    return [
        ("dds_header_size", _patch(dxt1, 4, struct.pack("<I", 100)), "header size"),
        ("dds_incomplete_header", dxt1[:90], "Incomplete header"),
        ("dds_unknown_fourcc", _patch(dxt1, 84, b"DXT2"), "pixel format"),
        ("dds_bc4s", _patch(dxt1, 84, b"BC4S"), "pixel format"),
        ("dds_unknown_dxgi", dds_dx10(87, 0, 4, 4, 1), "DXGI format"),
        ("dds_bc4_snorm", dds_dx10(81, 4, 4, 4, 1), "DXGI format"),
        ("dds_truncated_blocks", dxt1[:-9], "truncated"),
        ("dds_luminance_16_no_alpha", dds_bytes(4, 4, DDPF_LUMINANCE, bytes(32), bitcount=16),
         "luminance"),
        ("dds_no_format_flags", dds_bytes(4, 4, 0, bytes(16)), "pixel format flags"),
        ("dds_raw_truncated", v["dds_luminance.dds"][:-3], "truncated"),
        ("dds_palette_truncated", v["dds_palette.dds"][:-1], "truncated"),
        ("blp_blp2_raw_bgra", blp2_bytes(7, 5, 3, 8, 0, bytes(140)), "BLP2 encoding"),
        ("blp_blp2_alpha_encoding", blp2_bytes(8, 8, 2, 8, 2, bytes(64)), "alpha encoding"),
        ("blp_blp2_compression0", _patch(v["blp_pil_blp2.blp"], 4, struct.pack("<i", 0)),
         "compression"),
        ("blp_blp1_compression2", _patch(v["blp_blp1_palette_alpha0.blp"], 4,
                                         struct.pack("<i", 2)), "compression"),
        ("blp_blp1_encoding3", blp1_palette_bytes(7, 5, 0, 1, encoding=3), "encoding"),
        ("blp_palette_truncated", v["blp_blp2_palette_ad0.blp"][:500], "truncated"),
        ("blp_dxt_truncated", v["blp_blp2_dxt_ae1_ad8_13x9.blp"][:-20], "truncated"),
        ("blp_too_few_pixels", blp2_bytes(7, 5, 1, 0, 0, bytes(20)), "not enough"),
        ("blp_jpeg_not_jpeg", blp1_jpeg_bytes(b"\x00" * 40, 4, 4, split=10), "JPEG"),
        ("ftex_format2", ftex_bytes(8, 8, 2, bytes(32)), "texture format"),
        ("ftex_two_formats", ftex_bytes(8, 8, 0, bytes(32), format_count=2), "formats"),
        ("ftex_truncated", ftex_bytes(8, 8, 0, bytes(20)), "truncated"),
    ]


REGISTRY_VARIANTS = {}
_pal = np.random.RandomState(21).randint(0, 256, (256, 3)).astype(np.uint8)
_fli_px = smooth(13, 20, 22, 1)[..., 0]
REGISTRY_VARIANTS.update({
    "icns_is32.icns": lambda name: icns_bytes([(b"is32", icns_rgb_entry(smooth(16, 16, 1)))]),
    "icns_is32_mask.icns": lambda name: icns_bytes([
        (b"is32", icns_rgb_entry(smooth(16, 16, 2))),
        (b"s8mk", smooth(16, 16, 3, 1).tobytes())]),
    "icns_is32_raw.icns": lambda name: icns_bytes([
        (b"is32", icns_rgb_entry(smooth(16, 16, 4), raw=True))]),
    "icns_il32_and_is32.icns": lambda name: icns_bytes([
        (b"is32", icns_rgb_entry(smooth(16, 16, 5))),
        (b"il32", icns_rgb_entry(smooth(32, 32, 6))), (b"l8mk", smooth(32, 32, 7, 1).tobytes())]),
    "icns_ih32_mask.icns": lambda name: icns_bytes([
        (b"ih32", icns_rgb_entry(smooth(48, 48, 8))), (b"h8mk", smooth(48, 48, 9, 1).tobytes())]),
    "icns_it32_mask.icns": lambda name: icns_bytes([
        (b"it32", icns_rgb_entry(smooth(128, 128, 10, block=8, noise=0.02), lead=True)),
        (b"t8mk", smooth(128, 128, 11, 1, block=16, noise=0).tobytes())]),
    "icns_ic07_png.icns": lambda name: icns_bytes([
        (b"ic07", pil_png(smooth(128, 128, 12, 4, block=16, noise=0.01)))]),
    "icns_ic07_png_beside_it32.icns": lambda name: icns_bytes([
        (b"ic07", pil_png(smooth(64, 64, 13, 4, block=8, noise=0.01))),
        (b"it32", icns_rgb_entry(smooth(128, 128, 14, block=16, noise=0.01), lead=True))]),
    "icns_icp4_grey_png.icns": lambda name: icns_bytes([
        (b"icp4", pil_png(smooth(16, 16, 15, 1)[..., 0]))]),
    "icns_icp5_palette_png.icns": lambda name: icns_bytes([
        (b"icp5", pil_png(smooth(32, 32, 16, 1)[..., 0] // 16 * 16, "L"))]),
    "icns_ic09_jpeg2000_scaled.icns": lambda name: icns_bytes([
        (b"ic09", pil_jpeg2000(smooth(64, 64, 17, 3)))]),
    "icns_icp5_jpeg2000_grey.icns": lambda name: icns_bytes([
        (b"icp5", pil_jpeg2000(smooth(32, 32, 18, 1)[..., 0]))]),
    "icns_icp5_jpeg2000_rgba.icns": lambda name: icns_bytes([
        (b"icp5", pil_jpeg2000(smooth(32, 32, 19, 4)))]),
    "icns_pil_16.icns": lambda name: pil_icns(16, 20),
})
for _b in (8, 16, 32, -32, -64):
    REGISTRY_VARIANTS[f"fits_bitpix{_b}.fits"] = (
        lambda name, b=_b: fits_bytes(b, (7, 13), abs(b)))
    REGISTRY_VARIANTS[f"fits_bitpix{_b}_naxis1.fits"] = (
        lambda name, b=_b: fits_bytes(b, (9,), abs(b) + 1))
for _z in (8, 16, 32):
    REGISTRY_VARIANTS[f"fits_gzip_zbitpix{_z}.fits"] = (
        lambda name, z=_z: fits_gzip_bytes(z, 13, 7, z))
REGISTRY_VARIANTS.update({
    "fits_naxis3.fits": lambda name: fits_bytes(16, (2, 7, 13), 3),
    "fits_comments_and_blank_cards.fits": lambda name: fits_bytes(
        8, (7, 13), 4, extra=[("COMMENT a test image",), ("",), ("OBJECT", "'page'")]),
    "fli_brun.fli": lambda name: fli_bytes(20, 13, [fli_frame([fli_colour(_pal),
                                                               fli_brun(_fli_px)])]),
    "fli_colour64_brun.fli": lambda name: fli_bytes(20, 13, [fli_frame([
        fli_colour(_pal >> 1, 11), fli_brun(_fli_px)])], magic=0xAF11),
    "fli_copy.flc": lambda name: fli_bytes(20, 13, [fli_frame([
        fli_colour(_pal), fli_chunk(16, _fli_px.tobytes())])]),
    "fli_black.flc": lambda name: fli_bytes(20, 13, [fli_frame([fli_colour(_pal),
                                                                fli_chunk(13, bytes(4))])]),
    "fli_lc.fli": lambda name: fli_bytes(20, 13, [fli_frame([
        fli_colour(_pal), fli_lc(_fli_px, np.zeros_like(_fli_px))])], magic=0xAF11),
    "fli_ss2.flc": lambda name: fli_bytes(20, 13, [fli_frame([fli_colour(_pal),
                                                              fli_ss2(_fli_px)])]),
    "fli_two_frames.flc": lambda name: fli_bytes(20, 13, [
        fli_frame([fli_colour(_pal), fli_brun(_fli_px)]),
        fli_frame([fli_lc(_fli_px[::-1].copy(), _fli_px)])]),
    "fli_palette_packets.flc": lambda name: fli_bytes(20, 13, [fli_frame([
        fli_colour(_pal, packets=[(3, _pal[:10]), (5, _pal[10:30])]), fli_brun(_fli_px)])]),
    "fli_no_palette.flc": lambda name: fli_bytes(20, 13, [fli_frame([fli_brun(_fli_px)])]),
    "fli_pstamp.flc": lambda name: fli_bytes(20, 13, [fli_frame([
        fli_colour(_pal), fli_chunk(18, b"1234"), fli_brun(_fli_px)])]),
    "iptc_grey.iim": lambda name: iptc_bytes(7, 5, 1, 0, 1, smooth(5, 7, 23, 1).tobytes()),
    "iptc_grey_split.iim": lambda name: iptc_bytes(7, 5, 1, 0, 1, smooth(5, 7, 24, 1).tobytes(),
                                                  split=3),
    "iptc_rgb_band2.iim": lambda name: iptc_bytes(7, 5, 3, 1, 1, smooth(5, 7, 25, 1).tobytes(),
                                                 band=2),
    "iptc_rgb_no_band.iim": lambda name: iptc_bytes(7, 5, 3, 1, 1,
                                                   smooth(5, 7, 26, 1).tobytes()),
    "iptc_cmyk_band4.iim": lambda name: iptc_bytes(7, 5, 4, 1, 1, smooth(5, 7, 27, 1).tobytes(),
                                                  band=4),
    "iptc_cmyk_band0.iim": lambda name: iptc_bytes(7, 5, 4, 1, 1, smooth(5, 7, 28, 1).tobytes(),
                                                  band=0),
    "iptc_jpeg_grey.iim": lambda name: iptc_bytes(13, 9, 1, 0, 5, _jpeg("L", 29)),
    "iptc_long_field.iim": lambda name: iptc_bytes(
        7, 5, 1, 0, 1, smooth(5, 7, 30, 1).tobytes(),
        extra=bytes([0x1C, 2, 120, 0x84, 0]) + struct.pack(">I", 9) + b"long text"),
})


def registry_refused():
    """[(name, file bytes, a word of the port's refusal)]: one file for each
    way PIL refuses an ICNS, FITS, FLI or IPTC file (PCD's are made by the
    tests, its files being 786 KB)."""
    v = {name: make(name) for name, make in REGISTRY_VARIANTS.items()}
    brun = v["fli_brun.fli"]
    return [
        ("icns_mask_only", icns_bytes([(b"s8mk", bytes(256))]), "RGB"),
        ("icns_png_of_another_size", icns_bytes([(b"ic08", pil_png(smooth(100, 100, 1)))]),
         "allowed sizes"),
        ("icns_unknown_entry", icns_bytes([(b"ic07", b"GIF89a" + bytes(40))]),
         "neither PNG nor JPEG 2000"),
        ("icns_it32_without_lead", icns_bytes([(b"it32", icns_rgb_entry(smooth(128, 128, 2)))]),
         "it32"),
        ("icns_rle_overrun", icns_bytes([(b"is32", bytes([0xFF, 7]) * 3 + bytes(80))]),
         "run-length"),
        ("icns_truncated_mask", v["icns_is32_mask.icns"][:-40], "mask"),
        ("fits_no_image", fits_bytes(8, (7, 13), 1, naxis=0), "no image data"),
        ("fits_truncated", fits_bytes(8, (7, 13), 1, pad=False)[:-5], "truncated"),
        ("fits_gzip_float", fits_gzip_bytes(-32, 13, 7, 2), "not enough image data"),
        ("fits_gzip_cut", fits_gzip_bytes(16, 13, 7, 3, cut=3), "GZIP_1"),
        ("fits_bad_number", _patch(v["fits_bitpix8.fits"], 160 + 25, b"1x"), "whole number"),
        ("fli_prefix_chunk", fli_bytes(20, 13, [fli_frame([fli_colour(_pal), fli_brun(_fli_px)])],
                                       prefix=struct.pack("<IH", 16, 0xF100) + bytes(10)),
         "corrupt"),
        ("fli_truncated", brun[:-30], "truncated"),
        ("fli_black_last_chunk_of_6_bytes", fli_bytes(20, 13, [fli_frame([
            fli_colour(_pal), fli_chunk(13, b"")])]), "buffer overrun"),
        ("fli_unknown_chunk", fli_bytes(20, 13, [fli_frame([fli_chunk(99, b"abcd")])]), "corrupt"),
        ("fli_brun_short_line",
         fli_bytes(20, 13, [fli_frame([fli_chunk(15, bytes([1, 5, 9]) * 13)])]), "buffer overrun"),
        ("iptc_compression2", iptc_bytes(7, 5, 1, 0, 2, bytes(35)), "compression"),
        ("iptc_truncated", iptc_bytes(7, 5, 1, 0, 1, bytes(20)), "truncated"),
        ("iptc_band_out_of_range", iptc_bytes(7, 5, 3, 1, 1, bytes(35), band=9), "band"),
        ("iptc_jpeg_colour_band", iptc_bytes(13, 9, 3, 1, 5, _jpeg("RGB", 2), band=1),
         "decided divergence"),
    ]


def registry_small_variants():
    """[(file name, write(path))] of every variant of the catalog."""
    def write(path, data):
        with open(path, "wb") as f:
            f.write(data)
    return [(name, lambda p, name=name, make=make: write(p, make(name)))
            for name, make in {**TEXTURE_VARIANTS, **REGISTRY_VARIANTS}.items()]


def registry_pages(grey_pages):
    """chip_smoke.py's full-size pages of the registry written byte by byte
    from grey pages: [(file name, file bytes, the "L" pixels PIL decodes it
    to)]: an uncompressed luminance DDS and an 8-bit FITS (its rows written
    bottom-up, as PIL reads them)."""
    a, b = (np.ascontiguousarray(p, np.uint8) for p in grey_pages[:2])
    h, w = a.shape
    dds = dds_bytes(w, h, DDPF_LUMINANCE, a.tobytes(), bitcount=8)
    cards = [("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", w), ("NAXIS2", h)]
    data = b[::-1].tobytes()
    fits = fits_header(cards) + data.ljust(-(-len(data) // 2880) * 2880, b"\0")
    return [("dds_luminance.dds", dds, a), ("fits_8bit.fits", fits, b)]
