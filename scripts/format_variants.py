"""Test encoders of the image variants the port decodes, and their
catalog: ``tests/test_torch_formats_variants.py`` holds the port to PIL on
every variant, and ``scripts/make_format_fixtures.py`` writes each as a
small fixture that ``chip_smoke.py`` decodes on the card's machine.

PIL writes few of these variants. PNM and PNG (Adam7 interlacing, 16-bit
samples, every scanline filter) are written here byte by byte; TIFF
through the libtiff that Pillow bundles (``pillow.libs``), called with
ctypes, which writes every codec, predictor, fill order, planar layout and
byte order PIL reads back. Only the TIFF writer needs PIL (for its
libtiff); nothing here is imported by the port.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import struct
import zlib

import numpy as np


def pnm_bytes(magic, w, h, maxval, samples, plain=False):
    """A PNM file: ``samples`` ints, written as decimal tokens (with a
    comment in the header and line breaks), as 1- or 2-byte binary, or for
    P4 (``maxval`` None) as bits, 1 black, rows padded to whole bytes."""
    head = magic + b"\n# written by a test\n%d %d\n" % (w, h)
    if magic == b"P4":
        rows = np.asarray(samples, np.uint8).reshape(h, w)
        return head + np.packbits(rows, axis=1).tobytes()
    if maxval is not None:
        head += b"%d\n" % maxval
    if plain:
        tokens = [b"%d" % v for v in samples]
        return head + b"\n".join(b" ".join(tokens[i:i + 11]) for i in range(0, len(tokens), 11))
    width = 1 if maxval < 256 else 2
    return head + np.asarray(samples).astype(np.uint8 if width == 1 else ">u2").tobytes()


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _png_filter(rows, bpp, rng):
    """Each scanline under a random filter type (0 to 4)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        kind = rng.randint(0, 5)
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png_scanlines(samples, depth, rng):
    h, w, ch = samples.shape
    if depth == 16:
        rows = samples.reshape(h, w * ch).astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.reshape(h, w * ch).astype(np.uint8)
    else:
        bits = (samples.reshape(h, w)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    return _png_filter(rows, max(1, ch * depth // 8), rng)


def png_bytes(samples, ctype, depth, interlace, seed, palette=None, trns=None):
    """A PNG of the given samples [h, w, ch] (raw values), filtered at
    random, interlaced with Adam7 if asked."""
    rng = np.random.RandomState(seed)
    h, w = samples.shape[:2]
    if interlace:
        raw = b"".join(_png_scanlines(samples[y0::dy, x0::dx], depth, rng)
                       for x0, y0, dx, dy in _ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _png_scanlines(samples, depth, rng)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# (id, magic, maxval, ASCII)
PNM_CASES = [
    # (id, magic, maxval, plain)
    ("P2-255", b"P2", 255, True), ("P2-100", b"P2", 100, True),
    ("P2-1000", b"P2", 1000, True), ("P2-65535", b"P2", 65535, True),
    ("P3-255", b"P3", 255, True), ("P3-7", b"P3", 7, True),
    ("P3-4095", b"P3", 4095, True), ("P3-65535", b"P3", 65535, True),
    ("P5-256", b"P5", 256, False), ("P5-1000", b"P5", 1000, False),
    ("P5-65534", b"P5", 65534, False), ("P5-65535", b"P5", 65535, False),
    ("P6-300", b"P6", 300, False), ("P6-65535", b"P6", 65535, False),
    ("P0CMYK-255", b"P0CMYK", 255, False), ("P0CMYK-1000", b"P0CMYK", 1000, False),
]

# (PNG colour type, bit depth)
PNG_LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
               (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@functools.cache
def libtiff() -> ctypes.CDLL:
    """Pillow's bundled libtiff (its dependencies are loaded by PIL.Image)."""
    import PIL
    from PIL import Image  # noqa: F401
    root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(root, "libtiff-*.so*"))[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    for name in ("TIFFWriteEncodedStrip", "TIFFWriteEncodedTile"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                       ctypes.c_ssize_t]
        getattr(lib, name).restype = ctypes.c_ssize_t
    return lib


def _tiff_bytes(rows, bps):
    """[r, n] sample values -> one strip's or tile's bytes (native order
    for 16- and 32-bit samples: libtiff swaps them for a big-endian file)."""
    if bps == 8:
        return rows.astype(np.uint8).tobytes()
    if bps == 16:
        return rows.astype(np.uint16).tobytes()
    if bps == 32:
        return rows.tobytes()
    bits = (rows[..., None].astype(np.uint32) >> np.arange(bps - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(rows.shape[0], -1).astype(np.uint8), axis=1).tobytes()


def write_tiff(path, samples, bps, photometric, compression=1, predictor=1, planar=1,
               fillorder=1, tile=None, rows_per_strip=None, sampleformat=1, extrasamples=(),
               t4options=None, subsampling=None, jpegcolormode=None, big=False,
               big_endian=False, colormap=None):
    """``samples`` [h, w, spp] written by libtiff with the given tags."""
    lib = libtiff()
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    mode = b"w" + (b"8" if big else b"") + (b"b" if big_endian else b"l")
    tif = ctypes.c_void_p(lib.TIFFOpen(path.encode(), mode))
    assert tif.value

    def tag(number, *values):
        assert lib.TIFFSetField(tif, ctypes.c_uint32(number), *values)
    u32 = ctypes.c_uint32
    for number, value in ((256, w), (257, h), (258, bps), (277, spp), (262, photometric),
                          (259, compression), (284, planar)):
        tag(number, u32(value))
    for number, value, default in ((266, fillorder, 1), (339, sampleformat, 1),
                                   (317, predictor, 1)):
        if value != default:
            tag(number, u32(value))
    if extrasamples:
        tag(338, u32(len(extrasamples)), (ctypes.c_uint16 * len(extrasamples))(*extrasamples))
    if t4options is not None:
        tag(292, u32(t4options))
    if subsampling is not None:
        tag(530, u32(subsampling[0]), u32(subsampling[1]))
    if jpegcolormode is not None:
        tag(65538, u32(jpegcolormode))
    if colormap is not None:
        tag(320, *[(ctypes.c_uint16 * colormap.shape[1])(*colormap[i]) for i in range(3)])
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    index = 0
    if tile:
        tw, th = tile
        tag(322, u32(tw))
        tag(323, u32(th))
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    data = _tiff_bytes(block.reshape(th, -1), bps)
                    assert lib.TIFFWriteEncodedTile(tif, index, data, len(data)) >= 0
                    index += 1
    else:
        rps = rows_per_strip or h
        tag(278, u32(rps))
        for plane in planes:
            for y in range(0, h, rps):
                part = plane[y:y + rps]
                data = _tiff_bytes(part.reshape(part.shape[0], -1), bps)
                assert lib.TIFFWriteEncodedStrip(tif, index, data, len(data)) >= 0
                index += 1
    lib.TIFFClose(tif)


H, W = 37, 53


def _values(rng, n, bits, dtype=None):
    v = rng.randint(0, 1 << bits, (H, W, n))
    return v.astype(dtype) if dtype else v


def _floats(rng):
    v = rng.uniform(-20, 300, (H, W)).astype(np.float32)
    v.flat[:4] = (np.nan, np.inf, 254.99, -0.5)
    return v


def _palette(rng, bits):
    return rng.randint(0, 65536, (3, 1 << bits)).astype(np.uint16)


TIFF_VARIANTS = {
    # CCITT: modified Huffman, Group 3 1-D / 2-D, EOL fill bits, FillOrder 2
    "mh": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=0, compression=2),
    "mh-fillorder2": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=1,
                                    compression=2, fillorder=2),
    "g3-1d": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=0, compression=3,
                            t4options=0),
    "g3-2d": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=0, compression=3,
                            t4options=1, rows_per_strip=8),
    "g3-2d-fillbits": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=1,
                                     compression=3, t4options=5),
    "g3-1d-fillbits-fillorder2": lambda r: dict(samples=_values(r, 1, 1), bps=1,
                                                photometric=0, compression=3, t4options=4,
                                                fillorder=2, rows_per_strip=9),
    "g3-2d-tiles": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=0,
                                  compression=3, t4options=1, tile=(32, 16)),
    "g4-fillorder2": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=1,
                                    compression=4, fillorder=2),
    # FillOrder 2 on whole-byte samples
    "L-fillorder2-raw": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=1,
                                       fillorder=2),
    "L-fillorder2-lzw": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=1,
                                       compression=5, fillorder=2),
    "RGB-fillorder2-raw": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=2,
                                         fillorder=2),
    "P8-fillorder2-lzw": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=3,
                                        compression=5, fillorder=2, colormap=_palette(r, 8)),
    "I16-fillorder2-raw": lambda r: dict(samples=_values(r, 1, 16), bps=16, photometric=1,
                                         fillorder=2),
    "I16-fillorder2-lzw": lambda r: dict(samples=_values(r, 1, 16), bps=16, photometric=1,
                                         fillorder=2, compression=5),
    # 2- and 4-bit samples
    "L2-raw": lambda r: dict(samples=_values(r, 1, 2), bps=2, photometric=1),
    "L2-lzw": lambda r: dict(samples=_values(r, 1, 2), bps=2, photometric=1, compression=5),
    "L4-minwhite-deflate": lambda r: dict(samples=_values(r, 1, 4), bps=4, photometric=0,
                                          compression=8),
    "L4-fillorder2-raw": lambda r: dict(samples=_values(r, 1, 4), bps=4, photometric=1,
                                        fillorder=2),
    "P4-raw": lambda r: dict(samples=_values(r, 1, 4), bps=4, photometric=3,
                             colormap=_palette(r, 4)),
    "P2-lzw": lambda r: dict(samples=_values(r, 1, 2), bps=2, photometric=3, compression=5,
                             colormap=_palette(r, 2)),
    # 16-bit samples, both byte orders, with and without the predictor
    "I16-raw": lambda r: dict(samples=_values(r, 1, 16), bps=16, photometric=1),
    "I16-minwhite-raw": lambda r: dict(samples=_values(r, 1, 16), bps=16, photometric=0),
    "I16-bigendian-raw": lambda r: dict(samples=_values(r, 1, 16), bps=16, photometric=1,
                                        big_endian=True),
    "I16-bigendian-lzw-predictor": lambda r: dict(samples=_values(r, 1, 16), bps=16,
                                                  photometric=1, big_endian=True,
                                                  compression=5, predictor=2),
    "I16-lzw-predictor": lambda r: dict(samples=_values(r, 1, 16), bps=16, photometric=1,
                                        compression=5, predictor=2, rows_per_strip=5),
    "I16-deflate-predictor-tiles": lambda r: dict(samples=_values(r, 1, 16), bps=16,
                                                  photometric=1, compression=8, predictor=2,
                                                  tile=(16, 32)),
    "I16-signed": lambda r: dict(samples=_values(r, 1, 16, np.int16), bps=16, photometric=1,
                                 sampleformat=2),
    "I16-signed-bigendian-lzw": lambda r: dict(samples=_values(r, 1, 16, np.int16), bps=16,
                                               photometric=1, sampleformat=2,
                                               big_endian=True, compression=5),
    "RGB16-raw": lambda r: dict(samples=_values(r, 3, 16), bps=16, photometric=2),
    "RGB16-bigendian-raw": lambda r: dict(samples=_values(r, 3, 16), bps=16, photometric=2,
                                          big_endian=True),
    "RGB16-deflate-predictor": lambda r: dict(samples=_values(r, 3, 16), bps=16,
                                              photometric=2, compression=8, predictor=2),
    "RGBA16-raw": lambda r: dict(samples=_values(r, 4, 16), bps=16, photometric=2,
                                 extrasamples=(2,)),
    "RGBa16-premultiplied": lambda r: dict(samples=_values(r, 4, 16), bps=16, photometric=2,
                                           extrasamples=(1,)),
    # 32-bit integer and float samples, both predictors
    "F-raw": lambda r: dict(samples=_floats(r), bps=32, photometric=1, sampleformat=3),
    "F-bigendian-raw": lambda r: dict(samples=_floats(r), bps=32, photometric=1,
                                      sampleformat=3, big_endian=True),
    "F-minwhite-lzw": lambda r: dict(samples=_floats(r), bps=32, photometric=0,
                                     sampleformat=3, compression=5),
    "F-deflate-predictor3": lambda r: dict(samples=_floats(r), bps=32, photometric=1,
                                           sampleformat=3, compression=8, predictor=3),
    "F-bigendian-lzw-predictor3": lambda r: dict(samples=_floats(r), bps=32, photometric=1,
                                                 sampleformat=3, compression=5, predictor=3,
                                                 big_endian=True),
    "I32-signed": lambda r: dict(samples=_values(r, 1, 16, np.int32) - 300, bps=32,
                                 photometric=1, sampleformat=2),
    "I32-signed-bigendian-deflate": lambda r: dict(samples=_values(r, 1, 16, np.int32) - 300,
                                                   bps=32, photometric=1, sampleformat=2,
                                                   big_endian=True, compression=8),
    "I32-signed-lzw-predictor": lambda r: dict(samples=_values(r, 1, 16, np.int32) - 300,
                                               bps=32, photometric=1, sampleformat=2,
                                               compression=5, predictor=2),
    "U32": lambda r: dict(samples=_values(r, 1, 16, np.uint32), bps=32, photometric=1),
    # PlanarConfiguration 2
    "planar-RGB-raw": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=2,
                                     planar=2),
    "planar-RGB-lzw-strips": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=2,
                                            planar=2, compression=5, rows_per_strip=8),
    "planar-RGB-deflate-tiles": lambda r: dict(samples=_values(r, 3, 8), bps=8,
                                               photometric=2, planar=2, compression=8,
                                               tile=(16, 16)),
    "planar-RGBA-raw-tiles": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2,
                                            planar=2, extrasamples=(2,), tile=(16, 16)),
    "planar-RGB16-lzw": lambda r: dict(samples=_values(r, 3, 16), bps=16, photometric=2,
                                       planar=2, compression=5),
    "planar-LA-lzw": lambda r: dict(samples=_values(r, 2, 8), bps=8, photometric=1,
                                    planar=2, extrasamples=(2,), compression=5),
    "planar-L-minwhite-raw": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=0,
                                            planar=2),
    "planar-L-minwhite-lzw": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=0,
                                            planar=2, compression=5),
    "planar-bilevel-minwhite-raw": lambda r: dict(samples=_values(r, 1, 1), bps=1,
                                                  photometric=0, planar=2),
    "planar-CMYK-raw": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=5,
                                      planar=2),
    "planar-F-raw": lambda r: dict(samples=_floats(r), bps=32, photometric=1, sampleformat=3,
                                   planar=2),
    # CMYK and premultiplied alpha
    "CMYK-raw": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=5),
    "CMYK-lzw": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=5, compression=5),
    "CMYK16-lzw": lambda r: dict(samples=_values(r, 4, 16), bps=16, photometric=5,
                                 compression=5),
    "RGBa-premultiplied": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2,
                                         extrasamples=(1,)),
    # JPEG-in-TIFF with JPEGTables
    "jpeg-grey": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=1,
                                compression=7),
    "jpeg-grey-minwhite": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=0,
                                         compression=7),
    "jpeg-rgb-strips": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=2,
                                      compression=7, rows_per_strip=16),
    "jpeg-ycbcr-420-strips": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                            compression=7, jpegcolormode=1,
                                            rows_per_strip=16),
    "jpeg-ycbcr-420-bigendian": lambda r: dict(samples=_values(r, 3, 8), bps=8,
                                               photometric=6, compression=7,
                                               jpegcolormode=1, big_endian=True,
                                               rows_per_strip=32),
    "jpeg-ycbcr-444": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                     compression=7, jpegcolormode=1, subsampling=(1, 1)),
    "jpeg-ycbcr-422-tiles": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                           compression=7, jpegcolormode=1,
                                           subsampling=(2, 1), tile=(32, 16)),
    "jpeg-ycbcr-440": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                     compression=7, jpegcolormode=1, subsampling=(1, 2)),
    # BigTIFF (little-endian)
    "bigtiff-L": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=1, big=True),
    "bigtiff-RGB-lzw-tiles": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=2,
                                            big=True, compression=5, tile=(16, 32)),
    "bigtiff-g4": lambda r: dict(samples=_values(r, 1, 1), bps=1, photometric=0, big=True,
                                 compression=4, rows_per_strip=7),
    "bigtiff-RGB16-deflate-predictor": lambda r: dict(samples=_values(r, 3, 16), bps=16,
                                                      photometric=2, big=True,
                                                      compression=8, predictor=2),
}


TIFF_REFUSED = {
    # PIL does not open these
    "bigtiff-bigendian": (lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=1,
                                         big=True, big_endian=True), "big-endian BigTIFF"),
    "LA16": (lambda r: dict(samples=_values(r, 2, 16), bps=16, photometric=1,
                            extrasamples=(2,)), "sample layout"),
    "ycbcr-uncompressed": (lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                          subsampling=(1, 1)), "uncompressed YCbCr"),
    "planar-RGBX-raw": (lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2,
                                       planar=2, extrasamples=(0,)), "PlanarConfiguration 2"),
    "RGB-float": (lambda r: dict(samples=_values(r, 3, 16, np.float32), bps=32, photometric=2,
                                 sampleformat=3), "sample layout"),
}




def write_ycbcr_units(path, h, w, subsampling, compression, tile=None, rows_per_strip=None,
                      seed=0):
    """A YCbCr TIFF of random sampling units (each the h x v Y samples, then
    Cb and Cr), handed to libtiff as they are stored, under a codec other
    than JPEG: PIL reads it through libtiff's RGBA interface."""
    lib = libtiff()
    rng = np.random.RandomState(seed)
    hs, vs = subsampling
    tif = ctypes.c_void_p(lib.TIFFOpen(path.encode(), b"wl"))
    assert tif.value
    u32 = ctypes.c_uint32

    def tag(number, *values):
        assert lib.TIFFSetField(tif, u32(number), *values)
    for number, value in ((256, w), (257, h), (258, 8), (277, 3), (262, 6),
                          (259, compression), (284, 1)):
        tag(number, u32(value))
    tag(530, u32(hs), u32(vs))
    cw, ch = tile if tile else (w, rows_per_strip or h)
    if tile:
        tag(322, u32(cw))
        tag(323, u32(ch))
    else:
        tag(278, u32(ch))
    write = lib.TIFFWriteEncodedTile if tile else lib.TIFFWriteEncodedStrip
    index = 0
    for y in range(0, h, ch):
        for _ in range(0, w, cw) if tile else (0,):
            rows = ch if tile else min(ch, h - y)
            units = -(-cw // hs) * -(-rows // vs) * (hs * vs + 2)
            data = rng.randint(0, 256, units).astype(np.uint8).tobytes()
            assert write(tif, index, data, len(data)) >= 0
            index += 1
    lib.TIFFClose(tif)


def old_style_jpeg_tiff(h, w, subsampling, seed=0):
    """An old-style JPEG-in-TIFF (compression 6): a JPEG stream that PIL
    writes (its ``subsampling`` option), behind JPEGInterchangeFormat and
    as the one strip."""
    import io
    from PIL import Image
    rgb = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=90, subsampling=subsampling)
    jpg = buf.getvalue()
    tags = [(256, 3, [w]), (257, 3, [h]), (258, 3, [8, 8, 8]), (259, 3, [6]), (262, 3, [6]),
            (273, 4, [8]), (277, 3, [3]), (278, 3, [h]), (279, 4, [len(jpg)]),
            (513, 4, [8]), (514, 4, [len(jpg)])]
    ifd = 8 + len(jpg) + (len(jpg) & 1)
    extra_at = ifd + 2 + 12 * len(tags) + 4
    body, extra = b"", b""
    for tag, kind, values in tags:
        data = b"".join(struct.pack("<H" if kind == 3 else "<I", v) for v in values)
        if len(data) <= 4:
            body += struct.pack("<HHI", tag, kind, len(values)) + data.ljust(4, b"\0")
        else:
            body += struct.pack("<HHII", tag, kind, len(values), extra_at + len(extra))
            extra += data
    return (b"II*\0" + struct.pack("<I", ifd) + jpg + b"\0" * (len(jpg) & 1)
            + struct.pack("<H", len(tags)) + body + b"\0\0\0\0" + extra)


# YCbCr under other codecs than JPEG: (h, w, subsampling, compression,
# tile, rows per strip), every subsampling libtiff's RGBA interface reads
TIFF_YCBCR_VARIANTS = {
    "ycbcr-11-lzw": (16, 24, (1, 1), 5, None, None),
    "ycbcr-12-lzw": (16, 24, (1, 2), 5, None, None),
    "ycbcr-21-deflate": (16, 25, (2, 1), 8, None, None),
    "ycbcr-22-lzw-odd": (17, 23, (2, 2), 5, None, None),
    "ycbcr-22-deflate-strips": (41, 50, (2, 2), 8, None, 8),
    "ycbcr-22-lzw-tiles": (40, 50, (2, 2), 5, (16, 16), None),
    "ycbcr-41-lzw": (8, 21, (4, 1), 5, None, None),
    "ycbcr-42-packbits": (18, 30, (4, 2), 32773, None, None),
    "ycbcr-44-lzw": (19, 21, (4, 4), 5, None, None),
}
# old-style JPEG: (h, w, PIL's JPEG subsampling: 0 4:4:4, 1 4:2:2, 2 4:2:0)
OLD_JPEG_VARIANTS = {"ojpeg-420": (32, 48, 2), "ojpeg-420-odd": (35, 45, 2),
                     "ojpeg-422": (33, 47, 1), "ojpeg-444": (31, 40, 0)}


def small_variants():
    """[(file name, write(path))] of every decodable variant of the
    catalog at the tests' small size: the PNM cases, each PNG layout
    interlaced and not, each TIFF variant."""
    out = []
    for name, magic, maxval, plain in PNM_CASES:
        bands = {b"P2": 1, b"P5": 1, b"P3": 3, b"P6": 3, b"P0CMYK": 4}[magic]
        values = np.random.RandomState(maxval).randint(0, maxval + 1, 13 * 6 * bands)
        data = pnm_bytes(magic, 13, 6, maxval, values, plain)
        out.append((f"pnm_{name}.pnm", lambda p, data=data: _write_bytes(p, data)))
    for ctype, depth in PNG_LAYOUTS:
        for interlace in (True, False):
            rng = np.random.RandomState(ctype * 100 + depth)
            ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
            samples = rng.randint(0, 1 << depth, (H, W, ch))
            palette = rng.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
            data = png_bytes(samples, ctype, depth, interlace, ctype + depth, palette)
            name = f"png_type{ctype}_{depth}bit_{'adam7' if interlace else 'plain'}.png"
            out.append((name, lambda p, data=data: _write_bytes(p, data)))
    for name, make in TIFF_VARIANTS.items():
        out.append((f"tiff_{name}.tif", lambda p, name=name, make=make: write_tiff(
            p, **make(np.random.RandomState(sum(map(ord, name)))))))
    for name, args in TIFF_YCBCR_VARIANTS.items():
        out.append((f"tiff_{name}.tif", lambda p, args=args: write_ycbcr_units(p, *args)))
    for name, args in OLD_JPEG_VARIANTS.items():
        out.append((f"tiff_{name}.tif",
                    lambda p, args=args: _write_bytes(p, old_style_jpeg_tiff(*args))))
    return out


def _write_bytes(path, data):
    with open(path, "wb") as f:
        f.write(data)
