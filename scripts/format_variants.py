"""Test encoders of the image variants the port decodes, and their
catalog: ``tests/test_torch_formats_variants.py`` holds the port to PIL on
every variant, and ``scripts/make_format_fixtures.py`` writes each as a
small fixture that ``chip_smoke.py`` decodes on the card's machine.

PIL writes few of these variants. PNM, PNG (Adam7 interlacing, 16-bit
samples, every scanline filter), BMP (every header, depth, RLE and
bitfields layout PIL reads) and GIF (LZW, interlacing, colour tables,
transparency) are written here byte by byte; TIFF through the libtiff that
Pillow bundles (``pillow.libs``), called with ctypes, which writes every
codec, predictor, fill order, planar layout and byte order PIL reads back;
JPEG through Pillow's libjpeg-turbo and a small C layer over its API
(``scripts/jpeg_test_encoder.c``, built with gcc), which writes CMYK /
YCCK, arithmetic coding, lossless predictors, any sampling factors and scan
script; WebP through Pillow's libwebp and a small C layer over its encoder
(``scripts/webp_test_encoder.c``, built with gcc), which sets the loop
filter, partitions, segments and alpha coding PIL's save hides, with the
extended and animated containers and ALPH chunks written byte by byte
around its frames; JPEG 2000 through Pillow's libopenjp2 and a small C
layer over its compressor (``scripts/jpeg2000_test_encoder.c``, built with
gcc), which sets the code-block styles, SOP / EPH, ROI, subsampling,
precisions, signs, progression order changes and tile-parts PIL's save
hides, with PPM / PPT / PLM markers, interleaved tile-parts and the JP2
boxes OpenJPEG does not write (pclr, cmap, cdef, res, ICC colr, unknown
boxes, JPX branding) rewritten byte by byte around its codestreams. Only
the TIFF, JPEG, WebP and JPEG 2000 writers need PIL (for its libraries);
nothing here is imported by the port.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import re
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




def _pil_image(kind, seed, h=96, w=128):
    from PIL import Image
    if kind == "P":
        return Image.fromarray(jpeg_page(h, w, 3, seed)).quantize(64)
    return Image.fromarray(jpeg_page(h, w, 3 if kind == "RGB" else 1, seed)[..., :3]
                           if kind == "RGB" else jpeg_page(h, w, 1, seed)[..., 0])


# pages as PIL's own writer compresses them (zlib level 6, IDAT chunks as
# its encoder flushes them): the bases of the damaged-file fuzz of PNG
PNG_PIL_VARIANTS = {f"pil-{kind.lower()}": (lambda kind=kind, seed=seed: _pil_image(kind, seed))
                    for seed, kind in enumerate(("L", "RGB", "P"), 80)}


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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def jpeg_encoder() -> ctypes.CDLL:
    """``scripts/jpeg_test_encoder.c`` built with gcc (into ``build/``,
    keyed by the source's hash) against the libjpeg-turbo Pillow bundles,
    which is loaded first so that the helper's calls resolve to it."""
    import hashlib
    import subprocess
    import tempfile

    import PIL
    from PIL import Image  # noqa: F401
    root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(root, "libjpeg-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    src = os.path.join(REPO, "scripts", "jpeg_test_encoder.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(REPO, "build", "test_encoders")
    so = os.path.join(out_dir, f"jpeg_test_encoder_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        subprocess.run([os.environ.get("CC", "gcc"), "-O1", "-shared", "-fPIC", src, "-o", tmp],
                       check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    ptr, ulong = ctypes.c_void_p, ctypes.c_ulong
    lib.tenc_encode.argtypes = ([ptr] + [ctypes.c_int] * 5 + [ptr] + [ctypes.c_int] * 3
                                + [ptr, ctypes.c_int] + [ctypes.c_int] * 4
                                + [ptr] + [ctypes.c_int] * 3
                                + [ctypes.POINTER(ptr), ctypes.POINTER(ulong), ctypes.c_char_p])
    lib.tenc_transcode.argtypes = [ptr, ulong] + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ptr), ctypes.POINTER(ulong), ctypes.c_char_p]
    lib.tenc_decode.argtypes = [ptr, ulong, ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int),
                                ctypes.c_char_p]
    lib.tenc_free.argtypes = [ptr]
    return lib


# libjpeg's J_COLOR_SPACE values
JCS = {"unknown": 0, "grey": 1, "rgb": 2, "ycbcr": 3, "cmyk": 4, "ycck": 5}


def _ints(values):
    if values is None:
        return None
    arr = (ctypes.c_int * len(values))(*values)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _jpeg_call(fn, *args):
    out, size = ctypes.c_void_p(), ctypes.c_ulong()
    err = ctypes.create_string_buffer(256)
    rc = fn(*args, ctypes.byref(out), ctypes.byref(size), err)
    lib = jpeg_encoder()
    if rc:
        raise ValueError(err.value.decode())
    data = ctypes.string_at(out, size.value)
    lib.tenc_free(out)
    return data


def jpeg_bytes(samples, *, colorspace=None, sampling=None, quality=75, arith=False,
               progressive=False, scans=None, restart_interval=0, restart_rows=0,
               adobe=None, jfif=None, dac=None, lossless=None, optimize=False):
    """A JPEG of ``samples`` ([h, w] or [h, w, c] uint8; 3 channels are
    RGB, 4 CMYK, 2 of no colour space) written by Pillow's libjpeg-turbo:
    ``colorspace`` the file's (a ``JCS`` key), ``sampling`` (h, v) per
    component, ``arith`` arithmetic coding with ``dac`` {"dc_L", "dc_U",
    "ac_K": [per table]}, ``scans`` a script of (components, Ss, Se, Ah,
    Al), ``adobe`` / ``jfif`` whether those markers are written,
    ``lossless`` (predictor, point transform)."""
    lib = jpeg_encoder()
    px = np.ascontiguousarray(samples, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, nc = px.shape
    in_cs = {1: JCS["grey"], 3: JCS["rgb"], 4: JCS["cmyk"]}.get(nc, JCS["unknown"])
    samp = _ints([v for hv in sampling for v in hv]) if sampling else None
    script = None
    if scans:
        flat = []
        for comps, ss, se, ah, al in scans:
            flat += [len(comps)] + list(comps) + [0] * (4 - len(comps)) + [ss, se, ah, al]
        script = _ints(flat)
    dac_v = None
    if dac:
        dac_v = _ints([(list(dac.get(k, ())) + [-1] * 4)[i] for k in ("dc_L", "dc_U", "ac_K")
                       for i in range(4)])
    psv, pt = lossless or (0, 0)
    return _jpeg_call(
        lib.tenc_encode, px.ctypes.data, w, h, nc, in_cs,
        -1 if colorspace is None else JCS[colorspace], samp and samp[0], quality, int(arith),
        int(progressive), script and script[0], len(scans or ()), restart_interval,
        restart_rows, -1 if adobe is None else int(adobe), -1 if jfif is None else int(jfif),
        dac_v and dac_v[0], psv, pt, int(optimize))


def libjpeg_decode(data):
    """The JPEG decoded by Pillow's libjpeg-turbo from one in-memory buffer
    with PIL's settings, converted to PIL's image: what PIL 12.1 would
    give if its decoder got the whole file at once (it feeds libjpeg 64
    KiB at a time, and the arithmetic decoder cannot resume, so PIL fails
    on larger arithmetic-coded files)."""
    from PIL import Image
    lib = jpeg_encoder()
    out, dims = ctypes.c_void_p(), (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(256)
    if lib.tenc_decode(data, len(data), ctypes.byref(out), dims, err):
        raise ValueError(err.value.decode())
    w, h, c = dims
    raw = ctypes.string_at(out, w * h * c)
    lib.tenc_free(out)
    mode, rawmode = {1: ("L", "L"), 3: ("RGB", "RGB"), 4: ("CMYK", "CMYK;I")}[c]
    return Image.frombytes(mode, (w, h), raw, "raw", rawmode)


def jpeg_transcode(data, *, arith=True, progressive=False, restart_interval=0):
    """The coefficients of JPEG ``data`` re-coded, unchanged, with another
    entropy coder or progression (jpeg_read_coefficients ->
    jpeg_write_coefficients)."""
    return _jpeg_call(jpeg_encoder().tenc_transcode, data, len(data), int(arith),
                      int(progressive), restart_interval)


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
    "jpeg-cmyk": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=5,
                                compression=7, rows_per_strip=16),
    "jpeg-cmyk-tiles": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=5,
                                      compression=7, tile=(16, 16)),
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


# the sample layouts of PIL's OPEN_INFO the port read last (palette with an
# extra sample, 12-bit grey) and JPEG-in-TIFF with extra samples or planes,
# separate YCbCr planes under the other codecs, written by libtiff
TIFF_LAYOUT_VARIANTS = {
    "PA": lambda r: dict(samples=_values(r, 2, 8), bps=8, photometric=3, extrasamples=(2,),
                         colormap=_palette(r, 8)),
    "PX": lambda r: dict(samples=_values(r, 2, 8), bps=8, photometric=3, extrasamples=(0,),
                         colormap=_palette(r, 8)),
    "PA-lzw": lambda r: dict(samples=_values(r, 2, 8), bps=8, photometric=3, extrasamples=(2,),
                             colormap=_palette(r, 8), compression=5),
    "L12": lambda r: dict(samples=_values(r, 1, 12), bps=12, photometric=1),
    "L12-lzw": lambda r: dict(samples=_values(r, 1, 12), bps=12, photometric=1, compression=5),
    "jpeg-LA": lambda r: dict(samples=_values(r, 2, 8), bps=8, photometric=1, extrasamples=(2,),
                              compression=7),
    "jpeg-RGBA": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2,
                                extrasamples=(2,), compression=7, rows_per_strip=16),
    "jpeg-RGBX": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2,
                                extrasamples=(0,), compression=7),
    "jpeg-RGBa": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2,
                                extrasamples=(1,), compression=7),
    "jpeg-planar-L": lambda r: dict(samples=_values(r, 1, 8), bps=8, photometric=1, planar=2,
                                    compression=7),
    "jpeg-planar-RGB": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=2, planar=2,
                                      compression=7, tile=(16, 16)),
    "jpeg-planar-RGBA": lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2, planar=2,
                                       extrasamples=(2,), compression=7),
    "jpeg-planar-ycbcr": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                        planar=2, compression=7, subsampling=(1, 1)),
    "ycbcr-planar-lzw": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6, planar=2,
                                       compression=5, subsampling=(1, 1), rows_per_strip=8),
    "ycbcr-planar-deflate": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                           planar=2, compression=8, subsampling=(1, 1)),
    "ycbcr-planar-packbits": lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                            planar=2, compression=32773, subsampling=(1, 1)),
}
# (the layout, a word of the port's refusal); PIL refuses each but LAB, whose
# "RGB" only LittleCMS gives (ImageCms): a divergence ROADMAP.md records
TIFF_LAYOUT_REFUSED = {
    "LAB": (lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=8), "CIELAB"),
    "L12-minwhite": (lambda r: dict(samples=_values(r, 1, 12), bps=12, photometric=0),
                     "sample layout"),
    "ycbcr-planar-lzw-22": (lambda r: dict(samples=_values(r, 3, 8), bps=8, photometric=6,
                                           planar=2, compression=5), "separate YCbCr"),
    "planar-RGBX-raw": (lambda r: dict(samples=_values(r, 4, 8), bps=8, photometric=2, planar=2,
                                       extrasamples=(0,)), "unknown raw mode"),
    "planar-LA-raw": (lambda r: dict(samples=_values(r, 2, 8), bps=8, photometric=1, planar=2,
                                     extrasamples=(2,)), "unknown raw mode"),
}


def _patched(write, patches):
    """``write(path)``, then single bytes of the file overwritten: a
    damaged copy of a variant."""
    def out(path):
        write(path)
        with open(path, "r+b") as f:
            for at, value in patches:
                f.seek(at)
                f.write(bytes([value]))
    return out


# damaged copies of small variants that PIL still decodes, through libjpeg's
# recovery of corrupt entropy data, libtiff's of bad CCITT codes and of a
# strip its RGBA interface reads past, and GIF LZW codes that still decode:
# (the variant's file, [(offset, new byte)])
DAMAGED_VARIANTS = {
    "jpeg_damaged-grey.jpg": ("jpeg_huffman-grey.jpg", [(639, 69)]),
    "jpeg_damaged-420.jpg": ("jpeg_huffman-420.jpg", [(1929, 86)]),
    "jpeg_damaged-progressive.jpg": ("jpeg_huffman-progressive.jpg", [(256, 204)]),
    "jpeg_damaged-restarts.jpg": ("jpeg_huffman-restarts.jpg", [(1805, 148)]),
    "tiff_damaged-g4.tif": ("tiff_g4-fillorder2.tif", [(345, 227)]),
    "tiff_damaged-g3-1d.tif": ("tiff_g3-1d.tif", [(292, 135)]),
    "tiff_damaged-ycbcr-lzw.tif": ("tiff_ycbcr-22-lzw-odd.tif", [(675, 162)]),
    "gif_damaged-global.gif": ("gif_global.gif", [(722, 19)]),
}


def png_adler_unchecked(seed=80):
    """A PNG whose zlib check value sits in an IDAT chunk of its own and a
    literal byte of the stored deflate data changed: PIL's ZipDecode stops
    at the last row before inflate reaches the check, and decodes it."""
    import struct as st
    img = np.asarray(_pil_image("L", seed))
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img
    z = bytearray(zlib.compress(rows.tobytes(), 0))
    z[len(z) // 2] ^= 0x5A

    def chunk(kind, body):
        return st.pack(">I", len(body)) + kind + body + st.pack(">I", zlib.crc32(kind + body))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", st.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", bytes(z[:-4])) + chunk(b"IDAT", bytes(z[-4:])) + chunk(b"IEND", b""))


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
    interlaced and not, each TIFF, JPEG, BMP and GIF variant."""
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
    for name, make in PNG_PIL_VARIANTS.items():
        out.append((f"png_{name}.png", lambda p, make=make: make().save(p, format="PNG")))
    for name, make in TIFF_VARIANTS.items():
        out.append((f"tiff_{name}.tif", lambda p, name=name, make=make: write_tiff(
            p, **make(np.random.RandomState(sum(map(ord, name)))))))
    for name, make in TIFF_LAYOUT_VARIANTS.items():
        out.append((f"tiff_layout-{name}.tif", lambda p, name=name, make=make: write_tiff(
            p, **make(np.random.RandomState(sum(map(ord, name)))))))
    for name, args in TIFF_YCBCR_VARIANTS.items():
        out.append((f"tiff_{name}.tif", lambda p, args=args: write_ycbcr_units(p, *args)))
    for name, args in OLD_JPEG_VARIANTS.items():
        out.append((f"tiff_{name}.tif",
                    lambda p, args=args: _write_bytes(p, old_style_jpeg_tiff(*args))))
    for name, make in JPEG_VARIANTS.items():
        out.append((f"jpeg_{name}.jpg", lambda p, make=make: _write_bytes(p, make())))
    for name, make in BMP_VARIANTS.items():
        out.append((f"bmp_{name}.bmp", lambda p, name=name, make=make: _write_bytes(
            p, bmp_bytes(**make(np.random.RandomState(len(name)))))))
    for name, make in GIF_VARIANTS.items():
        out.append((f"gif_{name}.gif", lambda p, make=make: _write_bytes(p, gif_bytes(**make()))))
    writers = dict(out)
    out += [(name, _patched(writers[base], patches))
            for name, (base, patches) in DAMAGED_VARIANTS.items()]
    out.append(("png_damaged-adler-unchecked.png",
                lambda p: _write_bytes(p, png_adler_unchecked())))
    out += webp_small_variants()
    out += jpeg2000_small_variants()
    out += raster_small_variants()
    return out


def webp_small_variants():
    """[(file name, write(path))] of every WebP variant of the catalog."""
    return [(f"webp_{name}.webp", lambda p, make=make: _write_bytes(p, make()))
            for name, make in WEBP_VARIANTS.items()]


def _write_bytes(path, data):
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------------ BMP

def _bmp_rows(px, bits):
    """[h, w] indices or [h, w, k] bytes -> rows padded to 4 bytes, bottom
    row first is the caller's choice."""
    h = px.shape[0]
    if bits < 8:
        vals = px.astype(np.uint8)
        b = (vals[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        rows = np.packbits(b.reshape(h, -1).astype(np.uint8), axis=1)
    else:
        rows = px.reshape(h, -1).astype(np.uint8)
    stride = -(-rows.shape[1] // 4) * 4
    out = np.zeros((h, stride), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out


def bmp_rle_bytes(index, rle4, seed=0, delta=False):
    """RLE8 / RLE4 codes of [h, w] indices, bottom row first: encoded runs
    where samples repeat (or, at random, for any stretch), absolute runs
    otherwise, an end of line per row and an end of bitmap; ``delta``
    puts a delta code over some zero samples."""
    rng = np.random.RandomState(seed)
    h, w = index.shape
    out = bytearray()
    for row in index[::-1].astype(np.uint8):
        x = 0
        while x < w:
            if delta and rng.rand() < 0.1 and x + 3 <= w and not row[x:x + 3].any():
                n = int(np.argmax(np.append(row[x:], 1) != 0))
                out += bytes([0, 2, 0, 0, n, 0])     # PIL reads two bytes after the skipped two
                x += n
                continue
            run = 1
            if rle4:
                while x + run < w and run < 255 and row[x + run] == row[x + run % 2]:
                    run += 1
            else:
                while x + run < w and run < 255 and row[x + run] == row[x]:
                    run += 1
            if run >= 3 or w - x < 3 or rng.rand() < 0.3:
                first = row[x]
                second = row[x + 1] if rle4 and run > 1 else first
                out += bytes([run, (first << 4 | second) if rle4 else first])
                x += run
                continue
            n = min(int(rng.randint(3, 40)), w - x, 254)
            if rle4:
                n -= n % 2
                if n < 4:
                    out += bytes([1, row[x] << 4])
                    x += 1
                    continue
                vals = row[x:x + n]
                body = bytes((vals[0::2] << 4) | vals[1::2])
            else:
                body = bytes(row[x:x + n])
            out += bytes([0, n]) + body + (b"\0" if len(body) % 2 else b"")
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_bytes(px, bits, header=40, top_down=False, palette=None, compression=0,
              masks=None, colors=None, rle_body=None):
    """A BMP of ``px`` ([h, w] palette indices for 1-8 bits; [h, w, 3] RGB
    for 24 bits; [h, w] 16- or 32-bit words for 16 and 32 bits, laid out by
    ``masks``), with the given header size (12: OS/2 v1), row order,
    palette ([n, 3] RGB), compression and bitfields masks."""
    h, w = px.shape[:2]
    if bits == 24:
        body = _bmp_rows(np.asarray(px)[..., ::-1], 24)
    elif bits in (16, 32):
        words = np.asarray(px).astype("<u2" if bits == 16 else "<u4")
        body = _bmp_rows(words.view(np.uint8).reshape(h, -1), 8)
    else:
        body = _bmp_rows(np.asarray(px), bits)
    if rle_body is not None:
        data = rle_body
    else:
        data = (body if top_down else body[::-1]).tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], axis=1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835,
                           len(palette) if colors is None and palette is not None
                           else (colors or 0), 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<" + "I" * len(masks), *masks)
        if header == 40:
            info += extra                       # three masks after the header
        else:
            info += (extra + bytes(header)).ljust(header - 40, b"\0")[:header - 40]
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + pal
            + data)


def _grey_ramp(n):
    return np.repeat(np.arange(n)[:, None], 3, axis=1)


def _bmp_case(kind, seed, h=29, w=37):
    r = np.random.RandomState(seed)
    if kind.startswith("P"):
        bits = int(kind[1])
        idx = r.randint(0, 1 << bits, (h, w))
        return dict(px=idx, bits=bits, palette=r.randint(0, 256, (1 << bits, 3)))
    if kind == "rgb24":
        return dict(px=r.randint(0, 256, (h, w, 3)), bits=24)
    if kind == "w16":
        return dict(px=r.randint(0, 1 << 16, (h, w)), bits=16)
    return dict(px=r.randint(0, 1 << 32, (h, w), dtype=np.uint64), bits=32)


BMP_VARIANTS = {
    "os2-P1": lambda r: dict(_bmp_case("P1", 1), header=12),
    "os2-P4": lambda r: dict(_bmp_case("P4", 2), header=12),
    "os2-P8": lambda r: dict(_bmp_case("P8", 3), header=12),
    "os2-rgb24": lambda r: dict(_bmp_case("rgb24", 4), header=12),
    "P1": lambda r: dict(_bmp_case("P1", 5)),
    "P1-black-white": lambda r: dict(_bmp_case("P1", 6), palette=[(0, 0, 0), (255, 255, 255)]),
    "P1-white-black": lambda r: dict(_bmp_case("P1", 6), palette=[(255, 255, 255), (0, 0, 0)]),
    "P4": lambda r: dict(_bmp_case("P4", 7)),
    "P4-top-down": lambda r: dict(_bmp_case("P4", 8), top_down=True),
    "P8": lambda r: dict(_bmp_case("P8", 9)),
    "P8-grey-ramp": lambda r: dict(_bmp_case("P8", 10), palette=_grey_ramp(256)),
    "P8-grey-ramp-top-down": lambda r: dict(_bmp_case("P8", 11), palette=_grey_ramp(256),
                                            top_down=True),
    "P8-short-palette": lambda r: dict(_bmp_case("P8", 12), palette=r.randint(0, 256, (20, 3))),
    "P8-short-grey-ramp": lambda r: dict(px=r.randint(0, 16, (29, 37)), bits=8,
                                         palette=_grey_ramp(16)),
    "P8-two-colours-black-white": lambda r: dict(px=r.randint(0, 2, (29, 37)), bits=8,
                                                 palette=[(0, 0, 0), (255, 255, 255)]),
    "rgb16-555": lambda r: dict(_bmp_case("w16", 13)),
    "rgb24": lambda r: dict(_bmp_case("rgb24", 14)),
    "rgb24-top-down": lambda r: dict(_bmp_case("rgb24", 15), top_down=True),
    "rgb24-odd-1x1": lambda r: dict(_bmp_case("rgb24", 16, 1, 1)),
    "rgbx32": lambda r: dict(_bmp_case("w32", 17)),
    "rgb24-header52": lambda r: dict(_bmp_case("rgb24", 18), header=52),
    "rgb24-header56": lambda r: dict(_bmp_case("rgb24", 19), header=56),
    "rgb24-header64": lambda r: dict(_bmp_case("rgb24", 20), header=64),
    "rgb24-header108": lambda r: dict(_bmp_case("rgb24", 21), header=108),
    "P8-header124": lambda r: dict(_bmp_case("P8", 22), header=124),
    "bitfields16-565": lambda r: dict(_bmp_case("w16", 23), compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F)),
    "bitfields16-555-header56": lambda r: dict(_bmp_case("w16", 24), compression=3, header=56,
                                               masks=(0x7C00, 0x3E0, 0x1F, 0)),
    "bitfields24": lambda r: dict(_bmp_case("rgb24", 25), compression=3,
                                  masks=(0xFF0000, 0xFF00, 0xFF)),
    **{f"bitfields32-{'-'.join(f'{m:x}' for m in masks)}": (
        lambda r, masks=masks, header=header: dict(_bmp_case("w32", sum(masks) % 97),
                                                   compression=3, masks=masks, header=header))
       for masks, header in (((0xFF0000, 0xFF00, 0xFF), 40),
                             ((0xFF000000, 0xFF0000, 0xFF00, 0x0), 56),
                             ((0xFF000000, 0xFF00, 0xFF, 0x0), 108),
                             ((0xFF000000, 0xFF0000, 0xFF00, 0xFF), 124),
                             ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), 56),
                             ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), 108),
                             ((0xFF000000, 0xFF00, 0xFF, 0xFF0000), 124),
                             ((0, 0, 0, 0), 56),
                             ((0xFF0000, 0xFF00, 0xFF), 52))},
}


def _rle_case(bits, seed, h=29, w=37, grey=False, delta=False, top_down=False):
    r = np.random.RandomState(seed)
    # runs of equal samples and noise, zeros for the delta codes
    idx = np.repeat(r.randint(0, 1 << bits, (h, w // 4 + 1)), 4, axis=1)[:, :w]
    idx[:, ::7] = r.randint(0, 1 << bits, idx[:, ::7].shape)
    if delta:
        idx[:, 5:14] = 0
    palette = _grey_ramp(256) if grey else r.randint(0, 256, (1 << bits, 3))
    # bmp_rle_bytes writes its argument's bottom row first
    body = bmp_rle_bytes(idx[::-1] if top_down else idx, bits == 4, seed, delta)
    return dict(px=idx, bits=bits, palette=palette, compression=1 if bits == 8 else 2,
                rle_body=body, top_down=top_down)


BMP_VARIANTS.update({
    "rle8": lambda r: _rle_case(8, 31),
    "rle8-grey-ramp": lambda r: _rle_case(8, 32, grey=True),
    "rle8-delta": lambda r: _rle_case(8, 33, delta=True),
    "rle8-odd-width": lambda r: _rle_case(8, 34, h=9, w=1),
    "rle4": lambda r: _rle_case(4, 35),
    "rle4-delta": lambda r: _rle_case(4, 36, delta=True),
    "rle4-odd": lambda r: _rle_case(4, 37, h=7, w=11),
    "rle8-top-down": lambda r: _rle_case(8, 38, top_down=True),
})

BMP_REFUSED = {
    # (the writer's arguments, a word of the refusal); PIL refuses these too
    "jpeg-in-bmp": (lambda r: dict(_bmp_case("rgb24", 41), compression=4), "JPEG"),
    "png-in-bmp": (lambda r: dict(_bmp_case("rgb24", 42), compression=5), "PNG"),
    "header20": (lambda r: dict(_bmp_case("rgb24", 43), header=20), "header of 20 bytes"),
    "P2": (lambda r: dict(px=r.randint(0, 4, (29, 37)), bits=2, palette=_grey_ramp(4)),
           "2-bit"),
    "bitfields16-444": (lambda r: dict(_bmp_case("w16", 44), compression=3,
                                       masks=(0xF00, 0xF0, 0xF)), "bitfields layout"),
    "bitfields8": (lambda r: dict(_bmp_case("P8", 45), compression=3,
                                  masks=(0xE0, 0x1C, 0x3)), "bitfields layout"),
    "rle24": (lambda r: dict(_bmp_case("rgb24", 46), compression=1,
                             rle_body=b"\x02\x05\x00\x00\x00\x01"), "RLE"),
}


# ------------------------------------------------------------------ GIF

def gif_lzw_bytes(index, bits, clear_when_full=True):
    """GIF LZW codes of the indices (flattened, in the order given), with
    a clear code first and whenever the table fills (or, if not
    ``clear_when_full``, the full table kept: a deferred clear)."""
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    flat = [int(v) for v in np.asarray(index).ravel()]
    size, nxt, table = bits + 1, clear + 2, {}
    emit(clear, size)
    cur = flat[0]
    for k in flat[1:]:
        key = (cur, k)
        if key in table:
            cur = table[key]
            continue
        emit(cur, size)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
            if nxt == 4096 and clear_when_full:
                emit(clear, size)
                size, nxt, table = bits + 1, clear + 2, {}
        cur = k
    emit(cur, size)
    emit(end, size)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _interlaced_rows(index):
    h = index.shape[0]
    order = (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
             + list(range(1, h, 2)))
    return index[order]


def gif_bytes(index, palette=None, local_palette=None, interlace=False, transparency=None,
              screen=None, offset=(0, 0), bits=None, clear_when_full=True, extensions=False,
              second_frame=False):
    """A GIF89a of [h, w] indices: a global and / or local colour table
    ([2^k, 3] RGB), interlaced or not, a graphic control extension with
    the transparency index, the logical screen and the frame's offset, the
    LZW minimum code size, comment and NETSCAPE extensions before the
    frame, a second frame after it."""
    index = np.asarray(index)
    h, w = index.shape
    sw, sh = screen or (w, h)

    def table_bits(p):
        return max(1, int(np.ceil(np.log2(max(len(p), 2)))))
    flags = 0
    out = b"GIF89a"
    gp = b""
    if palette is not None:
        k = table_bits(palette)
        flags = 0x80 | (k - 1)
        gp = np.asarray(palette, np.uint8).tobytes().ljust(3 << k, b"\0")
    out += struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gp
    if extensions:
        out += b"!\xfe" + _sub_blocks(b"written by a test")
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    lflags = 0x40 if interlace else 0
    lp = b""
    if local_palette is not None:
        k = table_bits(local_palette)
        lflags |= 0x80 | (k - 1)
        lp = np.asarray(local_palette, np.uint8).tobytes().ljust(3 << k, b"\0")
    code_bits = bits or max(2, int(np.ceil(np.log2(max(int(index.max()) + 1, 2)))))
    rows = _interlaced_rows(index) if interlace else index
    frame = (b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, lflags) + lp
             + bytes([code_bits]) + _sub_blocks(gif_lzw_bytes(rows, code_bits,
                                                               clear_when_full)))
    out += frame
    if second_frame:
        out += b"," + struct.pack("<HHHHB", 0, 0, 1, 1, 0) + bytes([2]) + _sub_blocks(
            gif_lzw_bytes(np.zeros((1, 1), np.uint8), 2))
    return out + b";"


def _gif_case(seed, h=29, w=37, colours=256):
    r = np.random.RandomState(seed)
    # runs, so that the LZW table grows long strings
    idx = np.repeat(r.randint(0, colours, (h, w // 3 + 1)), 3, axis=1)[:, :w]
    idx[::3, ::5] = r.randint(0, colours, idx[::3, ::5].shape)
    return idx, r.randint(0, 256, (colours, 3))


GIF_VARIANTS = {
    "global": lambda: dict(zip(("index", "palette"), _gif_case(1))),
    "global-interlaced": lambda: dict(zip(("index", "palette"), _gif_case(2)), interlace=True),
    "interlaced-heights": lambda: dict(zip(("index", "palette"), _gif_case(3, h=5, w=7)),
                                       interlace=True),
    "interlaced-1-row": lambda: dict(zip(("index", "palette"), _gif_case(4, h=1, w=9)),
                                     interlace=True),
    "local": lambda: dict(index=_gif_case(5)[0], local_palette=_gif_case(5)[1]),
    "local-over-global": lambda: dict(index=_gif_case(6)[0], palette=_gif_case(7)[1],
                                      local_palette=_gif_case(6)[1]),
    "grey-ramp-palette": lambda: dict(index=_gif_case(8)[0], palette=_grey_ramp(256)),
    "local-grey-ramp-over-global": lambda: dict(index=_gif_case(9)[0],
                                                palette=_gif_case(9)[1],
                                                local_palette=_grey_ramp(256)),
    "no-palette": lambda: dict(index=_gif_case(10)[0]),
    "two-colours": lambda: dict(zip(("index", "palette"), _gif_case(11, colours=2))),
    "16-colours-code-size-8": lambda: dict(zip(("index", "palette"), _gif_case(12, colours=16)),
                                           bits=8),
    "transparency-offset": lambda: dict(zip(("index", "palette"), _gif_case(13, h=20, w=25)),
                                        transparency=7, screen=(37, 29), offset=(5, 4)),
    "frame-beyond-screen": lambda: dict(zip(("index", "palette"), _gif_case(14)),
                                        screen=(20, 10), offset=(3, 2)),
    "background-zero": lambda: dict(zip(("index", "palette"), _gif_case(15, h=10, w=11)),
                                    screen=(30, 20), offset=(9, 6)),
    "full-table-clear": lambda: dict(zip(("index", "palette"), _gif_case(16, h=90, w=97))),
    "full-table-deferred-clear": lambda: dict(zip(("index", "palette"), _gif_case(17, h=90,
                                                                                  w=97)),
                                              clear_when_full=False),
    "extensions-and-second-frame": lambda: dict(zip(("index", "palette"), _gif_case(18)),
                                                extensions=True, second_frame=True,
                                                transparency=3),
    "short-palette-high-indices": lambda: dict(index=_gif_case(19)[0],
                                               palette=_gif_case(19, colours=4)[1]),
}


def gif_refused():
    """(name, file bytes, a word of the refusal) of GIFs PIL refuses."""
    idx, pal = _gif_case(21)
    whole = gif_bytes(idx, pal)
    return [("no-frame", b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b";", "no image"),
            ("truncated", whole[:len(whole) // 2], "truncated")]


# ------------------------------------------------------------------ JPEG

def strip_segments(data, marker):
    """The JPEG without its ``marker`` segments (e.g. 0xCC, DAC: an
    arithmetic-coded file then uses the default conditioning)."""
    out, pos = bytearray(data[:2]), 2
    while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != marker:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + data[pos:])


def patch_sof(data, marker=None, precision=None, height=None):
    """The JPEG with its frame header's marker, precision or height
    rewritten (the entropy-coded data stays as it is)."""
    out = bytearray(data)
    i = next(i for i in range(2, len(out) - 1)
             if out[i] == 0xFF and 0xC0 <= out[i + 1] <= 0xCF and out[i + 1] not in
             (0xC4, 0xC8, 0xCC))
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    if height is not None:
        out[i + 5:i + 7] = struct.pack(">H", height)
    return bytes(out)


def jpeg_page(h, w, channels, seed):
    """Text-like strokes over a smooth background with noise, grey or in
    ``channels`` colours (for CMYK, ink in K over tinted CMY)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 200 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    ink = (np.sin(xx / 2.1 + rng.rand()) > 0.5) & (np.sin(yy / 3.3) > 0.1)
    grey = base - 150 * ink + rng.randn(h, w) * 12
    planes = [grey * (0.7 + 0.1 * k) + 25 * k * np.cos(xx / (5.0 + k))
              for k in range(channels)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


# [(Ss, Se, Ah, Al) per component set] progressive scan scripts whose
# first AC coefficients stop short of full precision: libjpeg smooths them
SMOOTHING_SCRIPTS = {
    "final-al": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 1), ((0,), 1, 5, 2, 1)],
    "bands-never-sent": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 2, 0, 0), ((1,), 1, 63, 0, 0)],
    "dc-only": [((0, 1, 2), 0, 0, 0, 0)],
    "dc-refined-only": [((0, 1, 2), 0, 0, 0, 2), ((0, 1, 2), 0, 0, 2, 1)],
    "dc-and-5-ac": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 0), ((1,), 1, 5, 0, 0),
                    ((2,), 1, 5, 0, 0)],
}


def _j(h, w, channels, seed, **kw):
    return lambda: jpeg_bytes(jpeg_page(h, w, channels, seed), **kw)


JPEG_VARIANTS = {
    # four components: CMYK with and without the Adobe marker, YCCK
    "cmyk-adobe": _j(37, 53, 4, 1),
    "cmyk-no-adobe": _j(37, 53, 4, 2, adobe=False),
    "cmyk-odd-progressive": _j(17, 9, 4, 3, progressive=True),
    "ycck": _j(37, 53, 4, 4, colorspace="ycck"),
    "ycck-subsampled": _j(45, 61, 4, 5, colorspace="ycck",
                          sampling=[(2, 2), (1, 1), (1, 1), (2, 2)]),
    "ycck-restarts": _j(33, 47, 4, 6, colorspace="ycck", restart_interval=2),
    # arithmetic coding: sequential, progressive, DAC conditioning, restarts
    "arith-grey": _j(37, 53, 1, 7, arith=True),
    "arith-420": _j(45, 61, 3, 8, arith=True),
    "arith-444-restarts": _j(33, 47, 3, 9, arith=True, sampling=[(1, 1)] * 3,
                             restart_interval=3),
    "arith-dac": _j(37, 53, 3, 10, arith=True, dac={"dc_L": [2, 1], "dc_U": [5, 3],
                                                     "ac_K": [2, 20]}),
    "arith-no-dac": lambda: strip_segments(jpeg_bytes(jpeg_page(37, 53, 3, 11), arith=True),
                                           0xCC),
    "arith-progressive": _j(45, 61, 3, 12, arith=True, progressive=True),
    "arith-progressive-restarts": _j(37, 53, 3, 13, arith=True, progressive=True,
                                     restart_interval=2),
    "arith-progressive-dac-odd": _j(17, 9, 3, 14, arith=True, progressive=True,
                                    dac={"dc_L": [1], "dc_U": [4], "ac_K": [9, 3]}),
    "arith-cmyk": _j(21, 29, 4, 15, arith=True),
    "arith-transcoded": lambda: jpeg_transcode(jpeg_bytes(jpeg_page(37, 53, 3, 16),
                                                          progressive=True)),
    "sof9-over-huffman-data": lambda: patch_sof(jpeg_bytes(jpeg_page(24, 40, 3, 17)), 0xC9),
    # lossless (SOF3): every predictor, point transforms, subsampling, restarts
    **{f"lossless-p{p}-pt{pt}": _j(23, 31, 3 if p % 2 else 1, 20 + p, lossless=(p, pt))
       for p in range(1, 8) for pt in ((0, 3) if p in (1, 4, 7) else (p % 3,))},
    "lossless-ycc-420": _j(23, 31, 3, 30, lossless=(4, 0), colorspace="ycbcr",
                           sampling=[(2, 2), (1, 1), (1, 1)]),
    "lossless-ycc-mixed-sampling": _j(19, 27, 3, 31, lossless=(6, 1), colorspace="ycbcr",
                                      sampling=[(2, 2), (1, 2), (2, 1)]),
    "lossless-restarts": _j(23, 31, 3, 32, lossless=(5, 0), restart_rows=2),
    "lossless-ids-123-no-jfif": _j(23, 31, 3, 33, lossless=(2, 0), colorspace="ycbcr",
                                   jfif=False),
    "lossless-cmyk": _j(15, 21, 4, 34, lossless=(7, 1)),
    # progressive scripts that libjpeg block-smooths
    **{f"smoothed-{name}": _j(45, 61, 3, 40 + i, progressive=True, scans=script)
       for i, (name, script) in enumerate(SMOOTHING_SCRIPTS.items())},
    "smoothed-grey-2-blocks-wide": _j(17, 9, 1, 46, progressive=True,
                                      scans=[((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 2)]),
    "smoothed-arith": _j(37, 53, 3, 47, arith=True, progressive=True,
                         scans=SMOOTHING_SCRIPTS["final-al"]),
    "smoothed-odd-422": _j(21, 35, 3, 48, progressive=True, sampling=[(2, 1), (1, 1), (1, 1)],
                           scans=SMOOTHING_SCRIPTS["bands-never-sent"]),
    # 4:4:0 (component 0 sampled 1 x 2)
    "h1v2-440": _j(37, 53, 3, 50, sampling=[(1, 2), (1, 1), (1, 1)]),
    "h1v2-440-odd-progressive": _j(17, 9, 3, 51, sampling=[(1, 2), (1, 1), (1, 1)],
                                   progressive=True),
}
# Huffman-coded pages of 128 x 96 as archives hold them (grey, 4:2:0
# colour, progressive colour, grey with restart markers): the bases of the
# damaged-file fuzz of the main path's formats
JPEG_HUFFMAN_VARIANTS = {
    "huffman-grey": _j(96, 128, 1, 70),
    "huffman-420": _j(96, 128, 3, 71, sampling=[(2, 2), (1, 1), (1, 1)]),
    "huffman-progressive": _j(96, 128, 3, 72, progressive=True),
    "huffman-restarts": _j(96, 128, 1, 73, restart_interval=4),
}
JPEG_VARIANTS.update(JPEG_HUFFMAN_VARIANTS)


def _lossless_grey():
    return jpeg_bytes(jpeg_page(16, 16, 1, 60), lossless=(1, 0))


def _baseline_grey():
    return jpeg_bytes(jpeg_page(16, 16, 1, 61))


# (file bytes, a word of the port's refusal); PIL refuses every one
JPEG_REFUSED = {
    "12-bit": (lambda: patch_sof(_baseline_grey(), precision=12), "12-bit"),
    "2-components": (lambda: jpeg_bytes(jpeg_page(16, 16, 2, 62)), "2-component"),
    "dnl-height-0": (lambda: patch_sof(_baseline_grey(), height=0), "DNL"),
    **{f"hierarchical-sof{m - 0xC0}": (lambda m=m: patch_sof(_baseline_grey(), m),
                                        "hierarchical")
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "lossless-arithmetic-sof11": (lambda: patch_sof(_lossless_grey(), 0xCB),
                                  "arithmetic-coded lossless"),
    "lossless-sof3-over-dct-scans": (lambda: patch_sof(_baseline_grey(), 0xC3),
                                     "lossless scan parameters"),
}


# ------------------------------------------------------------------ WebP

@functools.cache
def webp_encoder() -> ctypes.CDLL:
    """``scripts/webp_test_encoder.c`` built with gcc (into ``build/``,
    keyed by the source's hash) against the libwebp Pillow bundles, which
    is loaded first so that the helper's calls resolve to it."""
    import hashlib
    import subprocess
    import tempfile

    import PIL
    from PIL import Image  # noqa: F401
    root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(root, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    ctypes.CDLL(glob.glob(os.path.join(root, "libwebp-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    src = os.path.join(REPO, "scripts", "webp_test_encoder.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(REPO, "build", "test_encoders")
    so = os.path.join(out_dir, f"webp_test_encoder_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        subprocess.run([os.environ.get("CC", "gcc"), "-O1", "-shared", "-fPIC", src, "-o", tmp],
                       check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    ptr = ctypes.c_void_p
    lib.wenc_encode.argtypes = [ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr,
                                ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_size_t)]
    lib.wenc_free.argtypes = [ptr]
    return lib


WEBP_OPTIONS = ("quality", "method", "filter_type", "filter_strength", "filter_sharpness",
                "partitions", "segments", "sns_strength", "alpha_compression",
                "alpha_filtering", "alpha_quality", "exact", "near_lossless", "image_hint")


def webp_bytes(samples, lossless=False, **options):
    """A WebP of ``samples`` ([h, w] grey, [h, w, 3] RGB or [h, w, 4] RGBA
    uint8; an alpha of all 255 is written as none) by Pillow's libwebp,
    with the ``WEBP_OPTIONS`` of its WebPConfig (``quality`` a float)."""
    px = np.ascontiguousarray(samples, np.uint8)
    if px.ndim == 2:
        px = np.repeat(px[..., None], 3, axis=-1)
    if px.shape[2] == 3:
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    px = np.ascontiguousarray(px)
    unknown = set(options) - set(WEBP_OPTIONS)
    if unknown:
        raise ValueError(f"unknown WebP options {sorted(unknown)}")
    opts = [-1] * len(WEBP_OPTIONS)
    for name, value in options.items():
        if name == "quality":
            value = round(value * 100)
        opts[WEBP_OPTIONS.index(name)] = int(value)
    arr = (ctypes.c_int * len(opts))(*opts)
    out, size = ctypes.c_void_p(), ctypes.c_size_t()
    lib = webp_encoder()
    h, w = px.shape[:2]
    rc = lib.wenc_encode(px.ctypes.data, w, h, int(lossless), ctypes.cast(arr, ctypes.c_void_p),
                         ctypes.byref(out), ctypes.byref(size))
    if rc:
        raise ValueError(f"WebPEncode failed ({rc})")
    data = ctypes.string_at(out, size.value)
    lib.wenc_free(out)
    return data


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """One RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff_webp(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(data: bytes):
    """[(tag, payload)] of a WebP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_image_chunk(data: bytes) -> bytes:
    """The "VP8 " or "VP8L" chunk of an encoder's file, header included."""
    for tag, payload in webp_chunks(data):
        if tag in (b"VP8 ", b"VP8L"):
            return webp_chunk(tag, payload)
    raise ValueError("no image chunk")


# VP8X feature flags
WEBP_ANIMATION, WEBP_XMP, WEBP_EXIF, WEBP_ALPHA, WEBP_ICCP = 0x02, 0x04, 0x08, 0x10, 0x20


def vp8x_chunk(flags, w, h):
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + struct.pack("<I", w - 1)[:3]
                      + struct.pack("<I", h - 1)[:3])


def alpha_filter(alpha, method):
    """libwebp's forward alpha filters (0 none, 1 horizontal, 2 vertical,
    3 gradient): the first row is predicted from its left neighbour (0
    before the first pixel), the first column from the pixel above."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    if method == 0:
        pred[:] = 0
    return ((a - pred) & 255).astype(np.uint8)


def alph_chunk(alpha, compression, method, pre_processing=0):
    """An ALPH chunk of ``alpha`` ([h, w] uint8) written byte by byte:
    raw (0) or VP8L-compressed (1, a lossless picture whose green channel
    holds the filtered plane, its 5-byte VP8L header cut) under filter
    ``method``."""
    deltas = alpha_filter(alpha, method)
    if compression == 0:
        body = deltas.tobytes()
    else:
        vp8l = webp_image_chunk(webp_bytes(deltas, lossless=True, exact=1))
        n = struct.unpack_from("<I", vp8l, 4)[0]
        body = vp8l[8 + 5:8 + n]
    return webp_chunk(b"ALPH", bytes([compression | method << 2 | pre_processing << 4]) + body)


def anmf_chunk(x, y, w, h, frame: bytes):
    """An animation frame at (x, y) (even offsets), 100 ms, holding
    ``frame``'s ALPH / image chunks."""
    le24 = [struct.pack("<I", v)[:3] for v in (x // 2, y // 2, w - 1, h - 1, 100)]
    return webp_chunk(b"ANMF", b"".join(le24) + b"\0" + frame)


def webp_source(h, w, kind, seed):
    """Pixels of a test picture: "grey" (a page: paper with strokes and
    noise), "colour" (ramps and noise), "alpha" (colour over a varying
    alpha) or "palette-N" (N colours)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "grey":
        px = 235 + rng.randint(0, 20, (h, w))
        px[(yy // 3 + xx // 5) % 7 == 0] = 20 + rng.randint(0, 40)
        return px.clip(0, 255).astype(np.uint8)
    if kind.startswith("palette-"):
        n = int(kind.split("-")[1])
        colours = rng.randint(0, 256, (n, 3))
        return colours[(yy * 7 + xx * 3 + rng.randint(0, 2, (h, w))) % n].astype(np.uint8)
    base = (yy * 3 + xx * 5)[..., None] + 40 * np.arange(3)
    px = ((base + rng.randint(0, 60, (h, w, 3))) % 256).astype(np.uint8)
    if kind == "alpha":
        alpha = ((yy * 255 // max(h - 1, 1) + rng.randint(0, 16, (h, w))) % 256)
        alpha[: h // 3] = 255
        return np.concatenate([px, alpha[..., None].astype(np.uint8)], axis=-1)
    return px


def _lossy_alpha(h, w, seed, compression, method, pre_processing=0):
    """VP8X + a byte-written ALPH chunk + the encoder's VP8 frame."""
    px = webp_source(h, w, "alpha", seed)
    vp8 = webp_image_chunk(webp_bytes(px[..., :3], quality=75))
    return riff_webp(vp8x_chunk(WEBP_ALPHA, w, h),
                     alph_chunk(px[..., 3], compression, method, pre_processing), vp8)


def _with_chunks(data, flags, before=(), after=()):
    """A simple file re-wrapped as VP8X with extra chunks around its
    image chunk."""
    (w, h) = _webp_size(data)
    return riff_webp(vp8x_chunk(flags, w, h), *before, webp_image_chunk(data), *after)


def _webp_size(data):
    from PIL import Image
    import io
    with Image.open(io.BytesIO(data)) as im:
        return im.size


def _animation(canvas, frames, flags=0):
    """VP8X (animation) + ANIM (an opaque blue background, which PIL does
    not paint) + ANMF chunks: ``frames`` of (x, y, file bytes of a still
    frame, with_alpha)."""
    cw, ch = canvas
    anmfs = []
    for x, y, data, alpha in frames:
        w, h = _webp_size(data)
        body = b"".join(webp_chunk(t, p) for t, p in webp_chunks(data)
                        if t in (b"ALPH", b"VP8 ", b"VP8L") and (alpha or t != b"ALPH"))
        anmfs.append(anmf_chunk(x, y, w, h, body))
    return riff_webp(vp8x_chunk(WEBP_ANIMATION | flags, cw, ch),
                     webp_chunk(b"ANIM", struct.pack("<IH", 0xff336699, 0)), *anmfs)


def _w(h, w, kind, seed, lossless=False, **options):
    return lambda: webp_bytes(webp_source(h, w, kind, seed), lossless, **options)


WEBP_VARIANTS = {
    # VP8 (lossy): sizes, quality, the loop filter, partitions, segments
    "vp8-1x1": _w(1, 1, "colour", 1, quality=75),
    "vp8-17x3": _w(3, 17, "colour", 2, quality=75),
    "vp8-3x17-grey": _w(17, 3, "grey", 3, quality=75),
    "vp8-33x47": _w(47, 33, "colour", 4, quality=75),
    "vp8-q0": _w(45, 67, "colour", 5, quality=0),
    "vp8-q100": _w(45, 67, "colour", 6, quality=100),
    "vp8-grey-page": _w(61, 83, "grey", 7, quality=90),
    "vp8-filter-simple": _w(45, 67, "colour", 8, quality=60, filter_type=0, filter_strength=80),
    "vp8-filter-normal": _w(45, 67, "colour", 9, quality=60, filter_type=1, filter_strength=80),
    "vp8-filter-none": _w(45, 67, "colour", 10, quality=60, filter_strength=0),
    "vp8-sharpness-0": _w(45, 67, "grey", 11, quality=50, filter_type=1, filter_strength=60,
                          filter_sharpness=0),
    "vp8-sharpness-7": _w(45, 67, "grey", 12, quality=50, filter_type=1, filter_strength=60,
                          filter_sharpness=7),
    "vp8-simple-sharpness-5": _w(45, 67, "grey", 13, quality=40, filter_type=0,
                                 filter_strength=100, filter_sharpness=5),
    **{f"vp8-partitions-{1 << p}": _w(150, 70, "colour", 14 + p, quality=70, partitions=p)
       for p in range(4)},
    "vp8-segments-1": _w(64, 96, "colour", 18, quality=70, segments=1),
    "vp8-segments-4-sns": _w(64, 96, "colour", 19, quality=70, segments=4, sns_strength=100),
    "vp8-sns-0": _w(64, 96, "grey", 20, quality=70, sns_strength=0),
    "vp8-method-0": _w(50, 70, "colour", 21, quality=80, method=0),
    "vp8-method-6": _w(50, 70, "colour", 22, quality=80, method=6),
    # lossy with alpha: ALPH raw and VP8L-compressed, each filter method
    **{f"alph-raw-filter{m}": (lambda m=m: _lossy_alpha(35, 45, 30 + m, 0, m)) for m in range(4)},
    **{f"alph-vp8l-filter{m}": (lambda m=m: _lossy_alpha(35, 45, 34 + m, 1, m))
       for m in range(4)},
    "alph-preprocessing-bit": lambda: _lossy_alpha(35, 45, 38, 1, 2, pre_processing=1),
    "alph-encoder-default": _w(40, 50, "alpha", 39, quality=75),
    "alph-encoder-best-filter": _w(40, 50, "alpha", 40, quality=75, alpha_filtering=2),
    "alph-encoder-raw": _w(40, 50, "alpha", 41, quality=75, alpha_compression=0),
    "alph-encoder-quality-30": _w(40, 50, "alpha", 42, quality=75, alpha_quality=30),
    # VP8L (lossless)
    "vp8l-1x1": _w(1, 1, "colour", 50, lossless=True),
    "vp8l-17x3": _w(3, 17, "colour", 51, lossless=True),
    "vp8l-method-0": _w(45, 67, "colour", 52, lossless=True, method=0),
    "vp8l-method-6": _w(45, 67, "colour", 53, lossless=True, method=6, quality=100),
    "vp8l-grey": _w(61, 83, "grey", 54, lossless=True),
    "vp8l-alpha-exact": _w(40, 50, "alpha", 55, lossless=True, exact=1),
    "vp8l-alpha": _w(40, 50, "alpha", 56, lossless=True),
    "vp8l-near-lossless-60": _w(45, 67, "colour", 57, lossless=True, near_lossless=60),
    **{f"vp8l-palette-{n}": _w(37, 53, f"palette-{n}", 58 + i, lossless=True)
       for i, n in enumerate((2, 3, 4, 11, 16, 256))},
    "vp8l-colours-300": _w(37, 53, "palette-300", 64, lossless=True),
    **{f"vp8l-hint-{name}": _w(45, 67, "colour", 65 + i, lossless=True, image_hint=i + 1)
       for i, name in enumerate(("picture", "photo", "graph"))},
    # containers written around the encoder's frames
    "vp8x-iccp-exif-xmp-unknown": lambda: _with_chunks(
        webp_bytes(webp_source(33, 47, "colour", 70), quality=75),
        WEBP_ICCP | WEBP_EXIF | WEBP_XMP,
        before=(webp_chunk(b"ICCP", bytes(range(131))),),
        after=(webp_chunk(b"EXIF", b"Exif\0\0MM\0*" + bytes(7)),
               webp_chunk(b"XMP ", b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"),
               webp_chunk(b"ABCD", b"odd"))),
    "vp8x-lossless": lambda: _with_chunks(
        webp_bytes(webp_source(33, 47, "colour", 71), lossless=True), 0),
    "vp8x-lossless-alpha": lambda: _with_chunks(
        webp_bytes(webp_source(33, 47, "alpha", 72), lossless=True, exact=1), WEBP_ALPHA),
    "vp8x-alph-without-alpha-flag": lambda: riff_webp(
        *[c if not c.startswith(b"VP8X") else vp8x_chunk(0, 45, 35)
          for c in _split_chunks(_lossy_alpha(35, 45, 73, 1, 1))]),
    "vp8x-unknown-odd-chunks": lambda: _with_chunks(
        webp_bytes(webp_source(29, 31, "grey", 74), quality=80), 0,
        before=(webp_chunk(b"abcd", b"x"), webp_chunk(b"wxyz", b"12345")),
        after=(webp_chunk(b"odd1", b"abc"),)),
    "vp8x-vp8l-alpha-hint-without-flag": lambda: _with_chunks(
        webp_bytes(webp_source(33, 47, "alpha", 82), lossless=True, exact=1), 0),
    "vp8x-alpha-flag-opaque-vp8l": lambda: _with_chunks(
        webp_bytes(webp_source(33, 47, "colour", 83), lossless=True), WEBP_ALPHA),
    "vp8x-alpha-flag-without-alph": lambda: _with_chunks(
        webp_bytes(webp_source(33, 47, "colour", 84), quality=70), WEBP_ALPHA),
    # an ALPH chunk after the frame: ignored, and no "RGBA" mode (libwebp
    # looks for alpha only before the frame of an extended file)
    "simple-vp8-then-alph": lambda: riff_webp(
        webp_image_chunk(webp_bytes(webp_source(29, 31, "colour", 85), quality=80)),
        alph_chunk(np.full((29, 31), 200, np.uint8), 0, 0)),
    "vp8x-vp8-then-alph-without-flag": lambda: riff_webp(
        vp8x_chunk(0, 31, 29),
        webp_image_chunk(webp_bytes(webp_source(29, 31, "colour", 86), quality=80)),
        alph_chunk(np.full((29, 31), 200, np.uint8), 0, 0)),
    "simple-trailing-chunk": lambda: riff_webp(
        webp_image_chunk(webp_bytes(webp_source(29, 31, "colour", 75), quality=80)),
        webp_chunk(b"EXIF", b"trailing")),
    "trailing-bytes-after-riff": lambda: webp_bytes(webp_source(29, 31, "colour", 76),
                                                    quality=80) + b"junk after the RIFF chunk",
    "anim-first-frame-offset": lambda: _animation((60, 50), [
        (6, 10, webp_bytes(webp_source(31, 41, "colour", 77), quality=80), False),
        (0, 0, webp_bytes(webp_source(50, 60, "colour", 78), quality=80), False)]),
    "anim-offset-alpha": lambda: _animation((64, 48), [
        (8, 4, webp_bytes(webp_source(30, 40, "alpha", 79), quality=80), True)], WEBP_ALPHA),
    "anim-lossless-offset": lambda: _animation((52, 44), [
        (12, 2, webp_bytes(webp_source(33, 27, "colour", 80), lossless=True), False)]),
    "anim-lossless-alpha-offset": lambda: _animation((52, 44), [
        (2, 14, webp_bytes(webp_source(23, 37, "alpha", 81), lossless=True, exact=1), False)],
        WEBP_ALPHA),
}


def _split_chunks(data):
    return [webp_chunk(t, p) for t, p in webp_chunks(data)]


def webp_refused(lossy: bytes, lossless: bytes):
    """[(name, file bytes, a word of the port's refusal)]: hand-made header
    faults, built from a simple lossy and a simple lossless file, that PIL
    refuses too."""
    vp8_at = lossy.index(b"VP8 ") + 8
    vp8l_at = lossless.index(b"VP8L") + 8

    def patch(data, at, new):
        return data[:at] + new + data[at + len(new):]
    w = (struct.unpack_from("<H", lossy, vp8_at + 6)[0] & 0x3fff)
    h = (struct.unpack_from("<H", lossy, vp8_at + 8)[0] & 0x3fff)
    wide = riff_webp(vp8x_chunk(0, w + 1, h), webp_image_chunk(lossy))
    return [
        ("bad-vp8-start-code", patch(lossy, vp8_at + 3, b"\x9d\x01\x2b"), "start code"),
        ("bad-vp8l-signature", patch(lossless, vp8l_at, b"\x2e"), "signature"),
        ("vp8-zero-width", patch(lossy, vp8_at + 6, b"\0\0"), "0 x"),
        ("vp8-not-a-key-frame", patch(lossy, vp8_at, bytes([lossy[vp8_at] | 1])), "key frame"),
        ("chunk-size-past-the-end", patch(lossy, vp8_at - 4, struct.pack("<I", len(lossy))),
         "past the end"),
        ("riff-size-past-the-end", patch(lossy, 4, struct.pack("<I", len(lossy))), "truncated"),
        ("vp8x-canvas-not-frame-size", wide, "canvas"),
        ("vp8x-reserved-flag", patch(riff_webp(vp8x_chunk(0, w, h), webp_image_chunk(lossy)),
                                     20, b"\x01"), "reserved"),
        ("vp8x-chunk-of-12-bytes", riff_webp(
            webp_chunk(b"VP8X", vp8x_chunk(0, w, h)[8:] + b"\0\0"), webp_image_chunk(lossy)),
         "VP8X chunk"),
        ("binary-chunk-tag-past-the-end", riff_webp(
            vp8x_chunk(0, w, h), webp_image_chunk(lossy),
            b"\xa4\xff\x00\x01" + struct.pack("<I", 1000) + bytes(8)), "past the end"),
        ("canvas-past-pils-pixel-limit", riff_webp(
            vp8x_chunk(WEBP_ANIMATION, 16384, 16384),
            webp_chunk(b"ANIM", struct.pack("<IH", 0, 0)),
            anmf_chunk(0, 0, w, h, webp_image_chunk(lossy))), "decompression bomb"),
        ("riff-wave", b"RIFF" + struct.pack("<I", 28) + b"WAVEfmt " + bytes(24),
         "RIFF, not WebP"),
        ("first-chunk-alph", riff_webp(webp_chunk(b"ALPH", b"\0" * 10),
                                       webp_image_chunk(lossy)), "first chunk"),
        ("alph-before-vp8l", riff_webp(vp8x_chunk(WEBP_ALPHA, *_vp8l_size(lossless)),
                                       webp_chunk(b"ALPH", b"\0" * 10),
                                       webp_image_chunk(lossless)), "ALPH"),
    ]


def _vp8l_size(data):
    bits = struct.unpack_from("<I", data, data.index(b"VP8L") + 9)[0]
    return (bits & 0x3fff) + 1, ((bits >> 14) & 0x3fff) + 1


# ------------------------------------------------------------------ JPEG 2000

@functools.cache
def jpeg2000_encoder() -> ctypes.CDLL:
    """``scripts/jpeg2000_test_encoder.c`` built with gcc (into ``build/``,
    keyed by the source's hash) against the libopenjp2 Pillow bundles,
    which is loaded first so that the helper's calls resolve to it; the
    offsets of ``CPARAM_INTS`` are checked against the library's defaults."""
    import hashlib
    import subprocess
    import tempfile

    import PIL
    from PIL import Image  # noqa: F401
    root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    opj = ctypes.CDLL(glob.glob(os.path.join(root, "libopenjp2-*.so*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    defaults = (ctypes.c_int32 * (CPARAM_SIZE // 4))()
    opj.opj_set_default_encoder_parameters(defaults)
    for name, want in (("numresolution", 6), ("cblockw_init", 64), ("cblockh_init", 64),
                       ("roi_compno", -1), ("mode", 0), ("irreversible", 0)):
        if defaults[CPARAM_INTS[name]] != want:
            raise RuntimeError(f"opj_cparameters_t.{name} is not at int "
                               f"{CPARAM_INTS[name]} in this libopenjp2")
    src = os.path.join(REPO, "scripts", "jpeg2000_test_encoder.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(REPO, "build", "test_encoders")
    so = os.path.join(out_dir, f"jpeg2000_test_encoder_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        subprocess.run([os.environ.get("CC", "gcc"), "-O1", "-shared", "-fPIC", src, "-o", tmp],
                       check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    ptr = ctypes.c_void_p
    lib.jenc_encode.argtypes = [ptr, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                                ctypes.c_uint32, ctypes.c_int, ptr, ctypes.c_int, ctypes.c_int,
                                ptr, ctypes.c_int, ptr, ctypes.c_int, ptr, ctypes.POINTER(ptr),
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.jenc_error.restype = ctypes.c_char_p
    lib.jenc_free.argtypes = [ptr]
    return lib


# OpenJPEG 2.5's opj_cparameters_t: its size and the int offsets of the
# fields set here (each opj_poc_t of POC[32] is 37 ints), and the byte
# offsets of its char fields
CPARAM_SIZE = 18720
CPARAM_INTS = {"tile_size_on": 0, "cp_tx0": 1, "cp_ty0": 2, "cp_tdx": 3, "cp_tdy": 4,
               "cp_disto_alloc": 5, "cp_fixed_quality": 7, "csty": 12, "prog_order": 13,
               "POC": 14, "numpocs": 1198, "tcp_numlayers": 1199, "tcp_rates": 1200,
               "tcp_distoratio": 1300, "numresolution": 1400, "cblockw_init": 1401,
               "cblockh_init": 1402, "mode": 1403, "irreversible": 1404, "roi_compno": 1405,
               "roi_shift": 1406, "res_spec": 1407, "prcw_init": 1408, "prch_init": 1441}
CPARAM_BYTES = {"tp_on": 18696, "tp_flag": 18697, "tcp_mct": 18698}
POC_INTS, POC_FIELDS = 37, {"resno0": 0, "compno0": 1, "layno1": 2, "resno1": 3, "compno1": 4,
                            "prg1": 8, "tile": 12}
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
CBLK_STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32}
COLOR_SPACES = {"unspecified": 0, "srgb": 1, "grey": 2, "sycc": 3, "cmyk": 5}


def _f32_bits(v):
    return struct.unpack("<i", struct.pack("<f", v))[0]


def jpeg2000_bytes(planes, *, dxdy=None, precision=8, signed=False, offset=(0, 0), jp2=False,
                   color_space="unspecified", levels=5, cblk=(64, 64), styles=(), sop=False,
                   eph=False, irreversible=False, rates=None, psnr=None, progression="LRCP",
                   pocs=(), tile=None, tile_offset=(0, 0), precincts=None, mct=False,
                   roi=None, tile_parts=None, plt=False, tlm=False):
    """A JPEG 2000 codestream (or JP2 file) of ``planes`` (one int array per
    component, each of its component's size) by Pillow's libopenjp2, with
    the settings PIL's save hides: per-component subsampling ``dxdy``,
    ``precision`` and ``signed`` (a value or one per component), the
    code-block ``styles`` (names of ``CBLK_STYLES``), SOP / EPH markers,
    the ROI ``(component, shift)``, precinct sizes (one (w, h) per
    resolution, highest first), progression order changes ``pocs``
    ((resno0, compno0, layno1, resno1, compno1, order) each), tile-parts
    split by "R", "L" or "C", and PLT / TLM markers."""
    nc = len(planes)
    dxdy = dxdy or [(1, 1)] * nc
    prec = precision if isinstance(precision, (list, tuple)) else [precision] * nc
    sgnd = signed if isinstance(signed, (list, tuple)) else [signed] * nc
    x0, y0 = offset
    x1 = _grid_end([p.shape[1] for p in planes], [d[0] for d in dxdy], x0)
    y1 = _grid_end([p.shape[0] for p in planes], [d[1] for d in dxdy], y0)
    comps = []
    for (dx, dy), p_, s in zip(dxdy, prec, sgnd):
        comps += [dx, dy, p_, int(s)]
    samples = np.concatenate([np.ascontiguousarray(p, np.int32).ravel() for p in planes])
    ints = {"numresolution": levels + 1, "cblockw_init": cblk[0], "cblockh_init": cblk[1],
            "mode": sum(CBLK_STYLES[s] for s in styles), "irreversible": int(irreversible),
            "prog_order": PROGRESSIONS.index(progression),
            "csty": (2 if sop else 0) | (4 if eph else 0) | (1 if precincts else 0)}
    sets = list(ints.items())
    if psnr:
        sets += [("cp_fixed_quality", 1), ("tcp_numlayers", len(psnr))]
        sets += [(CPARAM_INTS["tcp_distoratio"] + i, _f32_bits(v)) for i, v in enumerate(psnr)]
    else:
        rates = rates or [0]
        sets += [("cp_disto_alloc", 1), ("tcp_numlayers", len(rates))]
        sets += [(CPARAM_INTS["tcp_rates"] + i, _f32_bits(v)) for i, v in enumerate(rates)]
    if tile:
        sets += [("tile_size_on", 1), ("cp_tdx", tile[0]), ("cp_tdy", tile[1]),
                 ("cp_tx0", tile_offset[0]), ("cp_ty0", tile_offset[1])]
    if precincts:
        sets += [("res_spec", len(precincts))]
        sets += [(CPARAM_INTS["prcw_init"] + i, w) for i, (w, _) in enumerate(precincts)]
        sets += [(CPARAM_INTS["prch_init"] + i, h) for i, (_, h) in enumerate(precincts)]
    if roi:
        sets += [("roi_compno", roi[0]), ("roi_shift", roi[1])]
    for i, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
        base = CPARAM_INTS["POC"] + i * POC_INTS
        for name, v in (("resno0", r0), ("compno0", c0), ("layno1", l1), ("resno1", r1),
                        ("compno1", c1), ("prg1", PROGRESSIONS.index(order)), ("tile", 1)):
            sets.append((base + POC_FIELDS[name], v))
    if pocs:
        sets.append(("numpocs", len(pocs)))
    int_sets = [(CPARAM_INTS[k] if isinstance(k, str) else k, v) for k, v in sets]
    byte_sets = [(CPARAM_BYTES["tcp_mct"], int(mct))]
    if tile_parts:
        byte_sets += [(CPARAM_BYTES["tp_on"], 1), (CPARAM_BYTES["tp_flag"], ord(tile_parts))]
    extra = [o for o, on in (("PLT=YES", plt), ("TLM=YES", tlm)) if on]
    lib = jpeg2000_encoder()
    iarr = (ctypes.c_int * (2 * len(int_sets)))(*[v for pair in int_sets for v in pair])
    barr = (ctypes.c_int * (2 * len(byte_sets)))(*[v for pair in byte_sets for v in pair])
    carr = (ctypes.c_int * len(comps))(*comps)
    earr = (ctypes.c_char_p * (len(extra) + 1))(*[o.encode() for o in extra], None)
    out, size = ctypes.c_void_p(), ctypes.c_size_t()
    rc = lib.jenc_encode(samples.ctypes.data, x0, y0, x1, y1, nc, ctypes.cast(carr, ctypes.c_void_p),
                         COLOR_SPACES[color_space], int(jp2), ctypes.cast(iarr, ctypes.c_void_p),
                         len(int_sets), ctypes.cast(barr, ctypes.c_void_p), len(byte_sets),
                         ctypes.cast(earr, ctypes.c_void_p) if extra else None,
                         ctypes.byref(out), ctypes.byref(size))
    if rc:
        raise ValueError(f"OpenJPEG's encoder failed ({rc}): {lib.jenc_error().decode().strip()}")
    data = ctypes.string_at(out, size.value)
    lib.jenc_free(out)
    return data


def _grid_end(sizes, steps, start):
    """The smallest end of the reference grid from ``start`` whose
    components, one sample every ``steps``, have ``sizes`` samples."""
    lo = max((n + -(-start // d) - 1) * d + 1 for n, d in zip(sizes, steps))
    hi = min((n + -(-start // d)) * d for n, d in zip(sizes, steps))
    if lo > hi:
        raise ValueError(f"no reference grid gives components of {sizes} samples")
    return max(lo, start + 1)


def j2k_parse(cs: bytes):
    """A codestream as (main-header markers, tile-parts, tail): markers are
    (code, body) pairs, each tile-part (Isot, TPsot, TNsot, header markers,
    data), the tail whatever follows the last tile-part (EOC)."""
    assert cs[:2] == b"\xff\x4f"
    pos, main = 2, []
    while cs[pos:pos + 2] != b"\xff\x90":
        code, length = struct.unpack_from(">HH", cs, pos)
        main.append((code, cs[pos + 4:pos + 2 + length]))
        pos += 2 + length
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        _, _, isot, psot, tpsot, tnsot = struct.unpack_from(">HHHIBB", cs, pos)
        end = pos + psot
        pos += 12
        markers = []
        while cs[pos:pos + 2] != b"\xff\x93":
            code, length = struct.unpack_from(">HH", cs, pos)
            markers.append((code, cs[pos + 4:pos + 2 + length]))
            pos += 2 + length
        parts.append((isot, tpsot, tnsot, markers, cs[pos + 2:end]))
        pos = end
    return main, parts, cs[pos:]


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def j2k_build(main, parts, tail=b"\xff\xd9") -> bytes:
    """The codestream of ``j2k_parse``'s pieces, each Psot recomputed."""
    out = [b"\xff\x4f"] + [_marker(c, b) for c, b in main]
    for isot, tpsot, tnsot, markers, data in parts:
        header = b"".join(_marker(c, b) for c, b in markers)
        psot = 12 + len(header) + 2 + len(data)
        out.append(struct.pack(">HHHIBB", 0xff90, 10, isot, psot, tpsot, tnsot) + header
                   + b"\xff\x93" + data)
    return b"".join(out) + tail


def plt_lengths(markers):
    """The packet lengths of a tile-part's PLT markers."""
    out, v = [], 0
    for code, body in markers:
        if code != 0xff58:
            continue
        for b in body[1:]:
            v = (v << 7) | (b & 0x7f)
            if not b & 0x80:
                out.append(v)
                v = 0
    return out


def _plt_body(index: int, lengths) -> bytes:
    out = bytearray([index])
    for n in lengths:
        groups = []
        while True:
            groups.append(n & 0x7f)
            n >>= 7
            if not n:
                break
        for i, g in enumerate(reversed(groups)):
            out.append(g | (0x80 if i < len(groups) - 1 else 0))
    return bytes(out)


def split_packets(data: bytes, lengths):
    out, pos = [], 0
    for n in lengths:
        out.append(data[pos:pos + n])
        pos += n
    assert pos == len(data), (pos, len(data))
    return out


def packed_headers(cs: bytes, where: str) -> bytes:
    """``cs`` (written with SOP, EPH and PLT markers, one tile) with its
    packet headers moved into PPM markers of the main header (``where`` =
    "ppm") or PPT markers of the tile-part headers ("ppt"): each packet's
    header runs from after its SOP marker through its EPH marker. The tile
    is split into two tile-parts, and the headers over two markers."""
    main, parts, tail = j2k_parse(cs)
    assert len(parts) == 1
    isot, _, _, markers, data = parts[0]
    packets = split_packets(data, plt_lengths(markers))
    heads, bodies = [], []
    for p in packets:
        assert p[:2] == b"\xff\x91"
        eph = p.index(b"\xff\x92", 6) + 2
        heads.append(p[6:eph])
        bodies.append(p[:6] + p[eph:])
    half = len(packets) // 2
    groups = [(0, half), (half, len(packets))]
    new_parts = []
    if where == "ppm":
        ippm = b"".join(struct.pack(">I", sum(len(h) for h in heads[a:b]))
                        + b"".join(heads[a:b]) for a, b in groups)
        cut = len(ippm) // 2
        main = main + [(0xff60, b"\x00" + ippm[:cut]), (0xff60, b"\x01" + ippm[cut:])]
        for k, (a, b) in enumerate(groups):
            new_parts.append((isot, k, 2, [], b"".join(bodies[a:b])))
    else:
        for k, (a, b) in enumerate(groups):
            hs = b"".join(heads[a:b])
            cut = len(hs) // 2
            ppt = [(0xff61, bytes([2 * k]) + hs[:cut]), (0xff61, bytes([2 * k + 1]) + hs[cut:])]
            new_parts.append((isot, k, 2, ppt, b"".join(bodies[a:b])))
    return j2k_build(main, new_parts, tail)


def interleaved_tile_parts(cs: bytes) -> bytes:
    """``cs`` (written with tiles and PLT markers) with each tile split into
    two tile-parts at a packet boundary, all first parts before all second
    ones (TNsot 2, the second part's PLT dropped)."""
    main, parts, tail = j2k_parse(cs)
    first, second = [], []
    for isot, _, _, markers, data in parts:
        packets = split_packets(data, plt_lengths(markers))
        half = max(1, len(packets) // 2)
        keep = [(c, b) for c, b in markers if c != 0xff58]
        first.append((isot, 0, 2, keep + [(0xff58, _plt_body(0, map(len, packets[:half])))],
                      b"".join(packets[:half])))
        second.append((isot, 1, 2, [], b"".join(packets[half:])))
    return j2k_build(main, first + second, tail)


def jp2_box(kind: bytes, payload: bytes, xl: bool = False) -> bytes:
    if xl:
        return struct.pack(">I", 1) + kind + struct.pack(">Q", len(payload) + 16) + payload
    return struct.pack(">I", len(payload) + 8) + kind + payload


def jp2_file(cs: bytes, *, nc: int, bpc: int, header=None, colr=None, brand=b"jp2 ",
             compat=(b"jp2 ",), before=(), after=(), jp2c_length=None, size=None) -> bytes:
    """A JP2 file around codestream ``cs``, byte by byte: the signature and
    file type boxes, a jp2h box of ihdr (``nc`` components of ``bpc``), a
    colr box (``colr``: an enumerated colour space number, bytes of an ICC
    profile, or None for none) and the boxes of ``header``, then ``before``
    boxes, the codestream box (``jp2c_length``: 0 for "to the end", "xl"
    for an XLBox) and ``after`` boxes."""
    _, _, tail = j2k_parse(cs)
    xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", cs, 8)
    w, h = size or (xsiz - xo, ysiz - yo)
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    boxes = [ihdr]
    if isinstance(colr, int):
        boxes.append(jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr)))
    elif colr is not None:
        boxes.append(jp2_box(b"colr", bytes([2, 0, 0]) + colr))
    boxes += list(header or ())
    ftyp = jp2_box(b"ftyp", brand + struct.pack(">I", 0) + b"".join(compat))
    if jp2c_length == 0:
        jp2c = struct.pack(">I", 0) + b"jp2c" + cs
    else:
        jp2c = jp2_box(b"jp2c", cs, xl=jp2c_length == "xl")
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + ftyp + jp2_box(b"jp2h", b"".join(boxes))
            + b"".join(before) + jp2c + b"".join(after))


def pclr_box(palette, depths=None) -> bytes:
    palette = np.asarray(palette, np.uint8)
    ne, npc = palette.shape
    depths = depths or [7] * npc
    return jp2_box(b"pclr", struct.pack(">HB", ne, npc) + bytes(depths) + palette.tobytes())


def cmap_box(entries) -> bytes:
    """(component, mapping type, palette column) per output channel."""
    return jp2_box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef_box(entries) -> bytes:
    """(channel, type, association) per channel."""
    return jp2_box(b"cdef", struct.pack(">H", len(entries))
                   + b"".join(struct.pack(">HHH", *e) for e in entries))


def jpeg2000_planes(h, w, nc, seed, bits=8, signed=False, dxdy=None):
    """Component planes of a test picture (ramps and noise) on an h x w
    grid: ``bits``-bit samples, signed or not, each component subsampled
    by its ``dxdy``."""
    rng = np.random.RandomState(seed)
    out = []
    for c, (dx, dy) in enumerate(dxdy or [(1, 1)] * nc):
        yy, xx = np.mgrid[0:-(-h // dy), 0:-(-w // dx)]
        ramp = (yy * 7 + xx * 3) * max(1, (1 << bits) // 256) + c * (1 << bits) // 5
        v = (ramp + rng.randint(0, max(2, (1 << bits) // 6), yy.shape)) % (1 << bits)
        out.append(v - (1 << (bits - 1)) if signed else v)
    return out


def _jp(h, w, nc, seed, **kw):
    return lambda: jpeg2000_bytes(jpeg2000_planes(h, w, nc, seed), **kw)


_SUB420 = [(1, 1), (2, 2), (2, 2)]
_PAGE_PCLR = np.random.RandomState(7).randint(0, 256, (40, 3))
_PAGE_PCLR[11] = _PAGE_PCLR[4]        # a repeated colour: PIL's palette keeps one
_CMAP3 = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]


def _pclr(nc, ncolours=48, seed=90):
    """A palette image: an index plane (values past the palette too) and,
    for ``nc`` = 2, an alpha plane, in a JP2 file with pclr and cmap."""
    index = jpeg2000_planes(33, 47, 1, seed)[0] % ncolours
    planes = [index] + jpeg2000_planes(33, 47, 1, seed + 1)[:nc - 1]
    cmap = _CMAP3 + [(1, 0, 0)] * (nc - 1)
    return jp2_file(jpeg2000_bytes(planes), nc=nc, bpc=7, colr=16,
                    header=[pclr_box(_PAGE_PCLR), cmap_box(cmap)])


def _with_markers(cs, main=(), tile=()):
    """``cs`` with marker segments added to the main header and to the
    first tile-part's header."""
    m, parts, tail = j2k_parse(cs)
    isot, tp, tn, markers, data = parts[0]
    return j2k_build(m + list(main), [(isot, tp, tn, markers + list(tile), data)] + parts[1:],
                     tail)


def _plm(cs):
    """The PLT markers of every tile-part moved into one PLM marker of the
    main header (Nplm, then the Iplm bytes of each tile-part)."""
    main, parts, tail = j2k_parse(cs)
    iplm = b""
    new = []
    for isot, tp, tn, markers, data in parts:
        body = _plt_body(0, plt_lengths(markers))[1:]
        iplm += bytes([len(body)]) + body
        new.append((isot, tp, tn, [(c, b) for c, b in markers if c != 0xff58], data))
    return j2k_build(main + [(0xff57, b"\x00" + iplm)], new, tail)


def _coc_qcc(cs, nc):
    """COC and QCC markers for component 1 restating the COD and QCD
    settings, in the main header and again in the tile-part header."""
    main, _, _ = j2k_parse(cs)
    cod = next(b for c, b in main if c == 0xff52)
    qcd = next(b for c, b in main if c == 0xff5c)
    coc = bytes([1, cod[0] & 1]) + cod[5:]
    qcc = bytes([1]) + qcd
    return _with_markers(cs, main=[(0xff53, coc), (0xff5d, qcc)],
                         tile=[(0xff53, coc), (0xff5d, qcc)])


def _crg_com(cs, nc):
    return _with_markers(cs, main=[(0xff63, struct.pack(">HH", 0, 0) * nc),
                                   (0xff64, b"\x00\x01main-header comment")],
                         tile=[(0xff64, b"\x00\x00\x00\x01\x02tile-part comment")])


# name -> (file ending, bytes)
JPEG2000_VARIANTS = {
    "grey-1x1": ("j2k", _jp(1, 1, 1, 1, levels=0)),
    "grey-17x3": ("j2k", _jp(17, 3, 1, 2, levels=1)),
    "grey-3x17-97": ("j2k", _jp(3, 17, 1, 3, levels=1, irreversible=True)),
    "rgb-33x47-rct": ("j2k", _jp(33, 47, 3, 4, mct=True)),
    "rgb-33x47-ict": ("j2k", _jp(33, 47, 3, 5, mct=True, irreversible=True, rates=[12])),
    "rgb-no-mct-97": ("j2k", _jp(33, 47, 3, 6, irreversible=True)),
    "image-offset-odd": ("j2k", _jp(41, 37, 1, 7, offset=(5, 3), levels=2)),
    "tiles-odd-offsets-97": ("j2k", _jp(45, 61, 3, 8, offset=(5, 3), tile=(16, 16),
                                        tile_offset=(2, 1), levels=2, irreversible=True,
                                        mct=True)),
    "tiles-13x20": ("j2k", _jp(45, 61, 1, 9, tile=(13, 20), levels=2)),
    "levels-0-53": ("j2k", _jp(33, 47, 1, 10, levels=0)),
    "levels-0-97": ("j2k", _jp(33, 47, 1, 11, levels=0, irreversible=True)),
    "levels-1-97": ("j2k", _jp(33, 47, 3, 12, levels=1, irreversible=True, mct=True)),
    "levels-5-53": ("j2k", _jp(64, 64, 1, 13, levels=5)),
    "levels-max-53": ("j2k", _jp(64, 96, 1, 14, levels=6)),
    "levels-max-97": ("j2k", _jp(64, 96, 3, 15, levels=6, irreversible=True, mct=True)),
    "layers-3-rates": ("j2k", _jp(33, 47, 3, 16, irreversible=True, rates=[40, 10, 3])),
    "layers-2-psnr": ("j2k", _jp(33, 47, 1, 17, irreversible=True, psnr=[30, 45])),
    "layers-3-lossless-last": ("j2k", _jp(33, 47, 1, 18, rates=[20, 5, 0])),
    "order-lrcp-precincts": ("j2k", _jp(45, 61, 3, 19, rates=[10, 3, 1], cblk=(8, 8),
                                        precincts=[(32, 32), (16, 16), (16, 16), (8, 8)],
                                        levels=3)),
    "order-rlcp": ("j2k", _jp(45, 61, 3, 20, rates=[10, 3, 1], progression="RLCP",
                              precincts=[(32, 32), (16, 16), (8, 8)], levels=2, cblk=(8, 8))),
    "order-rpcl": ("j2k", _jp(45, 61, 3, 21, rates=[10, 3, 1], progression="RPCL",
                              precincts=[(32, 32), (16, 16), (8, 8)], levels=2, cblk=(8, 8),
                              offset=(3, 7))),
    "order-pcrl": ("j2k", _jp(45, 61, 3, 22, rates=[10, 3, 1], progression="PCRL",
                              precincts=[(32, 32), (16, 16), (8, 8)], levels=2, cblk=(8, 8),
                              tile=(40, 24), tile_offset=(1, 2),
                              offset=(3, 4))),
    "order-cprl": ("j2k", _jp(45, 61, 3, 23, rates=[10, 3, 1], progression="CPRL",
                              precincts=[(32, 32), (16, 16), (8, 8)], levels=2, cblk=(8, 8))),
    "order-rpcl-420": ("jp2", lambda: jpeg2000_bytes(
        jpeg2000_planes(45, 61, 3, 24, dxdy=_SUB420), dxdy=_SUB420, levels=2, cblk=(8, 8),
        progression="RPCL", precincts=[(32, 32), (16, 16), (8, 8)], rates=[8, 2], jp2=True,
        color_space="sycc")),
    "poc-rlcp-cprl": ("j2k", _jp(33, 47, 3, 25, rates=[20, 5, 1],
                                 pocs=[(0, 0, 3, 2, 3, "RLCP"), (2, 0, 3, 6, 3, "CPRL")])),
    "poc-three-orders": ("j2k", _jp(33, 47, 3, 26, rates=[20, 5, 1],
                                    pocs=[(0, 0, 2, 3, 2, "LRCP"), (0, 2, 3, 3, 3, "PCRL"),
                                          (0, 0, 3, 6, 3, "RLCP")])),
    "tile-parts-by-resolution": ("j2k", _jp(45, 61, 3, 27, tile=(32, 32), tile_parts="R",
                                            levels=3)),
    "tile-parts-by-layer": ("j2k", _jp(45, 61, 1, 28, tile=(32, 32), tile_parts="L",
                                       rates=[10, 3], levels=3)),
    "tile-parts-by-component-tlm": ("j2k", _jp(45, 61, 3, 29, tile=(32, 32), tile_parts="C",
                                               tlm=True, plt=True, levels=3)),
    "tile-parts-interleaved": ("j2k", lambda: interleaved_tile_parts(jpeg2000_bytes(
        jpeg2000_planes(45, 61, 3, 30), tile=(32, 32), plt=True, rates=[10, 2], levels=3))),
    "cblk-4x4": ("j2k", _jp(33, 47, 1, 31, cblk=(4, 4))),
    "cblk-8x128": ("j2k", _jp(33, 140, 1, 32, cblk=(128, 8), levels=3)),
    "cblk-1024x4-97": ("j2k", _jp(9, 150, 1, 33, cblk=(1024, 4), levels=2, irreversible=True)),
    "style-bypass": ("j2k", _jp(40, 47, 1, 34, styles=("bypass",), rates=[6, 2, 1])),
    "style-reset": ("j2k", _jp(40, 47, 1, 35, styles=("reset",), rates=[6, 2])),
    "style-termall": ("j2k", _jp(40, 47, 1, 36, styles=("termall",), rates=[6, 2])),
    "style-vsc": ("j2k", _jp(40, 47, 1, 37, styles=("vsc",), cblk=(16, 16))),
    "style-pterm": ("j2k", _jp(40, 47, 1, 38, styles=("pterm",), rates=[6, 2])),
    "style-segsym": ("j2k", _jp(40, 47, 1, 39, styles=("segsym",), cblk=(8, 32))),
    "style-bypass-termall-97": ("j2k", _jp(40, 47, 3, 40, styles=("bypass", "termall"),
                                           irreversible=True, rates=[10, 3])),
    "style-bypass-vsc-reset": ("j2k", _jp(64, 64, 1, 41, styles=("bypass", "vsc", "reset"))),
    "style-all": ("j2k", _jp(40, 47, 3, 42, styles=tuple(CBLK_STYLES), rates=[12, 4, 0])),
    "sop": ("j2k", _jp(33, 47, 3, 43, sop=True, rates=[10, 3])),
    "eph": ("j2k", _jp(33, 47, 1, 44, eph=True, rates=[10, 3])),
    "sop-eph-97": ("j2k", _jp(33, 47, 3, 45, sop=True, eph=True, irreversible=True,
                              rates=[10, 3])),
    "ppm": ("j2k", lambda: packed_headers(jpeg2000_bytes(
        jpeg2000_planes(33, 47, 3, 46), sop=True, eph=True, plt=True, rates=[20, 5, 1]), "ppm")),
    "ppt": ("j2k", lambda: packed_headers(jpeg2000_bytes(
        jpeg2000_planes(33, 47, 3, 47), sop=True, eph=True, plt=True, rates=[20, 5, 1]), "ppt")),
    "plt": ("j2k", _jp(33, 47, 1, 48, plt=True, rates=[10, 3])),
    "plm": ("j2k", lambda: _plm(jpeg2000_bytes(jpeg2000_planes(45, 61, 1, 49), plt=True,
                                               tile=(32, 32), levels=3))),
    "coc-qcc-crg-com": ("j2k", lambda: _crg_com(_coc_qcc(jpeg2000_bytes(
        jpeg2000_planes(33, 47, 3, 50)), 3), 3)),
    "rgn-53": ("j2k", _jp(33, 47, 1, 51, roi=(0, 5))),
    "rgn-97": ("j2k", _jp(33, 47, 3, 52, roi=(1, 7), irreversible=True, rates=[8])),
    "la": ("jp2", _jp(33, 47, 2, 53, jp2=True, color_space="grey")),
    "rgba-97": ("jp2", _jp(33, 47, 4, 54, jp2=True, color_space="srgb", irreversible=True)),
    "cmyk": ("jp2", _jp(33, 47, 4, 55, jp2=True, color_space="cmyk")),
    "i16-jp2": ("jp2", lambda: jpeg2000_bytes(jpeg2000_planes(33, 47, 1, 56, bits=16),
                                              precision=16, jp2=True, color_space="grey")),
    "prec-1": ("j2k", lambda: jpeg2000_bytes(jpeg2000_planes(33, 47, 1, 57, bits=1),
                                             precision=1)),
    "prec-4": ("j2k", lambda: jpeg2000_bytes(jpeg2000_planes(33, 47, 1, 58, bits=4),
                                             precision=4)),
    "prec-12-i16": ("j2k", lambda: jpeg2000_bytes(jpeg2000_planes(33, 47, 1, 59, bits=12),
                                                  precision=12)),
    "prec-12-rgb-97": ("j2k", lambda: jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 60, bits=12),
                                                     precision=12, irreversible=True)),
    "prec-mixed-bpcc": ("jp2", lambda: jp2_file(jpeg2000_bytes(
        [jpeg2000_planes(33, 47, 1, 61, bits=b)[0] for b in (8, 12, 5)], precision=[8, 12, 5]),
        nc=3, bpc=255, colr=16, header=[jp2_box(b"bpcc", bytes([7, 11, 4]))])),
    "signed-8": ("j2k", lambda: jpeg2000_bytes(jpeg2000_planes(33, 47, 1, 62, signed=True),
                                               signed=True)),
    "signed-12-rgb-97": ("j2k", lambda: jpeg2000_bytes(
        jpeg2000_planes(33, 47, 3, 63, bits=12, signed=True), precision=12, signed=True,
        irreversible=True)),
    "sycc-420-odd": ("jp2", lambda: jpeg2000_bytes(
        jpeg2000_planes(33, 47, 3, 64, dxdy=_SUB420), dxdy=_SUB420, levels=3, jp2=True,
        color_space="sycc")),
    "sycc-422-97": ("jp2", lambda: jpeg2000_bytes(
        jpeg2000_planes(32, 48, 3, 65, dxdy=[(1, 1), (2, 1), (2, 1)]),
        dxdy=[(1, 1), (2, 1), (2, 1)], levels=3, jp2=True, color_space="sycc",
        irreversible=True)),
    "raw-420-guessed-sycc": ("j2k", lambda: jpeg2000_bytes(
        jpeg2000_planes(33, 47, 3, 66, dxdy=_SUB420), dxdy=_SUB420, levels=3)),
    "pclr-p": ("jp2", lambda: _pclr(1)),
    "pclr-pa": ("jp2", lambda: _pclr(2, seed=91)),
    "jpx-brand": ("jpx", lambda: jp2_file(jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 67)), nc=3,
                                          bpc=7, colr=16, brand=b"jpx ",
                                          compat=(b"jp2 ", b"jpx ", b"jpxb"))),
    "jp2c-to-end-of-file": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 1, 68)), nc=1, bpc=7, colr=17, jp2c_length=0)),
    "jp2c-xl-box": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 69)), nc=3, bpc=7, colr=16, jp2c_length="xl")),
    "boxes-skipped": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 70)), nc=3, bpc=7, colr=16,
        header=[jp2_box(b"res ", jp2_box(b"resc", struct.pack(">HHHHBB", 3, 1, 3, 1, 2, 2))
                        + jp2_box(b"resd", struct.pack(">HHHHBB", 3, 1, 3, 1, 2, 2)))],
        before=(jp2_box(b"xml ", b"<page/>"), jp2_box(b"uuid", bytes(range(20))),
                jp2_box(b"jp2i", b"\x00" * 6)),
        after=(jp2_box(b"xml ", b"<after/>"),))),
    "cdef-rgba-and-swap": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 4, 71)), nc=4, bpc=7, colr=16,
        header=[cdef_box([(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)])])),
    "colr-icc-profile": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 72)), nc=3, bpc=7, colr=bytes(range(128)))),
    "colr-none-guessed-sycc": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 73, dxdy=_SUB420), dxdy=_SUB420, levels=3),
        nc=3, bpc=7, colr=None)),
    "colr-two-boxes": ("jp2", lambda: jp2_file(
        jpeg2000_bytes(jpeg2000_planes(33, 47, 3, 74)), nc=3, bpc=7, colr=16,
        header=[jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17))])),
}


def jpeg2000_small_variants():
    """[(file name, write(path))] of every JPEG 2000 variant of the catalog."""
    return [(f"jpeg2000_{name}.{ending}", lambda p, make=make: _write_bytes(p, make()))
            for name, (ending, make) in JPEG2000_VARIANTS.items()]


def jpeg2000_refused(grey_j2k: bytes, rgb_jp2: bytes):
    """[(name, file bytes, a word of the port's refusal)]: hand-made faults,
    built from a raw grey codestream and a JP2 colour file of the catalog,
    that PIL refuses too."""
    main, parts, tail = j2k_parse(grey_j2k)
    xsiz, ysiz = struct.unpack_from(">II", grey_j2k, 8)
    jp2h = rgb_jp2.index(b"jp2h") - 4
    ihdr = rgb_jp2.index(b"ihdr") - 4
    jp2h_len = struct.unpack_from(">I", rgb_jp2, jp2h)[0]
    no_ihdr = (rgb_jp2[:jp2h] + struct.pack(">I", jp2h_len - 22) + rgb_jp2[jp2h + 4:ihdr]
               + rgb_jp2[ihdr + 22:])
    wide = rgb_jp2[:ihdr + 12] + struct.pack(">I", struct.unpack_from(
        ">I", rgb_jp2, ihdr + 12)[0] + 1) + rgb_jp2[ihdr + 16:]

    def patched_siz(x, y):
        m = [(c, b[:2] + struct.pack(">II", x, y) + b[10:] if c == 0xff51 else b)
             for c, b in main]
        return j2k_build(m, parts, tail)
    isot, tp, tn, markers, data = parts[0]
    return [
        ("jp2h-without-ihdr", no_ihdr, "JP2 header is malformed"),
        ("ihdr-size-not-the-codestreams", wide, "ihdr box's size"),
        ("grey-in-srgb", jp2_file(grey_j2k, nc=1, bpc=7, colr=16), "no unpacker"),
        ("eycc-colour-space", jp2_file(rgb_jp2[rgb_jp2.index(b"jp2c") + 4:], nc=3, bpc=7,
                                       colr=24), "no unpacker"),
        ("first-component-subsampled", jpeg2000_bytes(
            jpeg2000_planes(33, 47, 1, 80, dxdy=[(2, 1)]), dxdy=[(2, 1)], levels=3),
         "no unpacker"),
        ("no-cod-marker", j2k_build([(c, b) for c, b in main if c != 0xff52], parts, tail),
         "no COD marker"),
        ("cod-with-zero-layers", j2k_build(
            [(c, b[:2] + b"\0\0" + b[4:] if c == 0xff52 else b) for c, b in main], parts, tail),
         "0 layers"),
        ("tile-part-out-of-order", j2k_build(main, [(isot, 1, tn, markers, data)], tail),
         "out of order"),
        ("psot-past-the-end", grey_j2k[:grey_j2k.index(b"\xff\x90") + 6] + struct.pack(
            ">I", len(grey_j2k)) + grey_j2k[grey_j2k.index(b"\xff\x90") + 10:], "past the end"),
        ("soc-without-siz", b"\xff\x4f\xff\x52" + grey_j2k[4:], "SOC is not followed by SIZ"),
        ("signature-box-damaged", rgb_jp2[:8] + b"\x0d\x0a\x87\x0b" + rgb_jp2[12:],
         "signature box is malformed"),
        ("decompression-bomb", patched_siz(20000, 20000), "decompression-bomb"),
        ("truncated-after-main-header", grey_j2k[:grey_j2k.index(b"\xff\x90") + 20],
         "past the end"),
    ]


# ------------------------------------------------------------------ raster formats
# PCX / DCX, PSD, TGA, ICO / CUR, DIB, SGI, SUN, QOI, MSP, IM, XBM, XPM,
# PIXAR, SPIDER, GBR, IMT, MCIDAS and XVTHUMB, byte by byte (no PIL): the
# layouts PIL's readers take, and the faults they refuse.

def _pack_bits(bits):
    """[h, w] 0/1 -> rows of whole bytes, most significant bit first."""
    return np.packbits(np.asarray(bits, np.uint8), axis=1)


def _bit_planes(index, planes):
    """[h, w] indices -> [h, planes * ceil(w / 8)]: plane k holds bit k."""
    return np.concatenate([_pack_bits((np.asarray(index) >> k) & 1) for k in range(planes)],
                          axis=1)


def pcx_rle(lines, rng):
    """PCX runs of each line (bytes >= 0xC0 always as a run, other runs of
    2-63 at random), no run across a line's end."""
    out = bytearray()
    for line in lines:
        x = 0
        while x < len(line):
            run = 1
            while x + run < len(line) and run < 63 and line[x + run] == line[x]:
                run += 1
            v = int(line[x])
            if run > 1 or v >= 0xC0 or rng.rand() < 0.05:
                if run > 1 and rng.rand() < 0.3:
                    run = int(rng.randint(1, run + 1))
                out += bytes([0xC0 | run, v])
            else:
                out.append(v)
            x += run
    return bytes(out)


def pcx_bytes(samples, bits, planes, version=5, palette=None, end_palette=None,
              provided_stride=None, seed=0):
    """A PCX of ``samples``: [h, w] 0/1 for 1 bit, indices for the 2- and
    4-plane bit planes, bytes for 8 bits, [h, w, 3] for planar RGB. Each
    plane line holds PIL's stride (the samples' bytes, made even where the
    header's bytes per line, ``provided_stride``, differ). ``palette``: the
    16 header entries; ``end_palette``: 256 RGB entries after a 12 byte."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    if bits == 1 and planes == 1:
        plane_rows = [_pack_bits(samples)]
    elif bits == 1:
        plane_rows = [_pack_bits((samples >> k) & 1) for k in range(planes)]
    elif planes == 1:
        plane_rows = [samples.astype(np.uint8)]
    else:
        plane_rows = [samples[..., k].astype(np.uint8) for k in range(planes)]
    stride = (w * bits + 7) // 8
    provided = stride if provided_stride is None else provided_stride
    if provided != stride:
        stride += stride % 2
    lines = np.zeros((h, planes * stride), np.uint8)
    for k, p in enumerate(plane_rows):
        lines[:, k * stride:k * stride + p.shape[1]] = p
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 300, 300)
    pal = np.zeros(48, np.uint8)
    if palette is not None:
        pal[:np.asarray(palette).size] = np.asarray(palette, np.uint8).ravel()[:48]
    head += pal.tobytes() + bytes([0, planes]) + struct.pack("<HH", provided, 1)
    head = head.ljust(128, b"\0")
    out = head + pcx_rle(lines, np.random.RandomState(seed))
    if end_palette is not None:
        out += b"\x0c" + np.asarray(end_palette, np.uint8).tobytes()
    return out


def dcx_bytes(pages):
    """An Intel DCX of PCX files: the magic, the page offsets, a zero."""
    offset = 4 + 4 * (len(pages) + 1)
    table = b""
    for p in pages:
        table += struct.pack("<I", offset)
        offset += len(p)
    return struct.pack("<I", 0x3ADE68B1) + table + b"\0\0\0\0" + b"".join(pages)


def packbits_row(row, rng):
    """PackBits of one row: runs of 2-128 repeated bytes, literals of 1-128."""
    out = bytearray()
    x, n = 0, len(row)
    while x < n:
        run = 1
        while x + run < n and run < 128 and row[x + run] == row[x]:
            run += 1
        if run >= 2 and (run >= 3 or rng.rand() < 0.5):
            out += bytes([257 - run, int(row[x])])
            x += run
            continue
        lit = 1
        while x + lit < n and lit < 128 and not (x + lit + 1 < n
                                                 and row[x + lit] == row[x + lit + 1]):
            lit += 1
        if rng.rand() < 0.2 and lit > 1:
            lit = int(rng.randint(1, lit + 1))
        out += bytes([lit - 1]) + bytes(row[x:x + lit].astype(np.uint8))
        x += lit
    return bytes(out)


def psd_bytes(channels, mode, bits=8, compression=0, colour_data=b"", resources=False,
              layers=False, seed=0):
    """A PSD whose composite image holds ``channels`` ([c, h, w] bytes, or
    [c, h, w] 0/1 for 1 bit), colour mode ``mode`` (0 bitmap, 1 grey, 2
    indexed, 3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 Lab), raw or
    PackBits; ``colour_data`` is the colour mode data section (an indexed
    image's 768-byte palette), ``resources`` and ``layers`` add an image
    resource block and a layer section (PIL skips both for the composite)."""
    rng = np.random.RandomState(seed)
    channels = np.asarray(channels)
    c, h, w = channels.shape
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, mode)
    out += struct.pack(">I", len(colour_data)) + colour_data
    res = b""
    if resources:
        for rid, body in ((1005, bytes(16)), (1039, b"icc-profile")):
            res += b"8BIM" + struct.pack(">H", rid) + b"\x04name\x00" + struct.pack(
                ">I", len(body)) + body + (b"\0" if len(body) % 2 else b"")
    out += struct.pack(">I", len(res)) + res
    lay = b""
    if layers:
        record = struct.pack(">iiiiH", 0, 0, h, w, 1) + struct.pack(">hI", 0, h * w + 2)
        record += b"8BIMnorm" + bytes([255, 0, 0, 0]) + struct.pack(">I", 8) + bytes(8)
        info = struct.pack(">h", 1) + record + struct.pack(">H", 0) + bytes(h * w)
        info += b"\0" * (len(info) % 2)
        lay = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
    out += struct.pack(">I", len(lay)) + lay
    rows = [_pack_bits(ch) if bits == 1 else ch.astype(np.uint8) for ch in channels]
    if compression == 0:
        return out + struct.pack(">H", 0) + b"".join(r.tobytes() for r in rows)
    coded = [[packbits_row(row, rng) for row in r] for r in rows]
    counts = b"".join(struct.pack(">H", len(x)) for r in coded for x in r)
    return out + struct.pack(">H", 1) + counts + b"".join(x for r in coded for x in r)


def tga_rle(pixels, w, depth_bytes, rng):
    """TGA RLE packets of the file's pixel stream ([n, depth] bytes, rows of
    w pixels): runs stay inside a row, literals may cross rows."""
    out = bytearray()
    n, i = len(pixels), 0
    while i < n:
        row_end = (i // w + 1) * w
        run = 1
        while i + run < row_end and run < 128 and (pixels[i + run] == pixels[i]).all():
            run += 1
        if run >= 2 and rng.rand() < 0.8:
            out += bytes([0x80 | (run - 1)]) + pixels[i].tobytes()
            i += run
            continue
        lit = int(min(rng.randint(1, 129), n - i))
        out += bytes([lit - 1]) + pixels[i:i + lit].tobytes()
        i += lit
    return bytes(out)


def tga_bytes(pixels, imagetype, depth, colormap=None, flags=0x20, id_field=b"",
              colormaptype=None, seed=0):
    """A Targa of ``pixels``: [h, w, depth / 8] bytes as stored for each
    pixel (indices, grey, grey + alpha, BGR(A), 16-bit words), or [h, w]
    0/1 for 1 bit; written in the order ``flags`` (bits 4-5) gives, raw
    for image types 1-3, RLE for 9-11. ``colormap``: (first entry, [n,
    map depth / 8] bytes, map depth)."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    stored = pixels if flags & 0x20 else pixels[::-1]
    if flags & 0x10:
        stored = stored[:, ::-1]
    start, entries, mapdepth = colormap if colormap is not None else (0, np.zeros((0, 1)), 0)
    entries = np.asarray(entries, np.uint8)
    cmt = (1 if colormap is not None else 0) if colormaptype is None else colormaptype
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), cmt, imagetype, start, len(entries),
                       mapdepth, 0, 0, w, h, depth, flags)
    if depth == 1:
        body = _pack_bits(stored).tobytes()
    elif imagetype & 8:
        nb = depth // 8
        body = tga_rle(stored.reshape(h * w, nb), w, nb, np.random.RandomState(seed))
    else:
        body = stored.tobytes()
    return head + id_field + entries.tobytes() + body


def dib_icon(index_or_rgb, bits, palette=None, mask=None, alpha=None):
    """An icon's DIB: a 40-byte header of twice the height, the XOR image
    bottom row first, then the AND mask (1 bit, rows of 4 bytes)."""
    px = np.asarray(index_or_rgb)
    h, w = px.shape[:2]
    if bits == 32:
        bgra = np.concatenate([px[..., ::-1], (alpha if alpha is not None else
                                               np.full((h, w), 255))[..., None]], axis=-1)
        xor = bgra.astype(np.uint8).reshape(h, -1)[::-1].tobytes()
    elif bits == 24:
        xor = _bmp_rows(px[..., ::-1], 24)[::-1].tobytes()
    else:
        xor = _bmp_rows(px, bits)[::-1].tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        pal = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], axis=1).tobytes()
    m = np.zeros((h, w), np.uint8) if mask is None else np.asarray(mask, np.uint8)
    and_rows = _bmp_rows(m, 1)[::-1].tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, len(xor) + len(and_rows),
                       0, 0, 0 if palette is None else len(palette), 0)
    return info + pal + xor + and_rows


def icon_file(images, kind=1):
    """An ICO (``kind`` 1) or CUR (2) of [(image bytes, width byte, height
    byte, colours, bpp)] in directory order."""
    out = struct.pack("<HHH", 0, kind, len(images))
    offset = 6 + 16 * len(images)
    body = b""
    for data, wb, hb, colours, bpp in images:
        out += struct.pack("<BBBBHHII", wb, hb, colours, 0, 1 if kind == 1 else 3,
                           bpp if kind == 1 else 4, len(data), offset + len(body))
        body += data
    return out + body


def sgi_rle_row(row, bpc, rng):
    """SGI RLE of one row of one channel: copies (0x80 | n) and runs, ended
    by a zero atom; 16-bit atoms are big-endian words."""
    atoms = []
    x, n = 0, len(row)
    while x < n:
        run = 1
        while x + run < n and run < 127 and row[x + run] == row[x]:
            run += 1
        if run >= 2 and rng.rand() < 0.8:
            atoms += [run, int(row[x])]
            x += run
            continue
        lit = int(min(rng.randint(1, 128), n - x))
        atoms += [0x80 | lit] + [int(v) for v in row[x:x + lit]]
        x += lit
    atoms.append(0)
    return struct.pack(">" + ("B" if bpc == 1 else "H") * len(atoms), *atoms)


def sgi_bytes(samples, bpc=1, dimension=None, rle=False, seed=0, name=b"test"):
    """An SGI image of ``samples`` [h, w, z] (uint8 or uint16), bottom row
    first, channel after channel; RLE with its offset and length tables."""
    s = np.asarray(samples)
    h, w, z = s.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHII4x", 474, int(rle), bpc, dimension, w, h, z, 0,
                       255 if bpc == 1 else 65535)
    head = (head + name.ljust(80, b"\0")[:80] + struct.pack(">I", 0)).ljust(512, b"\0")
    planes = s.transpose(2, 0, 1)[:, ::-1]
    if not rle:
        dt = ">u1" if bpc == 1 else ">u2"
        return head + planes.astype(dt).tobytes()
    rng = np.random.RandomState(seed)
    rows = [[sgi_rle_row(r, bpc, rng) for r in plane] for plane in planes]
    offset = 512 + 8 * h * z
    starts, lengths, body = [], [], b""
    for plane in rows:
        for r in plane:
            starts.append(offset + len(body))
            lengths.append(len(r))
            body += r
    return head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lengths) + body


def sun_rle(data):
    """SUN RLE: 0x80 as 0x80 0, runs of 3-256 (or of 0x80) as 0x80 n-1 v."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 256 and data[i + run] == data[i]:
            run += 1
        if run >= 3 or (data[i] == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, data[i]])
            i += run
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def sun_bytes(pixels, depth, file_type=1, palette=None, palette_type=1):
    """A Sun raster of ``pixels`` ([h, w] 0/1 for 1 bit, indices or grey for
    4 and 8 bits, [h, w, 3 or 4] as stored for 24 and 32 bits), rows padded
    to 16 bits; file type 2 RLE-codes the padded rows."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    if depth == 1:
        rows = _pack_bits(p)
    elif depth == 4:
        rows = _pack_bits(((p[..., None] >> np.arange(3, -1, -1)) & 1).reshape(h, -1))
    else:
        rows = p.reshape(h, -1).astype(np.uint8)
    stride = ((w * depth + 15) // 16) * 2
    padded = np.zeros((h, stride), np.uint8)
    padded[:, :rows.shape[1]] = rows
    body = padded.tobytes()
    if file_type == 2:
        body = sun_rle(body)
    pal = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type,
                       palette_type if pal else 0, len(pal))
    return head + pal + body


def qoi_bytes(pixels, seed=0, ops=("index", "diff", "luma", "run", "rgb", "rgba")):
    """QOI of [h, w, 3 or 4] pixels with every op, against the state PIL's
    decoder keeps (a run leaves the index as it is); ``ops`` limits the ops
    used (RGBA always where alpha changes)."""
    rng = np.random.RandomState(seed)
    px = np.asarray(pixels, np.uint8)
    h, w, ch = px.shape
    flat = px.reshape(-1, ch)
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, ch, 0))
    i, n = 0, len(flat)
    while i < n:
        v = tuple(int(c) for c in flat[i]) + ((prev[3],) if ch == 3 else ())
        if "run" in ops and v == prev:
            run = 1
            while i + run < n and run < 62 and tuple(int(c) for c in flat[i + run]) == v[:ch]:
                run += 1
            out.append(0xC0 | (run - 1))
            i += run
            continue
        hsh = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64
        d = [(v[k] - prev[k] + 128) % 256 - 128 for k in range(3)]
        if "index" in ops and index[hsh] == v and rng.rand() < 0.9:
            out.append(hsh)
        elif v[3] != prev[3] or "rgb" not in ops and "rgba" in ops and rng.rand() < 0.5:
            out += bytes([0xFF, *v])
        elif "diff" in ops and all(-2 <= x <= 1 for x in d) and rng.rand() < 0.9:
            out.append(0x40 | (d[0] + 2) << 4 | (d[1] + 2) << 2 | (d[2] + 2))
        elif ("luma" in ops and -32 <= d[1] <= 31 and -8 <= d[0] - d[1] <= 7
              and -8 <= d[2] - d[1] <= 7 and rng.rand() < 0.9):
            out += bytes([0x80 | (d[1] + 32), (d[0] - d[1] + 8) << 4 | (d[2] - d[1] + 8)])
        elif "rgb" in ops:
            out += bytes([0xFE, *v[:3]])
        else:
            out += bytes([0xFF, *v])
        index[hsh] = v
        prev = v
        i += 1
    return bytes(out + b"\0" * 7 + b"\1")


def msp_bytes(bits, version=1, seed=0):
    """A Windows Paint file of [h, w] 0/1 (1 white): version 1 raw rows,
    version 2 a row map and per-row runs (0, count, value) and literals."""
    b = np.asarray(bits, np.uint8)
    h, w = b.shape
    rows = _pack_bits(b)
    words = [0x6144, 0x4D6E, w, h, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    if version == 2:
        words[:2] = [0x694C, 0x536E]
    chk = 0
    for x in words:
        chk ^= x
    words[12] = chk
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    rng = np.random.RandomState(seed)
    coded = []
    for row in rows:
        out, x = bytearray(), 0
        if (row == 0xFF).all() and rng.rand() < 0.5:
            coded.append(b"")                  # PIL: an empty row is a white line
            continue
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or rng.rand() < 0.3:
                out += bytes([0, run, int(row[x])])
                x += run
            else:
                lit = int(min(rng.randint(1, 20), len(row) - x))
                out += bytes([lit]) + row[x:x + lit].tobytes()
                x += lit
        coded.append(bytes(out))
    return head + struct.pack(f"<{h}H", *map(len, coded)) + b"".join(coded)


def im_bytes(type_name, w, h, body, lut=None, lines=(), pad=True):
    """An IFUNC IM file: the header lines, ``Lut`` if a 768-byte palette is
    given, padding to 511 bytes and a 0x1A, the palette, then ``body``
    (the samples as the type stores them, bottom row first)."""
    head = f"Image type: {type_name}\r\nName: test\r\nImage size (x*y): {w}*{h}\r\n"
    head += "".join(f"{x}\r\n" for x in lines)
    if lut is not None:
        head += "Lut: 1\r\n"
    data = head.encode("latin-1")
    data = (data.ljust(511, b"\0") if pad else data) + b"\x1a"
    if lut is not None:
        data += np.asarray(lut, np.uint8).tobytes()
    return data + body


def im_samples(type_name, w, h, rng):
    """A random body for each IM header type (its bytes per line, h lines)."""
    from math import ceil
    table = {"1": 1, "L": 8, "P;2": 2, "P;4": 4, "RGB": 24, "RGB;L": 24, "RLB": 24,
             "LA;L": 16, "PA;L": 16, "RGBA;L": 32, "RGBX;L": 32, "CMYK;L": 32,
             "YCbCr;L": 24, "I;16": 16, "I;16L": 16, "I;16B": 16, "I;32": 32, "I;32S": 32}
    raw = IM_TYPES[type_name][1]
    if raw in ("RGB;T", "RYB;T"):
        return rng.randint(0, 256, 3 * w * h).astype(np.uint8).tobytes()
    if raw.startswith("F;"):
        t = raw[2:]
        if t in ("8", "8S", "16", "16S", "32", "32F"):
            n = {"8": 1, "8S": 1, "16": 2, "16S": 2, "32": 4, "32F": 4}[t]
            if t == "32F":
                return (rng.uniform(-20, 300, w * h).astype("<f4")).tobytes()
            if t == "32":
                return rng.randint(0, 400, w * h).astype("<u4").tobytes()
            return rng.randint(0, 256, n * w * h).astype(np.uint8).tobytes()
        bits = int(t)
        return rng.randint(0, 256, ceil(w * bits / 8) * h + 4).astype(np.uint8).tobytes()
    n = ceil(w * table[raw] / 8) * h
    data = rng.randint(0, 256, n).astype(np.uint8)
    if raw in ("I;32", "I;32S"):
        data = rng.randint(-100, 400, w * h).astype("<i4").view(np.uint8)
    return data.tobytes()


# PIL 12.1's ImImagePlugin.OPEN: header type -> (mode, rawmode)
IM_TYPES = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
            "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
            "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
            "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
            "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
            "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
            "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
            "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
            "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _t in ("8", "8S", "16", "16S", "32", "32F"):
    IM_TYPES[f"L {_t} image"] = IM_TYPES[f"L*{_t} image"] = ("F", f"F;{_t}")
for _t in ("16", "16L", "16B"):
    IM_TYPES[f"L {_t} image"] = IM_TYPES[f"L*{_t} image"] = (f"I;{_t}", f"I;{_t}")
IM_TYPES["L 32S image"] = IM_TYPES["L*32S image"] = ("I", "I;32S")
for _t in range(2, 33):
    IM_TYPES[f"L*{_t} image"] = ("F", f"F;{_t}")


def xbm_bytes(bits, name="img", hotspot=None, per_line=12):
    """An X11 bitmap of [h, w] 0/1 (bit 0 of each byte the leftmost pixel)."""
    b = np.asarray(bits, np.uint8)
    h, w = b.shape
    rows = np.packbits(b, axis=1, bitorder="little")
    head = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot is not None:
        head += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n"
    vals = [f"0x{v:02x}" for v in rows.ravel()]
    body = ",\n".join(", ".join(vals[i:i + per_line]) for i in range(0, len(vals), per_line))
    return (head + f"static char {name}_bits[] = {{\n{body}}};\n").encode()


def xpm_bytes(index, colours, cpp=1, transparent=None, pixels_comment=True):
    """An XPM of [h, w] indices into ``colours`` ([n, 3] RGB), ``cpp``
    characters per pixel; ``transparent``: a key given the colour None."""
    idx = np.asarray(index)
    h, w = idx.shape
    chars = [chr(c) for c in range(35, 127) if chr(c) not in '"\\']
    keys = ["".join(chars[(i // len(chars) ** k) % len(chars)] for k in range(cpp))
            for i in range(len(colours))]
    n = len(colours) + (transparent is not None)
    lines = ["/* XPM */", "static char *img[] = {", "/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {n} {cpp} ",']
    lines += [f'"{k} c #{r:02X}{g:02X}{b:02X}",' for k, (r, g, b) in zip(keys, colours)]
    if transparent is not None:
        lines.append(f'"{transparent} c None",')
    if pixels_comment:
        lines.append("/* pixels */")
    lines += [f'"{"".join(keys[v] for v in row)}"' + ("," if y < h - 1 else "")
              for y, row in enumerate(idx)]
    return ("\n".join(lines) + "\n};\n").encode()


def pixar_bytes(rgb):
    """A PIXAR raster: the magic, height at 416, width at 418, the RGB mode
    words (14, 2) at 424, samples from byte 1024."""
    p = np.asarray(rgb, np.uint8)
    h, w = p.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HHxxxxHH", head, 416, h, w, 14, 2)
    return bytes(head) + p.tobytes()


def spider_bytes(values, big=True, stack=False):
    """A SPIDER 2-D image of float32 [h, w]: a header of labrec records of
    the line length, or a stack header and one image's header."""
    v = np.asarray(values, np.float32)
    h, w = v.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, np.float32)

    def header(istack, imgnum):
        t = hdr.copy()
        t[:27] = 0
        t[0], t[1], t[4], t[11], t[12] = 1, h, 1, w, labrec
        t[21], t[22], t[23], t[25], t[26] = labbyt, lenbyt, istack, 1, imgnum
        return t.astype(">f4" if big else "<f4").tobytes()
    dt = ">f4" if big else "<f4"
    if stack:
        return header(2, 0) + header(0, 1) + v.astype(dt).tobytes()
    return header(0, 0) + v.astype(dt).tobytes()


def gbr_bytes(pixels, version=2, name=b"brush"):
    """A GIMP brush: [h, w] grey (depth 1) or [h, w, 4] RGBA (depth 4)."""
    p = np.asarray(pixels, np.uint8)
    h, w = p.shape[:2]
    depth = 1 if p.ndim == 2 else 4
    comment = name + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) + b"GIMP" + struct.pack(
            ">I", 25)
    return head + comment + p.tobytes()


def imt_bytes(grey, comment=True):
    g = np.asarray(grey, np.uint8)
    h, w = g.shape
    head = ("* IM Tools image\n" if comment else "") + f"width {w}\nheight {h}\npixel n8\n"
    return head.encode() + b"\x0c" + g.tobytes()


def mcidas_bytes(values, nbytes, prefix=0):
    """A McIdas area of [h, w] values of 1, 2 or 4 big-endian bytes, each
    line after ``prefix`` bytes."""
    v = np.asarray(values)
    h, w = v.shape
    words = np.zeros(64, ">i4")
    words[1] = 4                               # w[2]: the area format
    words[8], words[9], words[10] = h, w, nbytes
    words[13], words[14], words[33] = 1, prefix, 256
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    lines = np.zeros((h, prefix + w * nbytes), np.uint8)
    lines[:, :prefix] = 7
    lines[:, prefix:] = v.astype(dt).view(np.uint8).reshape(h, -1)
    return words.tobytes() + lines.tobytes()


def xvthumb_bytes(index):
    idx = np.asarray(index, np.uint8)
    h, w = idx.shape
    return (f"P7 332\n#XVVERSION:Version 2.28\n#BUILTIN:STIPPLE\n#END_OF_COMMENTS\n"
            f"{w} {h} 255\n").encode() + idx.tobytes()


def _rs(name):
    return np.random.RandomState(sum(map(ord, name)))


def _pcx_case(bits, planes, version=5, h=13, w=6, end="grey", provided=None):
    def make(name):
        r = _rs(name)
        if bits == 1 and planes == 1:
            return pcx_bytes(r.randint(0, 2, (h, w)), 1, 1, version, provided_stride=provided,
                             seed=r.randint(1 << 30))
        if bits == 1:
            return pcx_bytes(r.randint(0, 1 << planes, (h, w)), 1, planes, version,
                             palette=r.randint(0, 256, (16, 3)), provided_stride=provided,
                             seed=r.randint(1 << 30))
        if planes == 3:
            return pcx_bytes(r.randint(0, 256, (h, w, 3)), 8, 3, version,
                             provided_stride=provided, seed=r.randint(1 << 30))
        pal = {"grey": _grey_ramp(256), "colour": r.randint(0, 256, (256, 3)),
               "none": None}[end]
        return pcx_bytes(r.randint(0, 256, (h, w)), 8, 1, version, end_palette=pal,
                         provided_stride=provided, seed=r.randint(1 << 30))
    return make


def _psd_case(mode, n, bits=8, compression=0, h=13, w=6, **kw):
    def make(name):
        r = _rs(name)
        ch = r.randint(0, 2 if bits == 1 else 256, (n, h, w))
        colour = kw.pop("colour_data", None)
        if colour == "palette":
            colour = r.randint(0, 256, 768).astype(np.uint8).tobytes()
        elif colour == "duotone":
            colour = bytes(r.randint(0, 256, 40).astype(np.uint8))
        return psd_bytes(ch, mode, bits, compression, colour_data=colour or b"",
                         seed=r.randint(1 << 30), **kw)
    return make


def _tga_case(imagetype, depth, flags=0x20, cmap=None, h=13, w=6, cmt=None, ident=b""):
    def make(name):
        r = _rs(name)
        nb = max(1, depth // 8)
        if depth == 1:
            px = r.randint(0, 2, (h, w))
        elif imagetype & 7 == 1:
            px = r.randint(0, 40, (h, w, 1))
        else:
            px = r.randint(0, 256, (h, w, nb))
            px[:, :w // 2] = px[:, :1]                 # runs for the RLE coder
        colormap = None
        if cmap is not None:
            start, mapdepth, n = cmap
            colormap = (start, r.randint(0, 256, (n, mapdepth // 8)), mapdepth)
        return tga_bytes(px, imagetype, depth, colormap, flags, ident, cmt,
                         seed=r.randint(1 << 30))
    return make


def _ico_bmp_entry(r, bits, h, w, alpha=False):
    if bits == 32:
        return dib_icon(r.randint(0, 256, (h, w, 3)), 32,
                        alpha=r.randint(0, 256, (h, w)) if alpha else None)
    if bits == 24:
        return dib_icon(r.randint(0, 256, (h, w, 3)), 24, mask=r.randint(0, 2, (h, w)))
    return dib_icon(r.randint(0, 1 << bits, (h, w)), bits,
                    palette=r.randint(0, 256, (1 << bits, 3)), mask=r.randint(0, 2, (h, w)))


def _ico_png_entry(r, h, w, ctype=6):
    ch = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    pal = r.randint(0, 256, (256, 3)) if ctype == 3 else None
    return png_bytes(r.randint(0, 256, (h, w, ch)), ctype, 8, False, seed=r.randint(100),
                     palette=pal)


def _ico_case(entries, kind=1):
    """entries: [(kind "png" / bits, h, w, directory width byte or None, bpp
    field or None, colours byte)]"""
    def make(name):
        r = _rs(name)
        images = []
        for e, h, w, wb, bpp, colours in entries:
            data = (_ico_png_entry(r, h, w) if e == "png"
                    else _ico_bmp_entry(r, e, h, w, alpha=True))
            images.append((data, (w if wb is None else wb) % 256, (h if wb is None else wb) % 256,
                           colours, (32 if e == "png" else e) if bpp is None else bpp))
        return icon_file(images, kind)
    return make


def _dib_case(header, bits, **kw):
    def make(name):
        case = _bmp_case(f"P{bits}" if bits <= 8 else "rgb24", sum(map(ord, name)), 13, 6) \
            if bits in (1, 4, 8, 24) else None
        if case is None:
            r = _rs(name)
            case = dict(px=r.randint(0, 1 << 16 if bits == 16 else 1 << 31, (13, 6)),
                        bits=bits)
        case.update(kw)
        return bmp_bytes(header=header, **case)[14:]
    return make


def _sgi_case(bpc, z, dimension=None, rle=False, h=13, w=6):
    def make(name):
        r = _rs(name)
        s = r.randint(0, 256 if bpc == 1 else 65536, (h, w, z))
        s[:, :3] = s[:, :1]
        return sgi_bytes(s, bpc, dimension, rle, seed=r.randint(1 << 30))
    return make


def _sun_case(depth, file_type=1, palette=None, h=13, w=7):
    def make(name):
        r = _rs(name)
        if depth == 1:
            px = r.randint(0, 2, (h, w))
        elif depth == 4:
            px = r.randint(0, 16, (h, w))
        elif depth == 8:
            px = r.randint(0, palette or 256, (h, w))
            px[:, :4] = 0x80
        else:
            px = r.randint(0, 256, (h, w, depth // 8))
        pal = r.randint(0, 256, (palette, 3)) if palette else None
        return sun_bytes(px, depth, file_type, pal)
    return make


def _qoi_case(ch, h=13, w=6, ops=("index", "diff", "luma", "run", "rgb", "rgba")):
    def make(name):
        r = _rs(name)
        base = r.randint(0, 256, (1, 1, ch))
        px = (base + np.cumsum(r.randint(-3, 3, (h, w, ch)), axis=1)) % 256
        px[:, w // 2:] = px[:, w // 2:w // 2 + 1]
        px[h // 2] = px[1]
        if ch == 4:
            px[..., 3] = np.where(r.rand(h, w) < 0.8, 255, r.randint(0, 256, (h, w)))
        return qoi_bytes(px, seed=r.randint(1 << 30), ops=ops)
    return make


def _im_case(type_name, lut=None, h=13, w=6):
    def make(name):
        r = _rs(name)
        pal = None
        if lut == "grey":
            pal = np.repeat(np.arange(256, dtype=np.uint8)[None], 3, 0)
        elif lut == "grey-nonlinear":
            pal = np.repeat(r.randint(0, 256, 256).astype(np.uint8)[None], 3, 0)
        elif lut == "colour":
            pal = r.randint(0, 256, (3, 256)).astype(np.uint8)
        return im_bytes(type_name, w, h, im_samples(type_name, w, h, r), lut=pal)
    return make


def _seeded(fn, shape, high=256, **kw):
    def make(name):
        return fn(_rs(name).randint(0, high, shape), **kw)
    return make


def _xpm_case(n, cpp, transparent=None, h=13, w=6):
    def make(name):
        r = _rs(name)
        return xpm_bytes(r.randint(0, n, (h, w)), r.randint(0, 256, (n, 3)), cpp, transparent)
    return make


RASTER_VARIANTS = {}
for _bits, _planes in ((1, 1), (1, 2), (1, 4), (8, 1), (8, 3)):
    # (width, the header's bytes per line: None for PIL's own, 99 for a
    # value that makes PIL pad each plane line to an even length)
    _widths = ((6, None), (20, 99), (33, None)) + (((1, None),) if _bits == 1 else ())
    if _planes in (2, 4):
        _widths += ((6, 99),)
    for _ver in ((0, 2, 3, 5) if (_bits, _planes) == (1, 1) else (5,) if _bits == 8 else (2, 5)):
        for _w, _prov in _widths:
            RASTER_VARIANTS[f"pcx_{_bits}bit_{_planes}planes_v{_ver}_w{_w}"
                            f"{'_padded' if _prov else ''}.pcx"] = _pcx_case(
                _bits, _planes, _ver, 13 if _w != 1 else 1, _w, provided=_prov)
for _end in ("colour", "none"):
    RASTER_VARIANTS[f"pcx_8bit_{_end}_palette.pcx"] = _pcx_case(8, 1, end=_end, w=47, h=33)
RASTER_VARIANTS.update({
    "dcx_one_page.dcx": lambda name: dcx_bytes([_pcx_case(1, 1, w=33, h=47)(name)]),
    "dcx_three_pages.dcx": lambda name: dcx_bytes(
        [_pcx_case(1, 1, w=13, h=6)(name), _pcx_case(8, 1, w=7, h=5)(name + "2"),
         _pcx_case(1, 4, w=9, h=3)(name + "3")]),
    "dcx_grey_page.dcx": lambda name: dcx_bytes([_pcx_case(8, 1, w=33, h=13)(name)]),
})
for _c in (0, 1):
    _cn = "packbits" if _c else "raw"
    RASTER_VARIANTS.update({
        f"psd_bitmap_{_cn}.psd": _psd_case(0, 1, bits=1, compression=_c, w=13),
        f"psd_grey_{_cn}.psd": _psd_case(1, 1, compression=_c),
        f"psd_grey_mode0_{_cn}.psd": _psd_case(0, 1, compression=_c),
        f"psd_duotone_{_cn}.psd": _psd_case(8, 1, compression=_c, colour_data="duotone"),
        f"psd_palette_{_cn}.psd": _psd_case(2, 1, compression=_c, colour_data="palette"),
        f"psd_rgb_{_cn}.psd": _psd_case(3, 3, compression=_c),
        f"psd_rgba_{_cn}.psd": _psd_case(3, 4, compression=_c, w=33, h=47),
        f"psd_rgb_extra_channel_{_cn}.psd": _psd_case(3, 5, compression=_c),
        f"psd_cmyk_{_cn}.psd": _psd_case(4, 4, compression=_c),
        f"psd_multichannel_{_cn}.psd": _psd_case(7, 2, compression=_c),
        f"psd_rgb_layers_resources_{_cn}.psd": _psd_case(3, 3, compression=_c, layers=True,
                                                         resources=True),
        f"psd_grey_layers_{_cn}.psd": _psd_case(1, 1, compression=_c, layers=True),
    })
RASTER_VARIANTS["psd_palette_short_colour_data.psd"] = _psd_case(
    2, 1, colour_data=bytes(range(48)))
_TGA_KINDS = [(1, 8, (0, 24, 40)), (3, 1, None), (3, 8, None), (3, 16, None), (2, 16, None),
              (2, 24, None), (2, 32, None)]
for _type, _depth, _cmap in _TGA_KINDS:
    for _rle in ((False,) if _depth == 1 else (False, True)):
        for _flags in (0x00, 0x10, 0x20, 0x30):
            RASTER_VARIANTS[f"tga_type{_type}_{_depth}bit_{'rle' if _rle else 'raw'}"
                            f"_o{_flags:02x}.tga"] = _tga_case(
                _type | (8 if _rle else 0), _depth, _flags, _cmap)
for _md in (16, 24, 32):
    RASTER_VARIANTS[f"tga_palette_map{_md}_start5.tga"] = _tga_case(1, 8, cmap=(5, _md, 35))
    RASTER_VARIANTS[f"tga_palette_map{_md}_rle.tga"] = _tga_case(9, 8, 0x28, cmap=(0, _md, 40))
RASTER_VARIANTS.update({
    "tga_grey_with_colour_map.tga": _tga_case(3, 8, cmap=(0, 24, 256)),
    "tga_grey_alpha_with_colour_map.tga": _tga_case(3, 16, cmap=(0, 24, 256)),
    "tga_grey_with_16bit_colour_map.tga": _tga_case(3, 8, cmap=(2, 16, 100)),
    "tga_id_field_rle_wide.tga": _tga_case(10, 24, 0x20, ident=b"made by a test", w=150, h=9),
    "tga_rle_32bit_wide.tga": _tga_case(10, 32, 0x00, w=300, h=5),
    "tga_rle_1x1.tga": _tga_case(11, 8, h=1, w=1),
})
RASTER_VARIANTS.update({
    "ico_png_bmp_sizes.ico": _ico_case([("png", 16, 16, None, None, 0),
                                        (8, 32, 32, None, None, 0),
                                        ("png", 48, 48, None, None, 0)]),
    "ico_tie_in_area.ico": _ico_case([(32, 24, 24, None, None, 0), (8, 24, 24, None, None, 0),
                                      (4, 24, 24, None, None, 16), (24, 16, 16, None, None, 0)]),
    "ico_png_first_tie.ico": _ico_case([("png", 20, 20, None, None, 0),
                                        (1, 20, 20, None, None, 2)]),
    "ico_bmp_1bit.ico": _ico_case([(1, 13, 6, None, None, 2)]),
    "ico_bmp_4bit.ico": _ico_case([(4, 33, 17, None, None, 16)]),
    "ico_bmp_8bit.ico": _ico_case([(8, 13, 6, None, None, 0)]),
    "ico_bmp_24bit.ico": _ico_case([(24, 13, 6, None, None, 0)]),
    "ico_bmp_32bit_alpha.ico": _ico_case([(32, 13, 6, None, None, 0)]),
    "ico_png_size_differs.ico": _ico_case([("png", 12, 10, 16, None, 0)]),
    "ico_256_png.ico": _ico_case([("png", 256, 256, 0, None, 0), (8, 16, 16, None, None, 0)]),
    "ico_colour_count_depth.ico": _ico_case([(8, 16, 16, None, 0, 0), (4, 16, 16, None, 0, 16)]),
    "cur_two_sizes.cur": _ico_case([(8, 16, 16, None, None, 0), (24, 32, 32, None, None, 0)],
                                   kind=2),
    "cur_zero_means_256.cur": _ico_case([(8, 16, 16, None, None, 0),
                                         (4, 256, 256, 0, None, 16)], kind=2),
    "cur_1bit.cur": _ico_case([(1, 13, 6, None, None, 2)], kind=2),
    "cur_32bit.cur": _ico_case([(32, 9, 7, None, None, 0)], kind=2),
})
for _hs in (12, 40, 52, 56, 64, 108, 124):
    RASTER_VARIANTS[f"dib_header{_hs}_8bit.dib"] = _dib_case(_hs, 8)
RASTER_VARIANTS.update({
    "dib_1bit.dib": _dib_case(40, 1), "dib_4bit.dib": _dib_case(40, 4),
    "dib_24bit_top_down.dib": _dib_case(40, 24, top_down=True),
    "dib_16bit_bitfields.dib": _dib_case(40, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
    "dib_32bit.dib": _dib_case(108, 32),
})
for _bpc in (1, 2):
    for _z, _dims in ((1, (1, 2)), (3, (3,)), (4, (3,))):
        for _dim in _dims:
            for _rle in (False, True):
                RASTER_VARIANTS[f"sgi_{_bpc}byte_{_z}ch_dim{_dim}_{'rle' if _rle else 'raw'}"
                                ".sgi"] = _sgi_case(_bpc, _z, _dim, _rle, 1 if _dim == 1 else 13)
RASTER_VARIANTS["sgi_rle_wide.sgi"] = _sgi_case(1, 3, 3, True, 9, 300)
for _ft in (1, 2):
    _fn = "rle" if _ft == 2 else "raw"
    RASTER_VARIANTS.update({
        f"sun_1bit_{_fn}.sun": _sun_case(1, _ft),
        f"sun_4bit_{_fn}.sun": _sun_case(4, _ft),
        f"sun_8bit_{_fn}.sun": _sun_case(8, _ft),
        f"sun_8bit_palette_{_fn}.sun": _sun_case(8, _ft, palette=200),
        f"sun_4bit_palette_{_fn}.sun": _sun_case(4, _ft, palette=16),
        f"sun_24bit_bgr_{_fn}.sun": _sun_case(24, _ft),
        f"sun_32bit_bgrx_{_fn}.sun": _sun_case(32, _ft),
        f"sun_8bit_even_{_fn}.sun": _sun_case(8, _ft, w=10),
    })
RASTER_VARIANTS.update({
    "sun_24bit_rgb.sun": _sun_case(24, 3), "sun_32bit_rgbx.sun": _sun_case(32, 3),
    "sun_8bit_type0.sun": _sun_case(8, 0), "sun_24bit_type4.sun": _sun_case(24, 4),
    "qoi_rgb.qoi": _qoi_case(3), "qoi_rgba.qoi": _qoi_case(4),
    "qoi_rgb_index_run_only.qoi": _qoi_case(3, ops=("index", "run", "rgb")),
    "qoi_rgba_rgba_only.qoi": _qoi_case(4, ops=("rgba",)),
    "qoi_rgb_wide.qoi": _qoi_case(3, 9, 300),
    "msp_v1.msp": _seeded(lambda b: msp_bytes(b, 1), (13, 6), 2),
    "msp_v1_wide.msp": _seeded(lambda b: msp_bytes(b, 1), (33, 47), 2),
    "msp_v2.msp": _seeded(lambda b: msp_bytes(b, 2, 3), (13, 6), 2),
    "msp_v2_white_rows.msp": _seeded(lambda b: msp_bytes(
        np.where(np.arange(33)[:, None] % 3 == 0, 1, b), 2, 4), (33, 47), 2),
})
for _t in IM_TYPES:
    RASTER_VARIANTS[f"im_{re.sub('[^0-9A-Za-z]+', '_', _t).strip('_')}.im"] = _im_case(_t)
for _t in ("Greyscale image", "L 1 image", "B2 image", "B4 image", "RGB image", "LA image",
           "PA image"):
    for _lut in ("grey", "grey-nonlinear", "colour"):
        RASTER_VARIANTS[f"im_{re.sub('[^0-9A-Za-z]+', '_', _t).strip('_')}_lut_"
                        f"{_lut.replace('-', '_')}.im"] = _im_case(_t, _lut)
RASTER_VARIANTS.update({
    "xbm_x11.xbm": _seeded(xbm_bytes, (13, 6), 2),
    "xbm_hotspot.xbm": _seeded(lambda b: xbm_bytes(b, "cursor", (3, 4)), (33, 47), 2),
    "xbm_1x1.xbm": _seeded(xbm_bytes, (1, 1), 2),
    "xpm_1cpp.xpm": _xpm_case(20, 1),
    "xpm_2cpp.xpm": _xpm_case(200, 2, w=17),
    "xpm_rgb_300_colours.xpm": _xpm_case(300, 2, w=33, h=47),
    "xpm_none_unused.xpm": _xpm_case(20, 1, transparent=" "),
    "pixar_rgb.pxr": _seeded(pixar_bytes, (13, 6, 3)),
    "spider_big_endian.spi": lambda name: spider_bytes(
        _rs(name).uniform(-40, 300, (13, 6)), True),
    "spider_little_endian.spi": lambda name: spider_bytes(
        _rs(name).uniform(-40, 300, (33, 47)), False),
    "spider_stack.spi": lambda name: spider_bytes(_rs(name).uniform(0, 255, (13, 6)), True,
                                                  stack=True),
    "gbr_v1_grey.gbr": _seeded(lambda p: gbr_bytes(p, 1), (13, 6)),
    "gbr_v2_grey.gbr": _seeded(lambda p: gbr_bytes(p, 2), (13, 6)),
    "gbr_v2_rgba.gbr": _seeded(lambda p: gbr_bytes(p, 2), (13, 6, 4)),
    "imt_grey.imt": _seeded(imt_bytes, (13, 6)),
    "imt_no_comment.imt": _seeded(lambda g: imt_bytes(g, False), (33, 47)),
    "mcidas_1byte.area": _seeded(lambda v: mcidas_bytes(v, 1), (13, 6)),
    "mcidas_2byte.area": _seeded(lambda v: mcidas_bytes(v, 2, 4), (13, 6), 600),
    "mcidas_4byte.area": _seeded(lambda v: mcidas_bytes(v, 4), (13, 6), 1000),
    # a line prefix of -8 bytes: lines overlap, which PIL's memory map of the
    # file allows for "L" and "I;16B" samples
    "mcidas_2byte_overlapping_lines.area": lambda name: _patch(
        mcidas_bytes(_rs(name).randint(0, 600, (13, 6)), 2, 4), 56, struct.pack(">i", -8)),
    "xvthumb.p7": _seeded(xvthumb_bytes, (13, 6)),
})


# the variants of the loops above that PIL refuses (see raster_refused)
RASTER_REFUSED_VARIANTS = {name: RASTER_VARIANTS.pop(name) for name in (
    "psd_rgb_extra_channel_packbits.psd", "tga_palette_map32_start5.tga",
    "tga_palette_map32_rle.tga", "im_RLB_image.im", "im_RYB_image.im", "im_PA_image.im",
    "im_B2_image_lut_colour.im", "im_B4_image_lut_colour.im", "im_PA_image_lut_grey.im",
    "im_PA_image_lut_grey_nonlinear.im")}


def raster_small_variants():
    """[(file name, write(path))] of every raster variant of the catalog."""
    return [(name, lambda p, name=name, make=make: _write_bytes(p, make(name)))
            for name, make in RASTER_VARIANTS.items()]


def _patch(data, at, raw):
    return data[:at] + raw + data[at + len(raw):]


def _xpm_transparent_pixel(index, r):
    """An XPM whose first pixel is the key given the colour None (PIL keeps
    no palette entry for it)."""
    data = xpm_bytes(index, r.randint(0, 256, (3, 3)), transparent=" ")
    at = data.index(b"/* pixels */\n") + len(b"/* pixels */\n") + 1
    return data[:at] + b" " + data[at + 1:]


def raster_refused():
    """[(name, file bytes, a word of the port's refusal)]: one file for each
    way PIL refuses a raster format, at its open or at its load."""
    def v(name):
        return {**RASTER_VARIANTS, **RASTER_REFUSED_VARIANTS}[name](name)
    r = np.random.RandomState(5)
    grey = r.randint(0, 256, (13, 6))
    pcx8 = v("pcx_8bit_1planes_v5_w6.pcx")
    tga24 = v("tga_type2_24bit_raw_o20.tga")
    sgi_rle = v("sgi_1byte_1ch_dim2_rle.sgi")
    msp2 = v("msp_v2.msp")
    ico8 = v("ico_bmp_8bit.ico")
    out = [
        ("pcx_unknown_mode", _patch(pcx8, 3, b"\x02"), "unknown PCX mode"),
        ("pcx_truncated", v("pcx_1bit_1planes_v5_w33.pcx")[:150], "truncated"),
        ("pcx_run_past_line", pcx_bytes(r.randint(0, 256, (13, 6, 3)), 8, 3)[:128]
         + b"\xc7\x07" * 40, "buffer overrun"),
        ("pcx_grey_shorter_than_its_palette", pcx_bytes(grey[:2, :3], 8, 1),
         "invalid argument"),
        ("pcx_empty_window", _patch(pcx8, 4, struct.pack("<H", 6)), "PCX whose header"),
        ("dcx_no_pages", struct.pack("<II", 0x3ADE68B1, 0) + pcx8, "DCX whose header"),
        ("psd_16bit", _patch(v("psd_rgb_raw.psd"), 22, b"\x00\x10"), "16-bit"),
        ("psd_not_enough_channels", _patch(v("psd_rgb_raw.psd"), 12, b"\x00\x02"),
         "not enough channels"),
        ("psd_zip_compressed", _patch(v("psd_grey_raw.psd"), 38, b"\x00\x02"),
         "cannot load"),
        ("psd_lab", psd_bytes(r.randint(0, 256, (3, 13, 6)), 9), "LAB"),
        ("psd_truncated", v("psd_rgb_raw.psd")[:-20], "truncated"),
        # PIL reads the byte counts of the mode's channels only
        ("psd_packbits_extra_channel", v("psd_rgb_extra_channel_packbits.psd"), "truncated"),
        ("tga_32bit_colour_map", v("tga_palette_map32_start5.tga"), "unrecognized raw mode"),
        ("tga_15bit_colour_map", _patch(v("tga_palette_map16_start5.tga"), 7, b"\x0f"),
         "map depth 15"),
        ("tga_type1_without_colour_map", tga_bytes(grey[..., None], 1, 8), "unpacker"),
        ("tga_type1_16bit", tga_bytes(r.randint(0, 256, (13, 6, 2)), 1, 16,
                                      (0, r.randint(0, 256, (8, 3)), 24)), "cannot load"),
        ("tga_rle_run_across_rows", _patch(tga24, 2, b"\x0a")[:18]
         + bytes([0x80 | 9]) + b"\1\2\3" * 1 + b"\0" * 200, "buffer overrun"),
        ("tga_rle_1bit", tga_bytes(r.randint(0, 2, (13, 6)), 11, 1), "truncated"),
        ("tga_truncated", tga24[:-7], "truncated"),
        ("tga_colour_map_on_rgb", tga_bytes(r.randint(0, 256, (5, 9, 3)), 2, 24,
                                            (0, r.randint(0, 256, (4, 3)), 24)),
         "colour map on a RGB image"),
        ("ico_and_mask_truncated", ico8[:-20], "AND mask"),
        ("ico_alpha_truncated", v("ico_bmp_32bit_alpha.ico")[:-60], "alpha"),
        ("ico_no_entries", struct.pack("<HHH", 0, 1, 0) + bytes(40), "ICO whose header"),
        ("ico_png_bad_crc", _patch(v("ico_png_size_differs.ico"), 6 + 16 + 29, b"\x00"),
         "ICO whose header"),
        ("cur_no_cursors", struct.pack("<HHH", 0, 2, 0), "CUR whose header"),
        ("dib_2bit", _patch(v("dib_header40_8bit.dib"), 14, b"\x02\x00"), "2-bit"),
        ("dib_jpeg_compressed", _patch(v("dib_header40_8bit.dib"), 16, b"\x04"), "JPEG"),
        ("dib_truncated_header", v("dib_header124_8bit.dib")[:60], "Truncated File Read"),
        ("dib_truncated", v("dib_24bit_top_down.dib")[:-9], "truncated"),
        ("sgi_two_channels", sgi_bytes(r.randint(0, 256, (13, 6, 2)), 1, 3), "Unsupported SGI"),
        ("sgi_compression_2", _patch(v("sgi_1byte_1ch_dim2_raw.sgi"), 2, b"\x02"),
         "cannot load"),
        ("sgi_rle_offset_in_header", _patch(sgi_rle, 512, struct.pack(">I", 100)),
         "buffer overrun"),
        ("sgi_rle_run_past_row", _patch(sgi_rle, struct.unpack_from(">I", sgi_rle, 512)[0],
                                        b"\x7f"), "buffer overrun"),
        ("sgi_rle_tables_past_end", sgi_rle[:560], "buffer overrun"),
        ("sgi_truncated", v("sgi_1byte_3ch_dim3_raw.sgi")[:-11], "truncated"),
        ("sun_16bit", _patch(v("sun_8bit_raw.sun"), 12, struct.pack(">I", 16)),
         "SUN whose header"),
        ("sun_palette_type_2", sun_bytes(grey, 8, 1, r.randint(0, 256, (16, 3)), 2),
         "SUN whose header"),
        ("sun_palette_of_300", sun_bytes(grey, 8, 1, r.randint(0, 256, (300, 3))),
         "palette of 300"),
        ("sun_file_type_6", _patch(v("sun_8bit_raw.sun"), 20, struct.pack(">I", 6)),
         "SUN whose header"),
        ("sun_rle_truncated", v("sun_24bit_bgr_rle.sun")[:-30], "truncated"),
        ("sun_colour_map_on_1bit", sun_bytes(r.randint(0, 2, (5, 9)), 1, 1,
                                             r.randint(0, 256, (2, 3))), "colour map on a 1 image"),
        ("qoi_truncated", v("qoi_rgb.qoi")[:-40], "truncated"),
        ("msp_bad_checksum", _patch(v("msp_v1.msp"), 24, b"\x01\x02"), "MSP whose header"),
        ("msp_v1_truncated", v("msp_v1.msp")[:-3], "truncated"),
        ("msp_v2_row_truncated", msp2[:-3], "truncated"),
        ("msp_v2_row_map_truncated", msp2[:40], "truncated"),
        ("msp_v2_run_cut_short", _patch(msp2, 32, struct.pack("<H", 2)) [:32 + 26]
         + b"\0\4" + msp2[32 + 26 + 2:], "corrupt"),
        ("msp_v2_rows_too_short", msp2[:32] + struct.pack("<13H", *[1] * 13) + b"\1" * 13,
         "fewer bytes"),
        ("im_rlb", v("im_RLB_image.im"), "unpacker"),
        ("im_pa", v("im_PA_image.im"), "unpacker"),
        ("im_ryb", v("im_RYB_image.im"), "unpacker"),
        ("im_pa_grey_lut", v("im_PA_image_lut_grey.im"), "unpacker"),
        ("im_b2_colour_lut", v("im_B2_image_lut_colour.im"), "truncated"),
        ("im_size_not_a_number", im_bytes("Greyscale image", 6, 13, bytes(78)).replace(
            b"6*13", b"6*1x"), "not a number"),
        ("im_no_end_of_header", im_bytes("Greyscale image", 6, 13, b"", pad=False)[:-1],
         "IM whose header"),
        ("im_truncated", v("im_Greyscale_image.im")[:-10], "truncated"),
        ("xbm_truncated", v("xbm_hotspot.xbm")[:-60], "truncated"),
        ("xpm_colour_name", xpm_bytes(grey % 3, r.randint(0, 256, (3, 3))).replace(
            b"c #", b"c white #", 1).replace(b"c white #", b"c white ", 1), "cannot read"),
        ("xpm_transparent_pixel", _xpm_transparent_pixel(grey % 3, r), "no colour"),
        ("pixar_grey", _patch(v("pixar_rgb.pxr"), 424, struct.pack("<HH", 1, 1)),
         "PIXAR whose header"),
        ("pixar_truncated", v("pixar_rgb.pxr")[:-5], "truncated"),
        ("spider_image_of_a_stack", spider_bytes(r.uniform(0, 9, (13, 6)))
         .replace(b"", b"", 0), "stkoffset"),
        ("spider_truncated", v("spider_big_endian.spi")[:-8], "truncated"),
        ("gbr_truncated", v("gbr_v2_rgba.gbr")[:-4], "not enough image data"),
        ("gbr_depth_3", _patch(v("gbr_v1_grey.gbr"), 16, struct.pack(">I", 3)),
         "GBR whose header"),
        ("imt_no_form_feed", b"width 6\nheight 13\npixel n8\n" + bytes(78), "form feed"),
        ("mcidas_3_bytes", _patch(v("mcidas_1byte.area"), 40, struct.pack(">i", 3)),
         "MCIDAS whose header"),
        ("mcidas_lines_past_the_end", _patch(v("mcidas_4byte.area"), 56, struct.pack(">i", 9)),
         "truncated"),
        ("mcidas_truncated", v("mcidas_4byte.area")[:-6], "truncated"),
        ("xvthumb_one_number", v("xvthumb.p7").replace(b"6 13 255", b"613"),
         "invalid literal"),
        ("xvthumb_truncated", v("xvthumb.p7")[:-6], "truncated"),
    ]
    # SPIDER: a 2-D image's header that says it is image 1 of a stack
    spi = bytearray(v("spider_big_endian.spi"))
    struct.pack_into(">f", spi, 26 * 4, 1.0)
    out = [(n, bytes(spi) if n == "spider_image_of_a_stack" else d, w) for n, d, w in out]
    return out


def raster_identified():
    """[(name, file bytes, PIL's format or None and a word of the port's
    refusal)]: files that more than one plugin's test lets in, where PIL's
    order and its caught exceptions decide."""
    r = np.random.RandomState(9)
    grey = r.randint(0, 256, (5, 7)).astype(np.uint8)
    # a DIB header of 108 bytes (a letter "l" first) for an image 0 pixels
    # wide: PIL's DIB open fails on the size, and IM opens the file
    dib = (b"l\0\0\0" + struct.pack("<iiHHI", 0, 1, 1, 24, 0) + bytes(4) + b": 1\n")
    im_text = b"Image type: L 8 image\r\nImage size (x*y): 7*5\r\n"
    dib_im = (dib + im_text).ljust(511, b"\0") + b"\x1a" + grey.tobytes()
    # a PCX header with an empty window: PIL's PCX open fails, TGA opens it
    # (id of 10 bytes, grey, 7 x 5 from the PCX's dpi fields, top-down)
    pcx_tga = bytearray(128)
    pcx_tga[:4] = bytes([10, 0, 3, 8])
    struct.pack_into("<HHHHHH", pcx_tga, 4, 5, 0, 0, 0, 7, 5)
    pcx_tga[16:18] = bytes([8, 0x20])
    pcx_tga = bytes(pcx_tga[:28]) + grey.tobytes()
    # a headerless Targa whose id field is 10 bytes long: PIL's PCX test
    # takes it, and PCX's open refuses it
    tga_id10 = tga_bytes(np.repeat(grey[..., None], 3, -1), 2, 24, id_field=b"0123456789")
    # the same with a colour map length that empties the PCX window: PCX
    # fails as PIL catches it, and TGA decodes the file
    tga_id10_pcx_fails = _patch(tga_id10, 5, struct.pack("<H", 9))
    # a Targa whose first 8 bytes pass GBR's test (header size 512, version
    # 1) and whose GBR width is 0: GBR fails, TGA decodes
    tga_gbr = tga_bytes(grey[..., None], 3, 8, colormap=None)
    tga_gbr = _patch(tga_gbr, 0, b"\x00\x00\x03\x00\x00\x00\x00\x01")
    return [
        ("dib_then_im", dib_im, ("IM", None)),
        ("pcx_then_tga", pcx_tga, ("TGA", None)),
        ("tga_taken_by_pcx", tga_id10, (None, "unknown PCX mode")),
        ("tga_after_pcx_fails", tga_id10_pcx_fails, ("TGA", None)),
        ("gbr_prefix_then_tga", tga_gbr, ("TGA", None)),
        ("mcidas_after_iptc", RASTER_VARIANTS["mcidas_1byte.area"]("mcidas_1byte.area"),
         ("MCIDAS", None)),
    ]


# full-size pages: the same formats with vectorised run coders (numpy only),
# for chip_smoke.py's variants phase on the card's machine

def _row_runs(rows, most):
    """Runs of equal bytes within each row of [h, n] bytes, cut into pieces
    of at most ``most``: (values, counts, row of each piece)."""
    h, n = rows.shape
    flat = np.ascontiguousarray(rows).ravel()
    brk = np.ones(h * n, bool)
    brk[1:] = flat[1:] != flat[:-1]
    brk[::n] = True
    starts = np.flatnonzero(brk)
    lengths = np.diff(np.append(starts, h * n))
    pieces = -(-lengths // most)
    counts = np.full(int(pieces.sum()), most, np.int64)
    counts[np.cumsum(pieces) - 1] = lengths - (pieces - 1) * most
    return np.repeat(flat[starts], pieces), counts, np.repeat(starts // n, pieces)


def _packets(sizes, fill):
    """Concatenated packets: ``fill(out, offsets)`` writes each packet's
    bytes at its offset."""
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.zeros(int(np.sum(sizes)), np.uint8)
    fill(out, offsets)
    return out


def pcx_rle_fast(lines):
    v, c, _ = _row_runs(lines, 63)
    two = (c > 1) | (v >= 0xC0)

    def fill(out, off):
        out[off[~two]] = v[~two]
        out[off[two]] = 0xC0 | c[two]
        out[off[two] + 1] = v[two]
    return _packets(np.where(two, 2, 1), fill).tobytes()


def _pair_packets(v, c, head):
    def fill(out, off):
        out[off] = head(c)
        out[off + 1] = v
    return _packets(np.full(len(v), 2), fill)


def raster_pages(grey_pages):
    """chip_smoke.py's seven full-size raster pages of three grey pages:
    [(file name, file bytes, the "L" pixels PIL decodes it to)]. Runs are
    coded as runs (a single byte as a run of one) where the format allows."""
    a, b, c = (np.ascontiguousarray(p, np.uint8) for p in grey_pages)
    h, w = a.shape
    pages = []

    def pcx_page(samples, bits, end_palette=None):
        lines = _pack_bits(samples) if bits == 1 else samples
        head = pcx_bytes(samples[:1, :8], bits, 1)[:128]
        head = head[:8] + struct.pack("<HH", w - 1, h - 1) + head[12:66] + struct.pack(
            "<H", lines.shape[1]) + head[68:]
        out = head + pcx_rle_fast(lines)
        if end_palette is not None:
            out += b"\x0c" + np.asarray(end_palette, np.uint8).tobytes()
        return out
    pages.append(("pcx_grey_rle.pcx", pcx_page(a, 8, _grey_ramp(256)), a))
    ink = [(p < 128).astype(np.uint8) for p in (b, c)]
    pages.append(("dcx_bilevel.dcx", dcx_bytes([pcx_page(1 - k, 1) for k in ink]),
                  np.where(ink[0] == 1, 0, 255).astype(np.uint8)))
    # TGA, bottom row first: runs of up to 128
    v, n, _ = _row_runs(c[::-1], 128)
    tga = tga_bytes(c[:1, :1, None], 11, 8, flags=0x00)[:18]
    tga = tga[:12] + struct.pack("<HH", w, h) + tga[16:]
    pages.append(("tga_grey_rle.tga", tga + _pair_packets(v, n, lambda k: 0x80 | (k - 1))
                  .tobytes(), c))
    # PSD: PackBits rows, their byte counts first
    v, n, row = _row_runs(a, 128)
    body = _pair_packets(v, n, lambda k: np.where(k == 1, 0, 257 - k)).tobytes()
    counts = (np.bincount(row, minlength=h) * 2).astype(">u2").tobytes()
    psd = psd_bytes(a[None, :1, :1], 1)[:-3]
    psd = psd[:14] + struct.pack(">II", h, w) + psd[22:] + struct.pack(">H", 1)
    pages.append(("psd_grey_packbits.psd", psd + counts + body, a))
    # SGI: per-row runs of up to 127 and a zero atom, with the tables
    flipped = b[::-1]
    v, n, row = _row_runs(flipped, 127)
    per_row = np.bincount(row, minlength=h) * 2 + 1
    atoms = np.zeros(int(per_row.sum()), np.uint8)
    row_at = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    k = np.arange(len(v)) - np.concatenate([[0], np.cumsum(np.bincount(row, minlength=h))
                                            [:-1]])[row]
    atoms[row_at[row] + 2 * k] = n
    atoms[row_at[row] + 2 * k + 1] = v
    head = sgi_bytes(b[:1, :1, None], 1, 2, rle=False)[:512]
    head = head[:6] + struct.pack(">HH", w, h) + head[10:]
    head = _patch(head, 2, b"\x01")
    starts = 512 + 8 * h + row_at
    pages.append(("sgi_grey_rle.sgi", head + starts.astype(">u4").tobytes()
                  + per_row.astype(">u4").tobytes() + atoms.tobytes(), b))
    # SUN: one stream of runs across rows (w is even: no row padding)
    v, n, _ = _row_runs(c.reshape(1, -1), 256)
    three = (n >= 3) | ((v == 0x80) & (n > 1))
    single80 = (v == 0x80) & (n == 1)
    lit = ~three & ~single80

    def fill(out, off):
        out[off[three]], out[off[three] + 1], out[off[three] + 2] = 0x80, n[three] - 1, v[three]
        out[off[single80]] = 0x80
        out[off[single80] + 1] = 0
        out[off[lit]] = v[lit]
        out[off[lit & (n == 2)] + 1] = v[lit & (n == 2)]
    body = _packets(np.where(three, 3, np.where(single80, 2, n)), fill)
    pages.append(("sun_grey_rle.sun", sun_bytes(c[:1, :2], 8, 2)[:4] + struct.pack(
        ">7I", w, h, 8, len(body), 2, 0, 0) + body.tobytes(), c))
    # QOI of the grey page as RGB: runs of the previous pixel, RGB otherwise
    flat = a.ravel()
    same = np.empty(flat.size, bool)
    same[0] = flat[0] == 0
    same[1:] = flat[1:] == flat[:-1]
    brk = np.ones(flat.size, bool)
    brk[1:] = same[1:] != same[:-1]
    starts = np.flatnonzero(brk)
    lengths = np.diff(np.append(starts, flat.size))
    run = same[starts]
    pieces = np.where(run, -(-lengths // 62), lengths)
    pos = np.repeat(starts, pieces) + (np.arange(int(pieces.sum()))
                                       - np.repeat(np.cumsum(pieces) - pieces, pieces)) \
        * np.where(np.repeat(run, pieces), 62, 1)
    is_run = np.repeat(run, pieces)
    run_len = np.minimum(62, np.repeat(starts + lengths, pieces) - pos)

    def fill(out, off):
        out[off[is_run]] = 0xC0 | (run_len[is_run] - 1)
        o = off[~is_run]
        out[o] = 0xFE
        out[o + 1] = out[o + 2] = out[o + 3] = flat[pos[~is_run]]
    body = _packets(np.where(is_run, 1, 4), fill)
    pages.append(("qoi_grey_as_rgb.qoi", b"qoif" + struct.pack(">IIBB", w, h, 3, 0)
                  + body.tobytes() + b"\0" * 7 + b"\1", a))
    return pages
