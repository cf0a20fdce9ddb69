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
    for name, make in TIFF_VARIANTS.items():
        out.append((f"tiff_{name}.tif", lambda p, name=name, make=make: write_tiff(
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
    out += webp_small_variants()
    out += jpeg2000_small_variants()
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
