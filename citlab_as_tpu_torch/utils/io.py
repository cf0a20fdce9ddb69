"""File/path helpers (port of ``citlab_as_tpu/utils/io.py``): images live
next to a ``page/`` folder holding ``<name>.xml``; graph features in
``json*/<name>.json``; confidences in
``confidences/<name>_confidences.json``.

Images are decoded without PIL (the JAX package uses PIL), equal bit for
bit to ``np.asarray(Image.open(path).convert(mode))`` under PIL 12.1:

- PNG (every colour type and bit depth, interlaced (Adam7) or not; 16-bit
  grey is PIL's "I;16", other 16-bit samples keep their high byte), PNM
  (P1 to P6, ASCII or binary, any maxval, rescaled as PIL rescales; P0CMYK
  and PFM) and ``.npy`` with the standard library and numpy;
- JPEG (8-bit; baseline, extended sequential or progressive, Huffman or
  arithmetic coding with its DAC conditioning, lossless with predictors
  1-7 and any point transform; grey, YCbCr/RGB, CMYK or YCCK; restart
  markers, any sampling factors; libjpeg's block smoothing of progressive
  files whose low coefficients stop short) and TIFF (classic or
  little-endian BigTIFF, strips or tiles, either PlanarConfiguration,
  either FillOrder; no compression, PackBits, LZW, Deflate, CCITT modified
  Huffman, Group 3 (1-D and 2-D) and Group 4, JPEG with JPEGTables (grey,
  RGB, YCbCr or CMYK), old-style JPEG behind JPEGInterchangeFormat, YCbCr under
  LZW, Deflate or PackBits as libtiff's RGBA interface converts it (with
  the file's YCbCrCoefficients and ReferenceBlackWhite);
  horizontal and floating-point predictors; 1-, 2-, 4-, 8-, 12-, 16-bit and
  32-bit integer or float samples; grey, palette (with an extra sample:
  "PA", "PX"), RGB(A), CMYK, as PIL's ``OPEN_INFO`` table reads them;
  JPEG-in-TIFF with extra samples or separate planes, separate YCbCr planes)
  by the port's host C++ decoder (``csrc/image_decode.cpp``,
  ``utils/image_native.py``);
- BMP (OS/2 and Windows headers, 1- to 32-bit samples, RLE8 / RLE4,
  bitfields) and the first frame of a GIF (LZW, interlaced or not, global
  or local colour table, transparency) as PIL reads them
  (``utils/bmp_gif.py``, its RLE and LZW in the same C++ library);
- WebP (lossy VP8 with libwebp's loop filters and upsampler, lossless VP8L,
  ALPH alpha, the extended VP8X format, the first frame of an animation)
  as PIL reads it through libwebp (``utils/webp.py``, host C++
  ``csrc/webp_decode.cpp``);
- JPEG 2000 (JP2, JPX and raw J2K codestreams: every progression order,
  tiles and tile-parts, PPM / PPT, every code-block style, ROI, the 5/3 and
  9/7 wavelets, RCT / ICT; grey, "I;16", LA, RGB(A), CMYK, sYCC, palette)
  as PIL reads it through OpenJPEG (``utils/jpeg2000.py``, host C++
  ``csrc/jpeg2000_decode.cpp``).
- the lossless raster formats of PIL's registry: PCX, DCX, PSD, TGA, ICO,
  CUR, DIB, SGI, SUN, QOI, MSP, IM, XBM, XPM, PIXAR, SPIDER, GBR, IMT,
  MCIDAS and XVTHUMB (``utils/raster_formats.py``, host C++
  ``csrc/raster_decode.cpp``);
- the block textures DDS, BLP and FTEX over one BC1-BC7 decoder
  (``utils/textures.py``, host C++ ``csrc/bcn_decode.cpp``), and ICNS, PCD,
  FITS, FLI / FLC and IPTC (``utils/registry_formats.py``, FLI's chunks in
  ``csrc/raster_decode.cpp``);
- AVIF as PIL reads it through libavif, dav1d and libyuv: the HEIF
  container with ``grid`` items and ``avis`` tracks (the first frame), an
  AV1 intra frame with palette, IntraBC, filter intra, CfL, quantizer
  matrices, deblocking, CDEF, loop restoration, superres and film grain,
  8-, 10- and 12-bit 4:0:0 / 4:2:0 / 4:2:2 / 4:4:4, libavif's rescale of a
  frame to its ``ispe``, premultiplied alpha, and libavif's YUV -> RGB
  through libyuv or its own float code (``utils/avif.py``, host C++
  ``csrc/av1_decode.cpp``).

Every file's format is the one ``Image.open`` finds: its plugin order and
the exceptions it catches (``raster_formats.identify``), so a header that
two plugins' tests let in ends where PIL ends. A size past PIL's
decompression-bomb limit (``MAX_IMAGE_PIXELS``) is refused from the header,
once for every format, before any buffer is allocated.

Damaged files of the main path's formats decode as PIL decodes them or
are refused where PIL refuses: JPEG as libjpeg-turbo 3.1 recovers from
corrupt entropy-coded data (its x86 SIMD inverse DCT included), TIFF as
PIL's IFD reader opens it and libtiff's own reading of the directory, its
CCITT decoder and RGBA interface decode it, PNG as PIL's ZipDecode inflates it row by row (the
zlib check is met only where inflate reaches it before the last row), GIF
as far as PIL's reads of the file go (``scripts/fuzz_main_formats.py``).

One deliberate difference: an arithmetic-coded JPEG over 64 KiB, which PIL
12.1 fails on (it feeds libjpeg 64 KiB at a time, and the arithmetic
decoder cannot wait for more), decodes to libjpeg-turbo's pixels of the
whole file.

PIL's mode conversions follow: 16- and 32-bit grey clip to 0-255 (a
16-bit scan comes out almost white, as in the JAX package), floats
truncate, CMYK goes through PIL's RGB.

Grey images are written as PNG (:func:`save_png`, zlib) and as PIL's
baseline JPEG (:func:`save_jpeg`, host C++ ``csrc/image_encode.cpp``);
:func:`resize_bilinear` is PIL's bilinear resize.

Everything else raises :class:`UnsupportedImageFormat` naming the variant:
the formats PIL identifies and the port does not decode (``_NOT_DECODED``:
EPS, WMF, MPEG, BUFR, GRIB, HDF5, which PIL cannot decode here either);
a raster file PIL refuses, and a file whose header PIL's reader rejects,
by the plugin that let it in; other RIFF files than WebP; a WebP or JPEG
2000 file PIL refuses (and a JPEG 2000 file with high-throughput
code-blocks or a Part 2
multi-component transform, which no oracle file here holds); JPEG of another precision than 8 bits, with 2
components, hierarchical, arithmetic-coded lossless or with a DNL marker
(PIL or libjpeg-turbo refuse them all); JPEG- or PNG-in-BMP and the BMP
headers, depths and bitfields layouts PIL refuses; old-style
JPEG-in-TIFF without JPEGInterchangeFormat, uncompressed YCbCr TIFF (PIL
misreads it as RGBX), CIELAB TIFF (PIL's "RGB" of it is LittleCMS's),
big-endian BigTIFF and every TIFF layout PIL does not open; pages whose
PIL pixels are memory the file never wrote; PIL's test-only PNM extensions
("Py" magics). Nothing falls back.
"""
from __future__ import annotations

import glob
import os
import re
import struct
import threading
import zlib
from typing import List

import numpy as np

from citlab_as_tpu_torch.utils import (bmp_gif, image_encode_native, image_native, jpeg2000,
                                       raster_formats, webp)

_IMG_ENDINGS = ("tif", "jpg", "png")
# PIL 12.1's Image.MAX_IMAGE_PIXELS: Image.open refuses more than twice as
# many pixels (DecompressionBombError) in every format
MAX_IMAGE_PIXELS = 89_478_485


def load_text_file(filename: str) -> List[str]:
    out = []
    with open(filename, "r") as f:
        for line in f:
            out.append(line if line == "\n" else line.strip())
    return out


def load_list_file(path_to_list: str) -> List[str]:
    with open(path_to_list, "r") as f:
        return [line.rstrip() for line in f.readlines()]


def get_page_path(image_path: str, page_folder_name: str = "page",
                  append_extension: bool = False) -> str:
    """Image path -> sibling ``page/<name>.xml`` (file_loader.py:23-36)."""
    dir_name = os.path.dirname(image_path)
    image_name = os.path.basename(image_path)
    if append_extension:
        return os.path.join(dir_name, page_folder_name, image_name + ".xml")
    return os.path.join(dir_name, page_folder_name, os.path.splitext(image_name)[0] + ".xml")


_IMAGE_CACHE: "dict" = {}
_IMAGE_CACHE_MAX = 16
# the pipelined workflow loads pages on its main thread and, for a visual
# relation net, on its device thread: every cache update holds this lock
_IMAGE_CACHE_LOCK = threading.Lock()


class UnsupportedImageFormat(ValueError):
    """The file is not an image format this package decodes."""


_SUPPORTED = ("PNG, PNM, .npy, 8-bit JPEG (Huffman, arithmetic, lossless), TIFF, BMP, GIF, "
              "WebP, JPEG 2000, PCX, DCX, PSD, TGA, ICO, CUR, DIB, SGI, SUN, QOI, MSP, IM, XBM, "
              "XPM, PIXAR, SPIDER, GBR, IMT, MCIDAS, XVTHUMB, DDS, BLP, FTEX, ICNS, PCD, FITS, "
              "FLI, IPTC, AVIF (8-bit AV1 intra frames)")
# the formats of PIL's registry that PIL identifies and the port does not decode
_NOT_DECODED = {
    "EPS": "EPS (PIL needs Ghostscript)", "WMF": "WMF (PIL draws it only on Windows)",
    "MPEG": "MPEG (PIL identifies it and has no decoder)",
    "BUFR": "BUFR (PIL's stub plugin has no decoder)",
    "GRIB": "GRIB (PIL's stub plugin has no decoder)",
    "HDF5": "HDF5 (PIL's stub plugin has no decoder)"}


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _format_name(head: bytes, path: str, tried=()) -> str:
    """A file no plugin of PIL's opens: the format whose accept test let it
    in, and why PIL's reader turned it away."""
    if head.startswith(b"\x00\x00\x00\x0cjP"):
        return "JPEG 2000 whose signature box is malformed (PIL refuses it)"
    if head.startswith(b"\xff\x4f"):
        return "JPEG 2000 codestream whose SOC is not followed by SIZ (PIL refuses it)"
    if head.startswith(b"RIFF"):
        if head[8:12] == b"WEBP":
            return (f"WebP whose first chunk is {head[12:16]!r} (PIL opens 'VP8 ', 'VP8L' "
                    "and 'VP8X')")
        return "RIFF, not WebP"
    if head.startswith(b"8BPS") and len(head) >= 26:
        bits, mode = struct.unpack_from(">H", head, 22)[0], struct.unpack_from(">H", head, 24)[0]
        return (f"PSD of {bits}-bit samples in colour mode {mode} (PIL has no mode for it and "
                "cannot identify the file)")
    if tried:
        return " / ".join(f"{name} whose header PIL's reader rejects ({why})"
                          for name, why in tried)
    ext = os.path.splitext(path)[1]
    return f"unknown ({ext or 'no extension'})"


def _identify(data: bytes, path: str):
    """PIL's format of the file (raster_formats.identify) or a refusal."""
    try:
        fmt, im = raster_formats.identify(data)
    except image_native.NativeDecodeError as e:
        raise UnsupportedImageFormat(f"{path}: {e}") from None
    if fmt is None or fmt in _NOT_DECODED:
        name = _NOT_DECODED.get(fmt) or _format_name(data[:64], path, im or ())
        raise UnsupportedImageFormat(
            f"{path}: image format {name} is not supported ({_SUPPORTED})")
    return fmt, im


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _png_broken(data: bytes):
    """Why PIL's PNG open rejects the chunks before the first IDAT (a chunk
    type of other than four word characters, a bad or missing CRC), else
    None: PIL then cannot identify the file."""
    pos = len(_PNG_SIG)
    while True:
        head = data[pos:pos + 8]
        if len(head) < 8:
            return None
        length, kind = struct.unpack(">I4s", head)
        if kind == b"IDAT":
            return None
        if not re.match(rb"\w\w\w\w", kind):
            return f"chunk type {kind!r}"
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length:
            return None
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            return f"bad checksum in {kind!r}"
        if kind == b"IEND":
            return None
        pos += 12 + length


def _png_header(data: bytes, path: str):
    kind, ihdr = next(_png_chunks(data), (b"", b""))
    if kind != b"IHDR" or len(ihdr) != 13:
        raise UnsupportedImageFormat(f"{path}: PNG without a leading IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    return w, h, depth, ctype, interlace


def _png_unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters; returns [h, w * bpp] uint8.

    None, Sub and Up are whole-row operations. Average and Paeth predict a
    byte from its left, upper and upper-left neighbours, so the pixels of
    one anti-diagonal are independent of each other: the image is skewed
    (row y shifted right by y pixels) and reconstructed column by column."""
    stride = w * bpp
    lines = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    filters = lines[:, 0]
    if filters.max(initial=0) > 4:
        raise UnsupportedImageFormat(
            f"PNG scanline filter {int(filters.max())} does not exist")
    if not filters.any():
        return lines[:, 1:]
    if filters.max() <= 2:
        out = lines[:, 1:].copy()
        prev = np.zeros(stride, np.uint8)
        for y in range(h):
            row = out[y]
            if filters[y] == 1:            # Sub: running sum per byte lane
                px = row.reshape(w, bpp)
                np.cumsum(px, axis=0, dtype=np.uint8, out=px)
            elif filters[y] == 2:          # Up
                row += prev
            prev = row
        return out

    px = lines[:, 1:].reshape(h, w, bpp)
    skew = np.zeros((h, h + w, bpp), np.int16)         # skew[y, y + i] = px[y, i]
    for y in range(h):
        skew[y, y:y + w] = px[y]
    rec = np.zeros((h + 1, h + w + 1, bpp), np.int16)  # rec[y + 1, y + i + 2]
    is_sub, is_up, is_avg, is_paeth = (
        (filters == k).astype(np.int16)[:, None] for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        left = rec[y0 + 1:y1 + 1, d + 1]
        up = rec[y0:y1, d + 1]
        upleft = rec[y0:y1, d]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, upleft))
        pred = (is_sub[y0:y1] * left + is_up[y0:y1] * up
                + is_avg[y0:y1] * ((left + up) >> 1) + is_paeth[y0:y1] * paeth)
        rec[y0 + 1:y1 + 1, d + 2] = (skew[y0:y1, d] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = rec[y + 1, y + 2:y + 2 + w]
    return out.reshape(h, stride)


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(raw: bytes, h: int, w: int, depth: int, ch: int) -> np.ndarray:
    """One (sub-)image's filtered scanlines -> its samples [h, w, ch]:
    uint8 for up to 8 bits (packed samples unpacked, unscaled), big-endian
    16-bit samples as uint16."""
    if depth >= 8:
        bpp = ch * depth // 8
        rows = _png_unfilter(raw, h, w, bpp)
        if depth == 16:
            return rows.reshape(h, w * ch, 2).view(">u2").astype(np.uint16).reshape(h, w, ch)
        return rows.reshape(h, w, ch)
    # 1, 2 or 4 bits per sample (grey or palette): the filters work on
    # whole bytes; samples are packed most significant first
    packed = _png_unfilter(raw, h, -(-w * depth // 8), 1)
    bits = np.unpackbits(packed, axis=1)[:, :w * depth].reshape(h, w, depth)
    return (bits @ (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8))[..., None]


def _png_idat_pieces(data: bytes, path: str):
    """The image data as PngImageFile.load_read hands it to PIL's decoder:
    the IDAT chunks from the first on, at most 64 KiB and at most to a
    chunk's end at a time, ended by the first other chunk; and the position
    after the chunk being read, where PIL's load_end goes on."""
    pieces, pos = [], len(_PNG_SIG)
    while True:                        # the chunks before the first IDAT
        head = data[pos:pos + 8]
        if len(head) < 8:
            raise UnsupportedImageFormat(f"{path}: PNG without image data (PIL: truncated)")
        length, kind = struct.unpack(">I4s", head)
        if kind == b"IDAT":
            break
        pos += 12 + length
    while kind == b"IDAT":
        start, end = pos + 8, min(pos + 8 + length, len(data))
        for at in range(start, end, image_native.DECODER_BLOCK):
            pieces.append(data[at:min(at + image_native.DECODER_BLOCK, end)])
        pos += 12 + length
        head = data[pos:pos + 8]
        if len(head) < 8 or end < start + length:
            break                      # the file ends: PIL's read gives nothing more
        length, kind = struct.unpack(">I4s", head)
    return pieces, pos


def _png_inflate(pieces, row_ends, path: str) -> bytes:
    """PIL's ZipDecode: one inflate call for each scanline of ``row_ends``
    (the end of each scanline in the decompressed stream), input as
    ``pieces`` arrive. PIL stops at the last scanline, so the zlib check
    value is met only where inflate reaches it before that; a stream that
    ends at the end of a scanline in a call that completed it ends the
    image there (the rows below stay zero); anything else short of the
    last row is a truncated file. Returns the decompressed scanlines PIL
    applied."""
    total = row_ends[-1]
    d = zlib.decompressobj()
    out = []
    got = 0
    for piece in pieces:
        try:
            chunk = d.decompress(piece, total - got)
        except zlib.error as e:
            raise UnsupportedImageFormat(
                f"{path}: broken PNG data stream ({e}; PIL: broken data stream)") from None
        out.append(chunk)
        got += len(chunk)
        if got == total:
            return b"".join(out)
        if d.eof:
            # inflate ended the stream in the call that completed a row:
            # PIL keeps the rows so far
            if chunk and got in set(row_ends):
                return b"".join(out)
            break
    raise UnsupportedImageFormat(f"{path}: truncated PNG (the image data ends early; PIL: "
                                 "image file is truncated)")


def _png_load_end(data: bytes, pos: int, path: str) -> None:
    """PngImageFile.load_end after the image: the chunks up to IEND are
    read whole, and one that runs past the end of the file raises."""
    while True:
        head = data[pos + 4:pos + 12]
        if len(head) < 8 or not re.match(rb"\w\w\w\w", head[4:]) or head[4:] == b"IEND":
            return
        length, kind = struct.unpack(">I4s", head)
        body = data[pos + 12:pos + 12 + length]
        if len(body) < length:
            raise UnsupportedImageFormat(
                f"{path}: PNG chunk {kind!r} after the image data runs past the end of the "
                "file (PIL: Truncated File Read)")
        if kind == b"IHDR" and (length < 13 or body[11]):
            raise UnsupportedImageFormat(f"{path}: a second IHDR chunk PIL's reader rejects")
        pos += 8 + length


def _decode_png(data: bytes, path: str) -> np.ndarray:
    """As PIL 12.1 decodes PNG, interlaced (Adam7) or not, at every colour
    type and depth: [H, W] grey, [H, W, 2] grey+alpha, [H, W, 3] RGB or
    [H, W, 4] RGBA uint8 (a palette image is expanded to RGB, or RGBA with
    a tRNS chunk); 16-bit colour samples keep their high byte, and 16-bit
    grey is PIL's mode "I;16", uint16 [H, W]. tRNS on a grey or RGB image
    changes no pixel of PIL's "L" or "RGB" conversion, so it is ignored.
    Damaged data is read as PIL's ZipDecode reads it (:func:`_png_inflate`):
    the rows PIL never reaches stay zero."""
    w, h, depth, ctype, interlace = _png_header(data, path)
    broken = _png_broken(data)
    if broken:
        raise UnsupportedImageFormat(f"{path}: broken PNG ({broken}; PIL cannot identify it)")
    if ctype not in _PNG_CHANNELS:
        raise UnsupportedImageFormat(f"{path}: PNG colour type {ctype}")
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if depth not in allowed:
        raise UnsupportedImageFormat(f"{path}: {depth}-bit PNG of colour type {ctype}")
    if interlace > 1:
        raise UnsupportedImageFormat(f"{path}: PNG interlace method {interlace}")
    palette, trns = None, None
    for kind, body in _png_chunks(data):
        if kind == b"IDAT":
            break
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
    ch = _PNG_CHANNELS[ctype]
    # the scanlines (filter byte first) of the image or of each Adam7 pass
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    shapes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    row_bytes = [1 + -(-pw * ch * depth // 8) for _, pw in shapes]
    row_ends = np.cumsum([n for (ph, pw), n in zip(shapes, row_bytes) if ph > 0 and pw > 0
                          for _ in range(ph)]).tolist()
    pieces, end = _png_idat_pieces(data, path)
    raw = _png_inflate(pieces, row_ends, path)
    if len(raw) == row_ends[-1]:
        _png_load_end(data, end, path)
    px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw), size in zip(passes, shapes, row_bytes):
        if ph <= 0 or pw <= 0:
            continue
        rows = min(ph, (len(raw) - pos) // size)
        if rows > 0:
            px[y0:y0 + rows * dy:dy, x0::dx] = _png_samples(raw[pos:pos + rows * size], rows,
                                                             pw, depth, ch)
        pos += ph * size
    if depth == 16:
        if ctype == 0:
            return px[..., 0]
        px = (px >> 8).astype(np.uint8)
    elif depth < 8 and ctype == 0:
        px = px * (255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise UnsupportedImageFormat(f"{path}: palette PNG without PLTE")
        idx = px[..., 0]
        full = np.zeros((256, 3), np.uint8)       # PIL's palette: the entries past the file's black
        full[:min(len(palette), 256)] = palette[:256]
        rgb = full[idx]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:min(len(trns), 256)] = trns[:256]
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return px[..., 0] if ch == 1 else px


_PNM_WHITESPACE = b" \t\n\v\f\r"
# magic -> PIL's mode (PpmImagePlugin.MODES, without its test-only "Py"
# extensions, which are refused by name)
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F"}
_PNM_BANDS = {"1": 1, "L": 1, "RGB": 3, "CMYK": 4, "F": 1}


def _pnm_magic(data: bytes) -> bytes:
    """The magic as PIL reads it: up to six bytes, ended by whitespace."""
    magic = b""
    for c in data[:6]:
        if c in _PNM_WHITESPACE:
            break
        magic += bytes([c])
    return magic


def _pnm_token(data: bytes, pos: int, path: str):
    """One header token and the position after the byte that ended it
    (PpmImageFile._read_token: a comment runs from '#' to CR or LF, and a
    token has at most ten bytes)."""
    token = b""
    while len(token) <= 10 and pos < len(data):
        c = data[pos]
        pos += 1
        if c in _PNM_WHITESPACE:
            if token:
                break
        elif c == ord("#"):
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            pos += 1
        else:
            token += bytes([c])
    if not token or len(token) > 10:
        raise UnsupportedImageFormat(f"{path}: malformed PNM header")
    return token, pos


def _pnm_header(data: bytes, path: str):
    """(magic, PIL's mode, width, height, maxval or the Pf scale, offset of
    the samples)."""
    magic = _pnm_magic(data)
    if magic not in _PNM_MODES:
        raise UnsupportedImageFormat(
            f"{path}: PNM variant {magic.decode(errors='replace')!r} is not supported "
            f"(P1 to P6, P0CMYK and Pf are)")
    pos = len(magic) + (len(magic) < 6)     # the whitespace that ended it
    mode = _PNM_MODES[magic]
    try:
        tokens = []
        for _ in range(2 if mode == "1" else 3):
            token, pos = _pnm_token(data, pos, path)
            tokens.append(float(token) if mode == "F" and len(tokens) == 2 else int(token))
    except ValueError:
        raise UnsupportedImageFormat(f"{path}: malformed PNM header") from None
    w, h = tokens[:2]
    if w <= 0 or h <= 0:
        raise UnsupportedImageFormat(f"{path}: PNM of {w} x {h} pixels (PIL cannot identify it)")
    level = tokens[2] if len(tokens) == 3 else 1
    if mode == "F" and (level == 0 or not np.isfinite(level)):
        raise UnsupportedImageFormat(f"{path}: PFM scale must be finite and non-zero")
    if mode != "F" and not 0 < level < 65536:
        raise UnsupportedImageFormat(f"{path}: PNM maxval {level} out of range")
    if mode == "L" and level > 255:
        mode = "I"
    return magic, mode, w, h, level, pos


def _pnm_plain_values(data: bytes, count: int, path: str) -> np.ndarray:
    """The first ``count`` decimal tokens of an ASCII body, comments cut
    (PpmPlainDecoder._decode_blocks)."""
    body = re.sub(rb"#[^\r\n]*(?:[\r\n]|$)", b"", data)
    tokens = body.split()[:count]
    if any(len(t) > 10 for t in tokens):
        raise UnsupportedImageFormat(f"{path}: PNM token too long")
    try:
        values = np.array([int(t) for t in tokens], np.int64)
    except ValueError:
        raise UnsupportedImageFormat(f"{path}: PNM sample is not a number") from None
    if values.size < count:
        raise UnsupportedImageFormat(f"{path}: PNM data is truncated")
    return values


def _decode_pnm(data: bytes, path: str) -> np.ndarray:
    """PBM, PGM, PPM (ASCII or binary, any maxval), P0CMYK and PFM as PIL
    12.1 decodes them: samples rescaled to 0-255 as
    ``round(v / maxval * 255)`` (round half to even) where maxval is not
    255; a grey map of maxval over 255 becomes PIL's 32-bit mode "I",
    scaled to 0-65535 (unscaled at 65535); a colour map of 16-bit samples
    is scaled to 0-255. Returns uint8 [H, W] / [H, W, C] (CMYK already
    converted to RGB), int32 [H, W] for mode "I", float32 [H, W] for PFM."""
    magic, mode, w, h, level, pos = _pnm_header(data, path)
    bands = 1 if mode == "I" else _PNM_BANDS[mode]
    count = w * h * bands
    body = data[pos:]
    if magic == b"P1":
        digits = re.sub(rb"#[^\r\n]*(?:[\r\n]|$)", b"", body)
        digits = b"".join(digits.split())[:count]
        if digits.strip(b"01"):
            raise UnsupportedImageFormat(f"{path}: PBM data holds other digits than 0 and 1")
        if len(digits) < count:
            raise UnsupportedImageFormat(f"{path}: PNM data is truncated")
        px = np.where(np.frombuffer(digits, np.uint8) == ord("1"), 0, 255).astype(np.uint8)
    elif magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise UnsupportedImageFormat(f"{path}: PNM data is truncated")
        bits = np.unpackbits(np.frombuffer(body, np.uint8, stride * h).reshape(h, stride),
                             axis=1)[:, :w]
        px = np.where(bits == 1, 0, 255).astype(np.uint8)
    elif mode == "F":
        if len(body) < 4 * count:
            raise UnsupportedImageFormat(f"{path}: PNM data is truncated")
        px = np.frombuffer(body, "<f4" if level < 0 else ">f4", count)
        px = px.reshape(h, w)[::-1].astype(np.float32)     # rows run bottom to top
    else:
        out_max = 65535 if mode == "I" else 255
        if magic in (b"P2", b"P3"):
            values = _pnm_plain_values(body, count, path)
            if (values < 0).any():
                raise UnsupportedImageFormat(f"{path}: negative PNM sample (PIL: channel value "
                                             "is negative)")
            if (values > level).any():
                raise UnsupportedImageFormat(f"{path}: PNM sample above maxval {level}")
        else:
            width = 1 if level < 256 else 2
            if len(body) < width * count:
                raise UnsupportedImageFormat(f"{path}: PNM data is truncated")
            values = np.frombuffer(body, np.uint8 if width == 1 else ">u2", count)
        if level != out_max:
            values = np.minimum(np.rint(values / level * out_max), out_max)
        px = values.astype(np.int32 if mode == "I" else np.uint8)
    if bands == 1:
        return px.reshape(h, w)
    px = px.reshape(h, w, bands)
    return image_native.cmyk_to_rgb(px) if mode == "CMYK" else px


def _decode(path: str, mode: str = "L") -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
            raise UnsupportedImageFormat(
                f"{path}: .npy image must be uint8 [H, W] or [H, W, C]")
        return arr
    with open(path, "rb") as f:
        data = f.read()
    return _decode_data(data, path, mode)


def _decode_data(data: bytes, path: str, mode: str = "L") -> np.ndarray:
    """An image file's bytes, identified and decoded as ``Image.open``
    identifies and loads them (``path`` names it in errors)."""
    fmt, im = _identify(data, path)
    _bomb_check(_size(data, path, fmt, im), path)
    if fmt == "PNG":
        return _decode_png(data, path)
    if fmt == "PPM":
        return _decode_pnm(data, path)
    if fmt in ("JPEG", "TIFF"):
        return _native(image_native.decode, data, path)
    if fmt in ("BMP", "GIF"):
        return _native(lambda d: bmp_gif.decode(d, mode), data, path)
    if fmt == "WEBP":
        return _native(webp.decode, data, path)
    if fmt == "JPEG2000":
        return _native(lambda d: jpeg2000.decode(d, mode), data, path)
    return _native(lambda d: im.decode(d, mode), data, path)


def _native(fn, data: bytes, path: str):
    try:
        return fn(data)
    except image_native.NativeDecodeError as e:
        raise UnsupportedImageFormat(f"{path}: {e}") from None


def _grey8(arr: np.ndarray) -> np.ndarray:
    """PIL's conversion of a single-band 16-bit ("I;16"), 32-bit ("I") or
    float ("F") image to "L": values clip to 0-255, floats truncate toward
    zero (NaN becomes 0); "RGB" repeats the result."""
    if arr.dtype == np.float32:
        out = np.zeros(arr.shape, np.uint8)
        inside = (arr > 0) & (arr < 255)
        out[inside] = arr[inside].astype(np.uint8)
        out[arr >= 255] = 255
        return out
    return np.clip(arr, 0, 255).astype(np.uint8)


def _to_mode(arr: np.ndarray, mode: str) -> np.ndarray:
    """Decoded image -> 'L' [H, W] or 'RGB' [H, W, 3] uint8, by PIL's
    rules. The decoders give uint8 [H, W, C] for PIL's 8-bit modes (1 to 4
    channels: L, LA, RGB, RGBA; "1" as 0/255, palette and CMYK already as
    RGB), uint16 [H, W] for "I;16", int32 [H, W] for "I" and float32
    [H, W] for "F". Alpha is dropped; grey from colour is ITU-R 601-2 luma
    in 16-bit fixed point, ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``."""
    if arr.dtype != np.uint8:
        arr = _grey8(arr)
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    if ch in (2, 4):
        arr = arr[..., :ch - 1]
        ch -= 1
    if ch == 1:
        grey = arr.reshape(arr.shape[:2])
        if mode == "L":
            return np.ascontiguousarray(grey)
        return np.repeat(grey[..., None], 3, axis=-1)
    if mode == "RGB":
        return np.ascontiguousarray(arr)
    rgb = arr.astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)


def _size(data: bytes, path: str, fmt: str, im):
    """(width, height) of the file as PIL's open reports it, from the
    headers alone."""
    if fmt == "PNG":
        broken = _png_broken(data)
        if broken:
            raise UnsupportedImageFormat(f"{path}: broken PNG ({broken}; PIL cannot identify it)")
        return _png_header(data, path)[:2]
    if fmt == "PPM":
        return _pnm_header(data, path)[2:4]
    if fmt in ("JPEG", "TIFF"):
        # the JPEG frame header or the TIFF IFD may lie anywhere in the file
        return _native(image_native.info, data, path)[:2]
    if fmt in ("BMP", "GIF"):
        return _native(bmp_gif.size, data, path)
    if fmt == "WEBP":
        return _native(webp.size, data, path)
    if fmt == "JPEG2000":
        return _native(jpeg2000.size, data, path)
    return tuple(im.size)


def _bomb_check(size, path: str) -> None:
    """Image.open's ``_decompression_bomb_check``: past twice
    MAX_IMAGE_PIXELS, PIL raises DecompressionBombError before any pixel is
    decoded."""
    w, h = size
    if max(1, w) * max(1, h) > 2 * MAX_IMAGE_PIXELS:
        raise UnsupportedImageFormat(
            f"{path}: {w} x {h} pixels is a decompression bomb for PIL (past its "
            f"decompression-bomb limit of {2 * MAX_IMAGE_PIXELS} pixels)")


def image_size(path_to_image: str):
    """(width, height) without decoding the pixels; a size past PIL's
    decompression-bomb limit raises, as ``Image.open`` does."""
    if path_to_image.endswith(".npy"):
        arr = np.load(path_to_image, mmap_mode="r")
        return int(arr.shape[1]), int(arr.shape[0])
    with open(path_to_image, "rb") as f:
        data = f.read()
    fmt, im = _identify(data, path_to_image)
    size = _size(data, path_to_image, fmt, im)
    _bomb_check(size, path_to_image)
    return size


def load_image(path_to_image: str, mode: str = "L") -> np.ndarray:
    """Load an image as a numpy array (grayscale 'L' or 'RGB').

    Bounded mtime-keyed LRU: in one workflow pass several stages load the
    same page image; the second and later loads are free. Results are
    read-only views."""
    if mode not in ("L", "RGB"):
        raise ValueError(f"mode must be 'L' or 'RGB', got {mode!r}")
    key = (os.path.abspath(path_to_image), mode)
    try:
        mtime = os.path.getmtime(path_to_image)
    except OSError:
        mtime = None
    with _IMAGE_CACHE_LOCK:
        entry = _IMAGE_CACHE.pop(key, None)
        if entry is not None and entry[0] == mtime:
            _IMAGE_CACHE[key] = entry               # LRU bump
            return entry[1]
    arr = _to_mode(_decode(path_to_image, mode), mode)
    arr.flags.writeable = False
    with _IMAGE_CACHE_LOCK:
        _IMAGE_CACHE[key] = (mtime, arr)
        while len(_IMAGE_CACHE) > _IMAGE_CACHE_MAX:
            _IMAGE_CACHE.pop(next(iter(_IMAGE_CACHE)))
    return arr


def save_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey) or [H, W, 3] (RGB) array as an 8-bit
    non-interlaced PNG with filter 0 on every scanline."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    ctype = {2: 0, 3: 2}[image.ndim]
    rows = np.zeros((h, 1 + image[0].size), np.uint8)
    rows[:, 1:] = image.reshape(h, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def save_jpeg(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W] grey array as the baseline JPEG that PIL 12.1
    writes for ``Image.fromarray(image).save(path)`` (libjpeg-turbo 3.1,
    quality 75, JFIF 1.01), byte for byte (``csrc/image_encode.cpp``)."""
    data = image_encode_native.jpeg_encode_grey(image)
    with open(path, "wb") as f:
        f.write(data)


def resize_bilinear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(image).resize((width, height), Image.BILINEAR)`` of
    a uint8 [H, W] grey array, bit for bit: PIL's two-pass resample, its
    support scaled by the reduction, 22-bit fixed-point coefficients
    (``csrc/image_encode.cpp``)."""
    return image_encode_native.resize_bilinear(image, width, height)


def get_img_from_page_path(page_path: str) -> str:
    """page/<name>.xml -> the sibling image file (path_util.py:15-31)."""
    base = re.sub(r"/page/([-\w.]+)\.xml$", r"/\1", page_path)
    if base.endswith(_IMG_ENDINGS) and os.path.isfile(base):
        return base
    for ending in _IMG_ENDINGS:
        candidate = re.sub(r"/page/([-\w.]+)\.xml$", r"/\1." + ending, page_path)
        if os.path.isfile(candidate):
            return candidate
    raise IOError(f"No image file (tif, png, jpg) found for page xml {page_path}")


def get_img_from_json_path(json_path: str) -> str:
    base = re.sub(r"/json\w*/([-\w.]+)\.json$", r"/\1", json_path)
    if base.endswith(_IMG_ENDINGS) and os.path.isfile(base):
        return base
    stems = [base]
    if base.endswith(".xml"):     # jsons named <page>.xml.json
        stems.append(base[:-4])
    for stem in stems:
        for ending in _IMG_ENDINGS:
            candidate = f"{stem}.{ending}"
            if os.path.isfile(candidate):
                return candidate
    raise IOError(f"No image file (tif, png, jpg) found for json {json_path}")


def get_page_from_img_path(img_path: str) -> str:
    page_path = re.sub(r"/([-\w.]+)$", r"/page/\1.xml", img_path)
    if os.path.isfile(page_path):
        return page_path
    page_path = re.sub(r"/([-\w.]+)\.\w+$", r"/page/\1.xml", img_path)
    if not os.path.isfile(page_path):
        raise IOError(f"No page xml found for image {img_path}")
    return page_path


def get_page_from_json_path(json_path: str) -> str:
    page_path = re.sub(r"/json\w*/([-\w.]+)$", r"/page/\1.xml", json_path)
    if os.path.isfile(page_path):
        return page_path
    page_path = re.sub(r"/json\w*/([-\w.]+)\.json$", r"/page/\1.xml", json_path)
    if not os.path.isfile(page_path):
        raise IOError(f"No page xml found for json {json_path}")
    return page_path


def get_page_from_conf_path(conf_path: str) -> str:
    page_path = re.sub(r"/confidences/([-\w.]+)_confidences\.json$", r"/page/\1.xml", conf_path)
    if not os.path.isfile(page_path):
        raise IOError(f"No page xml found for confidence json {conf_path}")
    return page_path


def get_path_from_exportdir(model_dir: str, pattern: str, not_pattern: str) -> str:
    """Find the single exported model file matching ``pattern`` in
    <model_dir>/export (path_util.py:6-12)."""
    export_dir = os.path.join(model_dir, "export")
    names = [x for x in glob.glob1(export_dir, pattern) if not_pattern not in x]
    if len(names) != 1:
        raise IOError(
            f"Found {len(names)} '{pattern}' files in {export_dir}, there must be exactly one.")
    return os.path.join(export_dir, names[0])


def prepend_folder_name(file_path: str) -> str:
    folder_path = os.path.dirname(file_path)
    return os.path.join(
        folder_path, os.path.basename(folder_path) + "_" + os.path.basename(file_path))
