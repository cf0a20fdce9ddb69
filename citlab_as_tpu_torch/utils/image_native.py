"""ctypes bindings of the port's host image decoder
(``csrc/image_decode.cpp``): JPEG and TIFF files to arrays equal to PIL's
decode (see the source for what is decoded and what raises), and the RLE
and LZW stages of the BMP and GIF readers (``utils/bmp_gif.py``).

The decoder yields a TIFF's samples as they are stored (1-, 2- and 4-bit
samples unpacked, 16- and 32-bit ones in native byte order, palettes and
YCbCr already RGB); :func:`decode` then applies PIL 12.1's reading of
the tags (``TiffImagePlugin.OPEN_INFO``: which layouts PIL opens, in which
mode, with which unpacking), so that the result is PIL's image in the
representation ``utils/io.py`` converts from.

The library is built with the host C++ compiler at first use
(``ops/kernels/build.py``); a failed build raises, and there is no other
decoder of these formats in the port. Deflate-compressed TIFF strips are
inflated by the standard library's ``zlib`` through a callback. The
decoder keeps no state between calls, and ctypes releases the GIL while
it runs, so threads decode pages side by side.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Tuple

import numpy as np

_ERRLEN = 512
_INFO_LEN = 32
_INFLATE_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64)


# ImageFile.decodermaxblock: PIL hands its decoders at most this many bytes
# of the file at a time (where a decoder stops at such a boundary decides
# what PIL makes of a damaged GIF or PNG)
DECODER_BLOCK = 65536


class NativeDecodeError(ValueError):
    """The decoder refused the file; the message names the variant."""


@_INFLATE_FN
def _inflate(src, n, dst, dst_n):
    """zlib stream at ``src`` -> at most ``dst_n`` bytes at ``dst``; the
    count written, or ``-(count + 1)`` for corrupt data, the bytes inflate
    gave before it met the fault written (as libtiff's ZIPDecode leaves
    them)."""
    data = ctypes.string_at(src, n)
    try:
        out = zlib.decompressobj().decompress(data, dst_n)
    except zlib.error:
        # again a byte at a time, to the fault
        d, parts, got = zlib.decompressobj(), [], 0
        try:
            for k in range(n):
                part = d.decompress(data[k:k + 1], dst_n - got)
                parts.append(part)
                got += len(part)
                if got >= dst_n:
                    break
        except zlib.error:
            pass
        out = b"".join(parts)[:dst_n]
        ctypes.memmove(dst, out, len(out))
        return -len(out) - 1
    ctypes.memmove(dst, out, len(out))
    return len(out)


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("image_decode")
    lib.citlab_image_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                      ctypes.c_int32]
    lib.citlab_image_info.restype = ctypes.c_int32
    lib.citlab_image_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64, _INFLATE_FN, ctypes.c_char_p,
                                        ctypes.c_int32]
    lib.citlab_image_decode.restype = ctypes.c_int32
    lib.citlab_bmp_rle.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.citlab_bmp_rle.restype = ctypes.c_int64
    lib.citlab_gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int32]
    lib.citlab_gif_lzw.restype = ctypes.c_int64
    return lib


# PIL 12.1's TiffImagePlugin.OPEN_INFO: (big-endian, photometric,
# SampleFormat, FillOrder, BitsPerSample, ExtraSamples) -> (mode, rawmode)
# for the layouts this decoder yields. A key PIL lacks is a file PIL does
# not open. Bilevel, 2- and 4-bit samples follow PIL's rawmodes "1", "L;2",
# "L;4" and their inverted ("I") forms; the bit reversal of FillOrder 2
# (the "R" forms) is undone by the decoder, as libtiff does.
_OPEN_INFO = {}
for _be in (False, True):
    for _fill in (1, 2):
        for _photo in (0, 1):
            _inv = "I" if _photo == 0 else ""
            _OPEN_INFO[(_be, _photo, (1,), _fill, (1,), ())] = ("1", "1;" + _inv)
            for _bits in (2, 4):
                _OPEN_INFO[(_be, _photo, (1,), _fill, (_bits,), ())] = ("L", f"L;{_bits}{_inv}")
            _OPEN_INFO[(_be, _photo, (1,), _fill, (8,), ())] = ("L", "L;" + _inv)
        for _bits in (1, 2, 4, 8):
            _OPEN_INFO[(_be, 3, (1,), _fill, (_bits,), ())] = ("P", "P")
    _OPEN_INFO[(_be, 1, (2,), 1, (8,), ())] = ("L", "L;")
    for _photo in (0, 1):
        _OPEN_INFO[(_be, _photo, (3,), 1, (32,), ())] = ("F", "F;32BF" if _be else "F;32F")
    _OPEN_INFO[(_be, 1, (2,), 1, (16,), ())] = ("I", "I;16BS" if _be else "I;16S")
    _OPEN_INFO[(_be, 1, (2,), 1, (32,), ())] = ("I", "I;32BS" if _be else "I;32S")
    _OPEN_INFO[(_be, 1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
    _OPEN_INFO[(_be, 2, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGB")
    _OPEN_INFO[(_be, 2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB")
    _OPEN_INFO[(_be, 2, (1,), 1, (8, 8, 8, 8), ())] = ("RGBA", "RGBA")
    for _extra, _mode in (((0,), "RGB"), ((0, 0), "RGB"), ((0, 0, 0), "RGB"),
                          ((1,), "RGBa"), ((1, 0), "RGBa"), ((1, 0, 0), "RGBa"),
                          ((2,), "RGBA"), ((2, 0), "RGBA"), ((2, 0, 0), "RGBA"),
                          ((999,), "RGBA")):
        _OPEN_INFO[(_be, 2, (1,), 1, (8,) * (3 + len(_extra)), _extra)] = (
            _mode.upper(), _mode)
    _OPEN_INFO[(_be, 2, (1,), 1, (16, 16, 16), ())] = ("RGB", "RGB;16")
    _OPEN_INFO[(_be, 2, (1,), 1, (16,) * 4, ())] = ("RGBA", "RGBA;16")
    _OPEN_INFO[(_be, 2, (1,), 1, (16,) * 4, (0,))] = ("RGB", "RGB;16")
    _OPEN_INFO[(_be, 2, (1,), 1, (16,) * 4, (1,))] = ("RGBA", "RGBa;16")
    _OPEN_INFO[(_be, 2, (1,), 1, (16,) * 4, (2,))] = ("RGBA", "RGBA;16")
    for _extra in ((), (0,), (0, 0)):
        _OPEN_INFO[(_be, 5, (1,), 1, (8,) * (4 + len(_extra)), _extra)] = ("CMYK", "CMYK")
    # a palette index with an extra sample: alpha ("PA") or ignored ("PX")
    _OPEN_INFO[(_be, 3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
    _OPEN_INFO[(_be, 3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
    _OPEN_INFO[(_be, 8, (1,), 1, (8, 8, 8), ())] = ("LAB", "LAB")
    _OPEN_INFO[(_be, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16")
    _OPEN_INFO[(_be, 6, (1,), 1, (8,), ())] = ("L", "L;")
    _OPEN_INFO[(_be, 6, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGB")
# 16-bit grey and unsigned 32-bit exist in PIL's table for one byte order only
_OPEN_INFO[(False, 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
_OPEN_INFO[(False, 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
_OPEN_INFO[(True, 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
_OPEN_INFO[(False, 1, (1,), 2, (16,), ())] = ("I;16", "I;16")
_OPEN_INFO[(False, 1, (1,), 1, (32,), ())] = ("I", "I;32N")
_OPEN_INFO[(False, 1, (1,), 1, (12,), ())] = ("I;16", "I;12")
del (_be, _fill, _photo, _inv, _bits, _extra, _mode)


def _info(data: bytes) -> np.ndarray:
    out = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_image_info(data, len(data), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), err, _ERRLEN):
        raise NativeDecodeError(err.value.decode())
    return out


def _pil_tiff_mode(m: np.ndarray) -> Tuple[str, str]:
    """PIL's (mode, rawmode) of a TIFF (TiffImageFile._setup), from the
    tags ``citlab_image_info`` read; raises where PIL does not open it."""
    photo = int(m[5]) if m[5] >= 0 else 0           # PIL's default: MinIsWhite
    n_sf, sf = int(m[14]), int(m[15])
    if n_sf == 0 or (n_sf > 1 and m[16] and sf == 1):
        sample_format = (1,)
    else:
        sample_format = (sf,) * n_sf if m[16] else (-1,) * n_sf
    # PIL's default: an old-style JPEG (compression 6) has 3 samples
    spp = int(m[11]) if m[11] >= 0 else (3 if int(m[6]) == 6 else 1)
    n_bps = max(int(m[12]), 1)
    if spp > 6:
        raise NativeDecodeError(f"TIFF: {spp} samples per pixel")
    if spp < n_bps or n_bps == 1:
        n_bps = spp
    if int(m[17]) > 3:
        raise NativeDecodeError("TIFF: more than three extra samples")
    extra = tuple(int(x) for x in m[18:18 + int(m[17])])
    key = (bool(m[9]), photo, sample_format, int(m[8]), (int(m[13]),) * n_bps, extra)
    if n_bps != spp or key not in _OPEN_INFO:
        raise NativeDecodeError(
            f"TIFF: PIL does not read this sample layout (photometric {photo}, "
            f"SampleFormat {sample_format}, FillOrder {int(m[8])}, "
            f"{spp} x {int(m[13])}-bit samples, ExtraSamples {extra})")
    return _OPEN_INFO[key]


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB: ``255 - c`` scaled by ``(255 - k) / 255``, with
    its rounding (``MULDIV255``); PIL's CMYK -> L is the luma of this."""
    inv = 255 - cmyk.astype(np.int32)
    t = inv[..., :3] * inv[..., 3:] + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacking: colour * 255 / alpha, truncated and clipped;
    zero alpha gives a zero pixel."""
    a = rgba[..., 3:].astype(np.int32)
    rgb = np.where(a == 0, 0, np.minimum(rgba[..., :3].astype(np.int32) * 255
                                         // np.maximum(a, 1), 255))
    rgb = np.where(a == 255, rgba[..., :3], rgb)
    return np.concatenate([rgb.astype(np.uint8), rgba[..., 3:]], axis=-1)


def _raw_planar_rawmode(mode: str, rawmode: str, m: np.ndarray) -> str:
    """PIL reads each plane of an uncompressed planar TIFF with one letter
    of its rawmode: whole-byte bands come out as stored (a MinIsWhite image
    is not inverted), 32-bit little-endian "I" and "F" planes too; a letter
    PIL has no unpacker for in the mode ("LA": "L" and "A", "PA", "RGBX":
    "X", "RGBa": "a") is refused by PIL ("unknown raw mode"), and any other
    layout is read wrongly or refused by PIL, and raises here."""
    bps, spp = int(m[13]), int(m[11]) if m[11] >= 0 else 1
    if (mode in ("LA", "PA") or rawmode == "PX" or rawmode.startswith("RGBa")
            or (mode == "RGB" and spp > 3)):
        raise NativeDecodeError(
            f"TIFF: uncompressed PlanarConfiguration 2 of PIL mode {mode} (rawmode "
            f"{rawmode}): PIL has no unpacker for its planes (unknown raw mode)")
    bands = 1 if mode in ("1", "L", "P", "I", "F", "I;16") else len(mode)
    plain = (int(m[8]) == 1 and spp == bands
             and (bps == 8 or (bps == 1 and mode == "1")
                  or (bps == 32 and not m[9] and mode in ("I", "F"))))
    if not plain:
        raise NativeDecodeError(
            f"TIFF: uncompressed PlanarConfiguration 2 with {spp} x {bps}-bit samples "
            f"(rawmode {rawmode}) is not read as stored by PIL")
    return {"1": "1;", "L": "L;"}.get(mode, rawmode)


def _tiff_as_pil(raw: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The decoder's samples -> PIL's image (uint8 for 8-bit modes, CMYK as
    RGB; uint16 "I;16"; int32 "I"; float32 "F")."""
    mode, rawmode = _pil_tiff_mode(m)
    if int(m[6]) == 1 and int(m[7]) == 2:
        rawmode = _raw_planar_rawmode(mode, rawmode, m)
    if mode in ("P", "PA") or (int(m[5]) == 6 and raw.shape[-1] == 3):
        # palette (RGB, and the extra sample as alpha for "PA") and YCbCr:
        # RGB from the decoder
        out = raw if mode == "PA" else raw[..., :3]
    elif mode == "1":
        out = (raw[..., 0] if rawmode == "1;" else 1 - raw[..., 0]) * np.uint8(255)
    elif rawmode.startswith("L;") and mode == "L":
        bits = int(m[13])
        scale = 255 // ((1 << bits) - 1) if bits < 8 else 1
        out = raw[..., 0] * np.uint8(scale)
        if rawmode.endswith("I"):
            out = 255 - out
    else:
        # libtiff hands PIL native-order samples; these three rawmodes read
        # them as big-endian all the same (PIL rewrites only ";16B" to ";16N")
        if int(m[6]) != 1 and rawmode in ("F;32BF", "I;16BS", "I;32BS"):
            raw = raw.byteswap()
        if mode in ("I;16", "F"):
            out = raw[..., 0].view(np.float32) if mode == "F" else raw[..., 0]
        elif mode == "I":
            out = raw[..., 0].view(np.int16 if raw.dtype == np.uint16 else np.int32)
            out = out.astype(np.int32)
        else:
            if raw.dtype == np.uint16:
                raw = (raw >> 8).astype(np.uint8)     # the high byte of each sample
            if mode == "LA":
                out = raw
            elif mode == "CMYK":
                out = cmyk_to_rgb(raw[..., :4])
            elif rawmode.startswith("RGBa"):
                out = _unpremultiply(raw[..., :4])
            else:
                out = raw[..., :len(mode)]
    return np.ascontiguousarray(out)


def _libtiff_rows_as_pil(data: bytes, m: np.ndarray) -> np.ndarray:
    """A compressed TIFF whose directory libtiff reads otherwise than PIL's
    IFD reader (a tag PIL never reached, the first of duplicate tags):
    PIL's TiffDecode.c reads libtiff's rows (scanlines, or RGBA pixels
    from its RGBA interface) and unpacks the start of each with its own
    rawmode. The decoder gives those rows; this reads them as PIL does,
    into the samples :func:`_tiff_as_pil` takes."""
    mode, rawmode = _pil_tiff_mode(m)
    w, h, row_bytes = int(m[0]), int(m[1]), int(m[23])
    photo = int(m[5]) if m[5] >= 0 else 0
    if mode in ("P", "PA"):
        raise NativeDecodeError(
            "TIFF: a palette image whose directory libtiff reads otherwise than PIL's IFD "
            "reader is not supported")
    rows = np.empty((h, row_bytes), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_image_decode(data, len(data), rows.ctypes.data, rows.nbytes, _inflate,
                                  err, _ERRLEN):
        raise NativeDecodeError(err.value.decode())
    bps = int(m[13])
    spp = int(m[11]) if m[11] >= 0 else (3 if int(m[6]) == 6 else 1)
    # PIL's unpacker: YCbCr pixels come as "RGBX" (4 bytes), but straight
    # RGB from new-style JPEG in one plane
    if photo == 6 and not (int(m[6]) == 7 and int(m[7]) == 1):
        per_pixel, k = 4, 4
    else:
        per_pixel, k = spp, spp
    need = (w * per_pixel * bps + 7) // 8
    if row_bytes < need:
        raise NativeDecodeError(
            f"TIFF: libtiff's rows of {row_bytes} bytes are shorter than the {need} bytes "
            "PIL's unpacker reads (PIL: strip is not large enough, decoder error)")
    # TiffDecode.c _decodeStrip: PIL's strip of rows per strip rows of its
    # own bytes must hold TIFFStripSize (RGBA rows are not checked)
    strip_bytes, pil_rows = int(m[25]), int(m[26])
    if not m[27] and (pil_rows < 0 or pil_rows * need < strip_bytes):
        raise NativeDecodeError(
            f"TIFF: libtiff's strips of {strip_bytes} bytes are larger than PIL's strip of "
            f"{max(pil_rows, 0)} rows of {need} bytes (PIL: decoder error)")
    head = rows[:, :need]
    if bps in (8, 16, 32):
        vals = np.ascontiguousarray(head).view({8: np.uint8, 16: np.uint16, 32: np.uint32}[bps])
    else:
        bits = np.unpackbits(head, axis=1)[:, :w * k * bps].reshape(h, w * k, bps)
        vals = (bits.astype(np.uint16) << np.arange(bps - 1, -1, -1, dtype=np.uint16)).sum(
            -1, dtype=np.uint16)
        vals = vals.astype(np.uint8) if bps < 8 else vals
    vals = vals.reshape(h, w, k)
    return vals[..., :3] if photo == 6 else vals


def bmp_rle(data: bytes, start: int, rle4: bool, width: int, height: int):
    """PIL's RLE8 / RLE4 decoding of a BMP's samples from ``data[start:]``:
    (uint8 [height, width] in the file's row order, the count of samples
    PIL's decoder produced; fewer than width * height and PIL refuses)."""
    out = np.zeros((height, width), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    got = _lib().citlab_bmp_rle(data, len(data), start, int(rle4), width, height,
                                out.ctypes.data, err, _ERRLEN)
    if got < 0:
        raise NativeDecodeError(err.value.decode())
    return out, int(got)


def gif_lzw(data: bytes, min_code_size: int, frame: np.ndarray, interlace: bool,
            end_skip: int = 0) -> int:
    """GIF LZW of one frame's joined sub-blocks into ``frame`` (uint8
    [h, w], pre-filled with the background; rows in interlaced order if
    asked), going on past an end code read from the first ``end_skip``
    bytes; returns the pixels written."""
    err = ctypes.create_string_buffer(_ERRLEN)
    h, w = frame.shape
    got = _lib().citlab_gif_lzw(data, len(data), min_code_size, w, h, int(interlace),
                                end_skip, frame.ctypes.data, err, _ERRLEN)
    if got < 0:
        raise NativeDecodeError(err.value.decode())
    return int(got)


# JpegImagePlugin.MARKER: the markers PIL's open knows, and which of them
# it reads a segment of (Skip, APP, COM, SOF, DQT)
_JPEG_SEGMENTS = {0xFFC4, 0xFFCC, 0xFFDA, 0xFFDC, 0xFFDD, 0xFFDE, 0xFFDF, 0xFFFE, 0xFFDB,
                  *range(0xFFE0, 0xFFF0), *(m for m in range(0xFFC0, 0xFFD0)
                                            if m not in (0xFFC4, 0xFFC8, 0xFFCC))}
_JPEG_MARKERS = {*range(0xFFC0, 0xFFFF)} - {0xFFFF}


def _i16(s: bytes, at: int = 0) -> int:
    if len(s) < at + 2:
        raise NativeDecodeError("JPEG: a segment PIL's open cannot read (struct.error)")
    return (s[at] << 8) | s[at + 1]


def _i32(s: bytes, at: int) -> int:
    if len(s) < at + 4:
        raise struct.error
    return struct.unpack_from(">I", s, at)[0]


def _index(s: bytes, at: int) -> int:
    if at >= len(s):
        raise NativeDecodeError("JPEG: a segment PIL's open cannot read (IndexError)")
    return s[at]


def pil_jpeg_open(data: bytes) -> Tuple[int, int]:
    """JpegImagePlugin's open: its own reading of the markers before the
    first SOS (the handlers' parsing of APPn, SOF and DQT included); the
    size of the last SOF, or NativeDecodeError where PIL's open raises."""
    if data[:3] != b"\xff\xd8\xff":
        raise NativeDecodeError("JPEG: not a JPEG file (PIL: no FF D8 FF)")
    pos, cur, size, icc = 3, b"\xff", None, []

    def read(k):
        nonlocal pos
        out = data[pos:pos + k]
        pos += len(out)
        return out

    def segment():
        n = _i16(read(2)) - 2
        if n <= 0:
            return b""
        s = read(n)
        if len(s) < n:
            raise NativeDecodeError("JPEG: truncated marker segment (PIL: Truncated File Read)")
        return s

    while True:
        if not cur:
            raise NativeDecodeError("JPEG: no scan before the end of the file (PIL refuses it)")
        if cur[0] != 0xFF:
            cur = read(1)
            continue
        marker = _i16(cur + read(1))
        if marker in _JPEG_MARKERS:
            if marker in _JPEG_SEGMENTS:
                s = segment()
                if marker == 0xFFE0 and s[:4] == b"JFIF":
                    _i16(s, 5)
                elif marker == 0xFFE2 and s[:12] == b"ICC_PROFILE\0":
                    icc.append(s)
                elif marker == 0xFFED and s[:14] == b"Photoshop 3.0\x00":
                    at = 14
                    try:        # the image resource blocks, to the first short one
                        while s[at:at + 4] == b"8BIM":
                            at += 4
                            if len(s) < at + 2:
                                raise struct.error
                            code = (s[at] << 8) | s[at + 1]
                            at += 2
                            at += 1 + _index(s, at)
                            at += at & 1
                            length = _i32(s, at)
                            at += 4
                            if code == 0x03ED and len(s[at:at + length]) < 14:
                                raise struct.error
                            at += length
                            at += at & 1
                    except struct.error:
                        pass
                elif marker == 0xFFEE and s[:5] == b"Adobe":
                    _i16(s, 5)
                elif 0xFFC0 <= marker <= 0xFFCF and marker not in (0xFFC4, 0xFFC8, 0xFFCC):
                    size = (_i16(s, 3), _i16(s, 1))
                    if _index(s, 0) != 8:
                        raise NativeDecodeError(f"JPEG: {s[0]}-bit layers (PIL cannot handle "
                                                "them)")
                    if _index(s, 5) not in (1, 3, 4):
                        raise NativeDecodeError(f"JPEG: {s[5]}-layer image (PIL cannot handle "
                                                "it)")
                    if icc:
                        icc.sort()
                        _index(icc[0], 13)
                        icc = []
                    for at in range(6, len(s), 3):
                        _index(s, at + 2)
                elif marker == 0xFFDB:
                    while s:
                        qt_length = 1 + (1 if s[0] // 16 == 0 else 2) * 64
                        if len(s) < qt_length:
                            raise NativeDecodeError("JPEG: bad quantization table marker "
                                                    "(PIL refuses it)")
                        s = s[qt_length:]
            if marker == 0xFFDA:
                break
            cur = read(1)
        elif marker == 0xFFFF:
            cur = b"\xff"
        elif marker == 0xFF00:
            cur = read(1)
        else:
            raise NativeDecodeError(f"JPEG: no marker found at 0x{marker:04X} (PIL refuses it)")
    if size is None or size[0] <= 0 or size[1] <= 0:
        raise NativeDecodeError("JPEG: no frame of a size before the scan (PIL refuses it)")
    return size


def info(data: bytes) -> Tuple[int, int, int]:
    """(width, height, channels of the decoded samples) from the headers
    alone (a JPEG's size as PIL's open reads it); a TIFF or JPEG that PIL
    does not open raises."""
    m = _info(data)
    if m[3] == 2:
        _pil_tiff_mode(m)
        return int(m[0]), int(m[1]), int(m[2])
    return (*pil_jpeg_open(data), int(m[2]))


def decode(data: bytes) -> np.ndarray:
    """PIL's image: uint8 [H, W] grey ("1" as 0/255), [H, W, 2] grey +
    alpha, [H, W, 3] RGB (palette, YCbCr and CMYK converted) or
    [H, W, 4] RGBA; uint16 [H, W] for PIL's "I;16", int32 [H, W] for "I",
    float32 [H, W] for "F"."""
    m = _info(data)
    if m[3] == 2:
        if _pil_tiff_mode(m)[0] == "LAB":
            raise NativeDecodeError(
                "TIFF: a CIELAB image, which PIL converts to RGB only through LittleCMS "
                "(ImageCms: its LAB D50 profile to sRGB) and not to L at all; the port does "
                "not carry LittleCMS's transform (decided divergence)")
    else:
        pil_jpeg_open(data)
    w, h, ch, sb = int(m[0]), int(m[1]), int(m[2]), int(m[4])
    if m[3] == 2 and m[22] == 1:
        return _tiff_as_pil(_libtiff_rows_as_pil(data, m), m)
    out = np.empty((h, w, ch), {1: np.uint8, 2: np.uint16, 4: np.uint32}[sb])
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_image_decode(data, len(data), out.ctypes.data, out.nbytes, _inflate,
                                  err, _ERRLEN):
        raise NativeDecodeError(err.value.decode())
    if m[3] == 2:
        return _tiff_as_pil(out, m)
    if ch == 4:     # CMYK as stored, which PIL reads inverted (rawmode "CMYK;I")
        return cmyk_to_rgb(~out)
    return out[..., 0] if ch == 1 else out
