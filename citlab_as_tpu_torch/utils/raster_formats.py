"""The lossless raster formats of PIL's registry, and PIL's identification
of every file, as PIL 12.1 reads them: equal bit for bit to
``Image.open(path).convert(mode)``.

Identification (:func:`identify`) walks PIL's plugin order: the formats
``Image.open`` registers first (``Image.preinit``: BMP, DIB, GIF, JPEG,
PPM, PNG), then the rest of ``Image.ID`` as ``Image.init`` registers it.
A plugin whose accept test passes opens the file; where its ``_open``
fails in a way ``Image.open`` catches (``SyntaxError``, ``IndexError``,
``TypeError``, ``KeyError``, ``EOFError``, ``struct.error``, or an empty
mode or size), the next plugin is tried, and any other failure refuses
the file. The openers below follow PIL's own reading of each header, so
they fail where PIL fails. Formats the port decodes elsewhere (BMP, GIF,
JPEG, PNM, PNG, TIFF, WebP, JPEG 2000) are named here and decoded by their
own modules; DDS, BLP and FTEX (``utils/textures.py``) and ICNS, PCD,
FITS, FLI and IPTC (``utils/registry_formats.py``) are opened and decoded
by theirs.

Decoded here: PCX (1-bit, 2- and 4-plane bit planes, 8-bit grey or palette,
planar RGB), DCX (its first page), PSD (the composite image: bitmap, grey,
duotone, palette, RGB(A), CMYK, multichannel; raw or PackBits), TGA (every
``MODES`` entry, raw or RLE, all four orientations, 16- and 24-bit colour
maps), ICO (the entry PIL picks: PNG, or BMP with its AND mask), CUR, DIB,
SGI (1 or 2 bytes per channel, raw or RLE), SUN (1- to 32-bit, raw or RLE,
colour maps), QOI, MSP (versions 1 and 2), IM (every header type of its
``OPEN`` table, ``Lut`` palettes), XBM, XPM, PIXAR, SPIDER, GBR, IMT,
MCIDAS and XVTHUMB. The run-length and bit stream loops are host C++
(``csrc/raster_decode.cpp``, built with g++ at first use); headers and
unpacking are numpy. ``decode`` returns PIL's image in the forms
``utils/io.py`` converts from: uint8 [H, W] ("1" as 0/255, "L"),
[H, W, C] (LA, RGB, RGBA; palettes, CMYK and YCbCr already RGB), uint16
[H, W] ("I;16"), int32 [H, W] ("I") or float32 [H, W] ("F").
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
import struct
from types import SimpleNamespace

import numpy as np

from citlab_as_tpu_torch.utils import bmp_gif, jpeg2000, webp
from citlab_as_tpu_torch.utils.image_native import NativeDecodeError, cmyk_to_rgb

# the exceptions after which Image.open tries the next plugin
_CAUGHT = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)


class Refused(NativeDecodeError):
    """PIL identifies the file and then refuses it."""


def _refuse(fmt: str, why: str):
    raise Refused(f"{fmt}: {why}")


# ------------------------------------------------------------------ reading

class _File:
    """A file object over bytes, as PIL's plugins read one: short reads at
    the end, a position that may pass the end, no negative seeks."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = max(0, len(self.data) - self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        return self.read(max(0, end - self.pos))

    def seek(self, pos: int, whence: int = 0) -> None:
        pos = pos + (0, self.pos, len(self.data))[whence]
        if pos < 0:
            raise Refused("a seek before the start of the file (PIL: invalid argument)")
        self.pos = pos

    def tell(self) -> int:
        return self.pos


def _u16le(b, at=0):
    return struct.unpack_from("<H", b, at)[0]


def _u32le(b, at=0):
    return struct.unpack_from("<I", b, at)[0]


def _u16be(b, at=0):
    return struct.unpack_from(">H", b, at)[0]


def _u32be(b, at=0):
    return struct.unpack_from(">I", b, at)[0]


# ------------------------------------------------------------------ native loops

@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("raster_decode")
    i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    sigs = {
        "citlab_pcx_decode": [ctypes.c_char_p, i64, i64, i32, i32, i32, i32, p],
        "citlab_packbits_decode": [ctypes.c_char_p, i64, i64, i32, i32, p],
        "citlab_tga_rle_decode": [ctypes.c_char_p, i64, i64, i32, i32, i32, p],
        "citlab_sun_rle_decode": [ctypes.c_char_p, i64, i64, i32, i32, p],
        "citlab_sgi_rle_decode": [ctypes.c_char_p, i64, i32, i32, i32, i32, p],
        "citlab_msp_decode": [ctypes.c_char_p, i64, i32, i32, p, i64],
        "citlab_qoi_decode": [ctypes.c_char_p, i64, i64, i64, i32, p],
        "citlab_bit_decode": [ctypes.c_char_p, i64, i64, i32, i32, i32, p],
        "citlab_fli_decode": [ctypes.c_char_p, i64, i64, i64, i32, i32, p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i64
    return lib


_STATUS = {-1: "truncated (the data ends before the image is full)",
           -2: "a run passes the end of a line (PIL: buffer overrun)",
           -3: "corrupt run-length data"}


def _native(fmt: str, fn: str, *args) -> int:
    got = getattr(_lib(), fn)(*args)
    if got < 0:
        _refuse(fmt, _STATUS.get(got, f"native decoder status {got}"))
    return got


# ------------------------------------------------------------------ unpacking

# bits per pixel of each rawmode (Unpack.c)
_BITS = {"1": 1, "1;I": 1, "1;R": 1, "P;1": 1, "P;2": 2, "P;4": 4, "L;4": 4, "L": 8, "P": 8,
         "R": 8, "G": 8, "B": 8, "A": 8, "C;I": 8, "M;I": 8, "Y;I": 8, "K;I": 8,
         "LA": 16, "BGRA;15Z": 16, "L;16B": 16, "I;16": 16, "I;16L": 16, "I;16B": 16,
         "F;8": 8, "F;8S": 8, "F;16": 16, "F;16S": 16, "RGB": 24, "BGR": 24, "RGB;16B": 48,
         "RGBA;16B": 64, "RGBX": 32, "BGRX": 32, "BGRA": 32, "RGBA": 32, "I;32": 32,
         "I;32S": 32, "I;32B": 32, "F;32": 32, "F;32S": 32, "F;32F": 32, "F;32BF": 32,
         "RGB;L": 24, "RGBX;L": 32, "RGBA;L": 32, "CMYK;L": 32, "YCbCr;L": 24, "LA;L": 16,
         "PA;L": 16, "P;2L": 2, "P;4L": 4}
# the (image mode, rawmode) pairs PIL has an unpacker for, of those used here
_UNPACKERS = {
    "1": {"1", "1;I", "1;R"}, "L": {"L", "L;4", "L;16B"},
    "P": {"P", "P;1", "P;2", "P;4", "P;2L", "P;4L"}, "LA": {"LA", "LA;L"}, "PA": {"PA;L"},
    "RGB": {"RGB", "BGR", "RGBX", "BGRX", "RGB;L", "RGBX;L", "RGB;16B", "R", "G", "B"},
    "RGBA": {"RGBA", "BGRA", "BGRA;15Z", "RGBA;L", "RGBA;16B", "R", "G", "B", "A"},
    "CMYK": {"CMYK;L", "C;I", "M;I", "Y;I", "K;I"}, "YCbCr": {"YCbCr;L"},
    "I": {"I;32", "I;32S", "I;32B"}, "I;16": {"I;16"}, "I;16L": {"I;16L"},
    "I;16B": {"I;16B"},
    "F": {"F;8", "F;8S", "F;16", "F;16S", "F;32", "F;32S", "F;32F", "F;32BF"},
    "LAB": {"L", "A", "B"}}


def _check_rawmode(fmt, mode, rawmode):
    if rawmode not in _UNPACKERS.get(mode, ()):
        _refuse(fmt, f"PIL has no unpacker of {rawmode!r} samples into a {mode!r} image")


def _bits_msb(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    px = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(rows.shape[0], w, bits)
    return px @ (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)


def _planes(rows: np.ndarray, w: int, n: int) -> np.ndarray:
    """Line-interleaved planes (";L"): each line holds w samples of every band."""
    return np.stack([rows[:, k * w:(k + 1) * w] for k in range(n)], axis=-1)


def _unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """Rows of PIL's raw bytes [h, >= bytes per line] -> samples of the
    rawmode's image mode (one band for a band rawmode)."""
    h = rows.shape[0]
    if rawmode in ("1", "1;I", "1;R"):
        bits = np.unpackbits(rows, axis=1, bitorder="little" if rawmode == "1;R" else "big")
        bits = bits[:, :w]
        return (bits ^ 1 if rawmode == "1;I" else bits) * np.uint8(255)
    if rawmode in ("P;1", "P;2", "P;4", "L;4"):
        px = _bits_msb(rows, w, _BITS[rawmode])
        return px * np.uint8(17) if rawmode == "L;4" else px
    if rawmode in ("P;2L", "P;4L"):
        s = (w + 7) // 8
        out = np.zeros((h, w), np.uint8)
        for k in range(int(rawmode[2])):
            out |= np.unpackbits(rows[:, k * s:(k + 1) * s], axis=1)[:, :w] << k
        return out
    if rawmode in ("L", "P", "R", "G", "B", "A", "F;8"):
        px = rows[:, :w]
        return px.astype(np.float32) if rawmode == "F;8" else px
    if rawmode in ("C;I", "M;I", "Y;I", "K;I"):
        return 255 - rows[:, :w]
    if rawmode == "F;8S":
        return rows[:, :w].view(np.int8).astype(np.float32)
    if rawmode in ("L;16B", "RGB;16B", "RGBA;16B"):
        n = {"L;16B": 1, "RGB;16B": 3, "RGBA;16B": 4}[rawmode]
        px = rows[:, :2 * n * w:2].reshape(h, w, n)
        return px[..., 0] if n == 1 else px
    if rawmode == "BGRA;15Z":
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint32)
        v = v[..., 0] | v[..., 1] << 8
        return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                         (v & 31) * 255 // 31, np.where(v >> 15, 0, 255)],
                        -1).astype(np.uint8)
    if rawmode.endswith(";L"):
        return _planes(rows, w, _BITS[rawmode] // 8)
    dtypes = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4", "I;32S": "<i4",
              "I;32B": ">i4", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32S": "<i4",
              "F;32F": "<f4", "F;32BF": ">f4"}
    if rawmode in dtypes:
        dt = np.dtype(dtypes[rawmode])
        v = np.ascontiguousarray(rows[:, :w * dt.itemsize]).view(dt).reshape(h, w)
        if rawmode.startswith("F"):
            return v.astype(np.float32)
        return v.astype(np.uint16 if rawmode.startswith("I;16") else np.int32)
    order = {"RGB": [0, 1, 2], "BGR": [2, 1, 0], "RGBX": [0, 1, 2], "BGRX": [2, 1, 0],
             "BGRA": [2, 1, 0, 3], "RGBA": [0, 1, 2, 3], "LA": [0, 1]}[rawmode]
    n = _BITS[rawmode] // 8
    return np.ascontiguousarray(rows[:, :n * w].reshape(h, w, n)[..., order])


def _raw(fmt: str, data: bytes, offset: int, w: int, h: int, rawmode: str, stride: int = 0,
         ystep: int = 1) -> np.ndarray:
    """RawDecode.c: lines of ``stride`` bytes (0: just the samples) from
    ``offset``, the last one needing only its samples; bottom-up for a
    negative ``ystep``."""
    if offset < 0:
        _refuse(fmt, "the samples start before the file (PIL: invalid argument)")
    bpl = (w * _BITS[rawmode] + 7) // 8
    stride = stride or bpl
    if stride < bpl:
        _refuse(fmt, f"lines of {stride} bytes hold less than their {bpl} bytes of samples "
                "(PIL's raw decoder refuses them)")
    need = stride * (h - 1) + bpl
    if len(data) - offset < need:
        _refuse(fmt, "truncated (the samples run past the end of the file)")
    rows = np.frombuffer(data, np.uint8, need, offset)
    rows = np.pad(rows, (0, stride * h - need)).reshape(h, stride)[:, :bpl]
    if ystep < 0:
        rows = rows[::-1]
    return _unpack(rows, rawmode, w)


def _mapped(fmt: str, data: bytes, offset: int, w: int, h: int, rawmode: str,
            stride: int) -> np.ndarray:
    """Image.core.map_buffer, PIL's memory map of a file for one raw tile of
    its own mode: lines every ``stride`` bytes (0 or less: the samples'
    bytes), which may overlap; the whole of the lines must lie in the file,
    and bytes past its end read as the zeros of the map's last page."""
    bpl = (w * _BITS[rawmode] + 7) // 8
    stride = stride if stride > 0 else bpl
    if offset + h * stride > len(data):
        _refuse(fmt, "truncated (PIL: buffer is not large enough)")
    buf = np.frombuffer(data + bytes(bpl), np.uint8)
    at = offset + stride * np.arange(h)[:, None] + np.arange(bpl)[None, :]
    return _unpack(buf[at], rawmode, w)


# ------------------------------------------------------------------ palettes and modes

def _palette(rawmode: str, data: bytes) -> np.ndarray:
    """ImagePalette.raw(rawmode, data) as the image's palette: its RGB entries
    (at most 256; past the file's entries PIL's palette is black)."""
    if rawmode == "BGRA":
        raise Refused("a 32-bit colour map (PIL: unrecognized raw mode)")
    bits = {"RGB": 24, "BGR": 24, "RGB;L": 24, "BGRX": 32, "BGRA;15Z": 16}[rawmode]
    n = len(data) * 8 // bits
    if n > 256:
        raise Refused(f"a palette of {n} colours (PIL: invalid palette size)")
    raw = np.frombuffer(data, np.uint8, n * bits // 8).reshape(1, -1)
    rgb = _planes(raw, n, 3)[0] if rawmode == "RGB;L" else _unpack(raw, rawmode, n)[0][:, :3]
    full = np.zeros((256, 3), np.uint8)
    full[:n] = rgb[:n]
    return full


# YCbCr -> RGB (ConvertYCbCr.c): r = y + (R_Cr[cr] >> 6), b = y + (B_Cb[cb] >> 6)
# and g = y + ((G_Cb[cb] + G_Cr[cr]) >> 6), clipped. The rows below are
# the R and B offsets after the shift and G_Cb, G_Cr entries that give
# PIL's green for every (Cb, Cr) pair (int16, zlib, base64).
_YCC = (
    "eNo11Ilf1HUex/H3b2Z+M/MbYDiGw43NbTdvzUxXXTMUV7GllA5IUnK38lYiihAvVDRcUUOLVjKydvPIA13SzPvA"
    "jYrctCRDl3bb1iOB4WaO3/xmfu/9zjzgX/i8nu/PNE7nE3ySTzOdGZzBTM7kLGZxNv/I5/kCX+RczuMCLuRiLmE2"
    "c/gyX+GrzGM+l3IZl3MFV7GQa7iWRVzP17mBf+ZGbuJmvsFSbuWbfItv8y/czne4gxV8jzv5Af/KD7mLu7mXH3E/"
    "D/AgD/Ewq/gxj/ATHuNxnuBJnuYZnuN5XuBF/oM1/JxfsJZf8Z/8mpf5Db9lHb/jNdbzOv/FBv7A//BH/sT/8SZv"
    "8w7vspFNdLKFbWxnJ7vYTTc9VOmjxgB1AhIMMEGGBVYoCEM47IhEFGLgQBzikYBf4B78EveiL+7Dr3E/+qE/BmIQ"
    "hmAohmE4HsRDGIlRGI0x+B3G4WE8giRMRDImYTKmYCoexR/wGB7HdKThCTyFp5GBZzADz2ImsvAcZuNPeB4vYg7m"
    "Yj4WYBEWYwleQg5y8QpexWvIRwGWYTlWYhVWYw3WYh3WoxgbsBEl2IQteANbsQ1vogxvYzvK8Q7eRQV24n18gL/h"
    "Q+zGHuzFPuzHQVTiEP6OKhzBvezL+/gb9uMADuRgDuUDHM4RHMnfcgzHchzHM4kTmMzfcwpT+ChT+bgwkxYyk8Fn"
    "QmKy+FzIS6+WRT1WcoWU14SUAuFkpXCyWihZJ5QUCyMlQsgWIWSb8FEmfJT36Hi/x8aeHhmVIRdHeDSk4iRPhUz0"
    "iuj10KshaOGGsBCU8F8hIejgZ+EgqKBVGOgQBlxCgFcI8Pf0N/bUt/W0jw6VT0CfUPe++FWoen8MCDXvLd7bO1h7"
    "gqgdbJ0iWgdLTxOlg53TeyrP6mn8gig8TxReKPpmi74vi7p5ou5S0XaFKFsoyhaJrq+Hum7C5lDV3qa9RYM9d4me"
    "wZoHRM1gy49Fy0/wKU7gFE7jLM6jGhfxGT7Hl/gKl/A1ruBbXMV3+B7XcQMN+Dd+xE+Qwq7Zam3VtjJbiW22Ld2W"
    "aku0OWwWW4NyValRKpRtSrEyS0lTUpQ+il0xKfXWy9aL1nLrZmuRdYY11TrJGmtVrLDWWWot71nKLBstWZZ0y1RL"
    "oiXaIlsazFfMNeYd5lJzsTnTnGaebE4wR5glc718Sa6Wt8slcpGcIafKybJDVuQGU53pC1OF6S1TsSnL9KQpxXSP"
    "yW6STdeNl42fGcuNpcZ1xkzjNOMkY4LRZpSM1wy1hmpDmaHEMNuQbkg1JBocBouhQboq1UgV0lapWJoppUkpUoJk"
    "l4xSvbhBtdjFZnHhGUgVvWLF3oE6IWinEFgiFKcL34mMocwG/Ru9Rn9XL9WL9Wf1NH2KnqBH6JJeH7gUqA5sD5QE"
    "igIZgdRAcsARUAI/+Ov8X/or/GX+Df4s/1P+FH+iP9Iv+29ol7UarVwr1dZrmdp0bZKWoIVpkva9r9ZX7Svzlfhm"
    "+9J9qb5En8Nn8TWoV9UatULdphars9Q0NUXto9pVk1rvvey96C33bvEWeTO9j3kneeO8ilfy1nlqPTs9ZZ4ST5Yn"
    "3TPVk+iJ9sieBvcVd417h7vUXezOdKe5J7sT3BFuyV3vuuSqdm13lbiKXBmuVFeyy+FSXC3xx+PXxC+KHxmvxd2O"
    "OxRXEDcxbnBcZ+zp2D2xL8WOjaWj0XHUsdIxz/GAwxNzPmZ/TF7M+Jj+MS3Rx6PXRC+KHhWtRd2OOhxVEDUxanBU"
    "V+TpyD2ROZFjI2lvsh+1r7TPsw+3eyLORxyIyIsYH9E/ojX8ePia8MXho8K1sDthh8MKwiaGDQnrsp227bXl2Mba"
    "qDQpR5WVynxluOKxXrAesOZZx1sHWFstxy1rLYstoyya+Y75sLnAnGweYu6Sz8h75Rx5rAy5yXTUtMo03zTc5DVe"
    "MB4w5hkfMQ4wthpOGNYaFhtGGfzSHemwtExKloZI3Tgj1pMj1gs0i79SKH7Wg1T1m/pBPV9P0gfq7YGTgV2BJYHR"
    "gYD/Z3+Vf7l/jn+o36Wd1T7ScrVx2v2a03fMV+hb4BvhU9WbaqWaryapg9R270nvLm+2d7Q34LnrqfIs98zxDPO4"
    "3Gfd+9y57nHufm6n65ir0LXQNcKldt/qruzO707qHtTd3nWya3dXdtfoLr3zbmdV5/LOuZ3DOl0d5zr2deR2jOvo"
    "1+FsP9a+un1h+4h2X9uttsq2/LYJbYPa2ltPte5uzW4d06q33G2palnRMrdlWIvbec65z5nrfNjZz+ls/rR5dfPC"
    "5oeafU23miqbljZNaBrU1NF4qnF3Y3bj/wHA7vds"
)


@functools.cache
def _ycc_tables():
    import base64
    import zlib
    raw = zlib.decompress(base64.b64decode("".join(_YCC)))
    return np.frombuffer(raw, "<i2").reshape(4, 256).astype(np.int32)


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    r_cr, b_cb, g_cb, g_cr = _ycc_tables()
    y, cb, cr = (ycc[..., k].astype(np.int32) for k in range(3))
    rgb = np.stack([y + r_cr[cr], y + ((g_cb[cb] + g_cr[cr]) >> 6), y + b_cb[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _finish(fmt: str, px: np.ndarray, mode: str, palette, want: str) -> np.ndarray:
    """PIL's image of ``mode`` (samples as unpacked) -> the forms io.py
    converts to ``want``."""
    if mode in ("P", "PA"):
        index = px if mode == "P" else px[..., 0]
        if palette is None:
            return np.zeros(index.shape + (3,), np.uint8)
        return palette[index]
    if mode == "CMYK":
        return cmyk_to_rgb(px)
    if mode == "YCbCr":
        return np.ascontiguousarray(px[..., 0]) if want == "L" else _ycbcr_to_rgb(px)
    if mode == "LAB":
        _refuse(fmt, f"PIL cannot convert LAB to {want} (conversion not supported)")
    return px


# ------------------------------------------------------------------ openers

def _im(fmt: str, mode: str, size, decode) -> SimpleNamespace:
    """An opened file: PIL's mode and size, and ``decode(data, want)``."""
    return SimpleNamespace(format=fmt, mode=mode, size=size, decode=decode)


# PCX / DCX

def _pcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def _open_pcx(f: _File, fmt: str = "PCX"):
    s = f.read(68)
    if not _pcx_accept(s):
        raise SyntaxError
    x0, y0, x1, y1 = _u16le(s, 4), _u16le(s, 6), _u16le(s, 8) + 1, _u16le(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise SyntaxError
    offset = f.tell() + 60
    version, bits, planes, provided = s[1], s[3], s[65], _u16le(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = _palette("RGB", s[16:64])
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        f.seek(-769, 2)
        t = f.read(769)
        if len(t) == 769 and t[0] == 12:
            ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
            if t[1:] != ramp:
                mode = rawmode = "P"
                palette = _palette("RGB", t[1:])
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        _refuse(fmt, f"{bits}-bit samples in {planes} planes (PIL: unknown PCX mode)")
    w, h = x1 - x0, y1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    line = planes * stride

    def decode(data, want):
        if (w * _BITS[rawmode] + 7) // 8 > line:
            _refuse(fmt, "lines shorter than their samples (PIL: buffer overrun)")
        rows = np.empty((h, line), np.uint8)
        _native(fmt, "citlab_pcx_decode", data, len(data), offset, w, h, line,
                _BITS[rawmode], rows.ctypes.data)
        return _finish(fmt, _unpack(rows, rawmode, w), mode, palette, want)
    return _im(fmt, mode, (w, h), decode)


def _open_dcx(f: _File):
    if _u32le(f.read(4)) != 0x3ADE68B1:
        raise SyntaxError
    offsets = []
    for _ in range(1024):
        offset = _u32le(f.read(4))
        if not offset:
            break
        offsets.append(offset)
    f.seek(offsets[0])
    return _open_pcx(f, "DCX")


# PSD

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}


def _open_psd(f: _File):
    s = f.read(26)
    if not s.startswith(b"8BPS") or _u16be(s, 4) != 1:
        raise SyntaxError
    bits, channels_in_file, psd_mode = _u16be(s, 22), _u16be(s, 12), _u16be(s, 24)
    if (psd_mode, bits) not in _PSD_MODES:
        raise KeyError((psd_mode, bits))      # PIL's MODES lookup: it cannot identify the file
    mode, channels = _PSD_MODES[(psd_mode, bits)]
    if channels > channels_in_file:
        _refuse("PSD", "not enough channels")
    if mode == "RGB" and channels_in_file == 4:
        mode, channels = "RGBA", 4
    w, h = _u32be(s, 18), _u32be(s, 14)
    palette = None
    size = _u32be(f.read(4))                  # colour mode data
    if size:
        data = f.read(size)
        if mode == "P" and size == 768:
            palette = _palette("RGB;L", data)
    size = _u32be(f.read(4))                  # image resources
    if size:
        end = f.tell() + size
        while f.tell() < end:
            f.read(4)
            _u16be(f.read(2))
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            data = f.read(_u32be(f.read(4)))
            if len(data) & 1:
                f.read(1)
    size = _u32be(f.read(4))                  # layer and mask information
    if size:
        end = f.tell() + size
        _u32be(f.read(4))
        f.seek(end)
    compression = _u16be(f.read(2))
    offset = f.tell()
    layers = [m + (";I" if mode == "CMYK" else "") for m in mode[:channels]]
    tiles = []
    if compression == 0:
        for layer in layers:
            tiles.append((offset, layer))
            offset += w * h
    elif compression == 1:
        counts = f.read(channels * h * 2)
        offset = f.tell()
        i = 0
        for layer in layers:
            tiles.append((offset, layer))
            for _ in range(h):
                offset += _u16be(counts, i)
                i += 2

    def decode(data, want):
        if not tiles:
            _refuse("PSD", f"compression {compression} (PIL: cannot load this image)")
        bands = []
        for start, layer in tiles:
            if compression == 0:
                bands.append(_raw("PSD", data, start, w, h, layer))
                continue
            bpl = (w * _BITS[layer] + 7) // 8
            rows = np.empty((h, bpl), np.uint8)
            _native("PSD", "citlab_packbits_decode", data, len(data), start, bpl, h,
                    rows.ctypes.data)
            bands.append(_unpack(rows, layer, w))
        px = bands[0] if len(bands) == 1 else np.stack(bands, -1)
        return _finish("PSD", px, mode, palette, want)
    return _im("PSD", mode, (w, h), decode)


# TGA

_TGA_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
              (2, 24): "BGR", (2, 32): "BGRA"}


def _open_tga(f: _File):
    s = f.read(18)
    id_len, colormaptype, imagetype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    w, h = _u16le(s, 12), _u16le(s, 14)
    if colormaptype not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise SyntaxError
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if colormaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError
    orientation = flags & 0x30
    flip = orientation in (0x10, 0x30)
    ystep = 1 if orientation in (0x20, 0x30) else -1
    if id_len:
        f.read(id_len)
    palette = None
    if colormaptype:
        start, size, mapdepth = _u16le(s, 3), _u16le(s, 5), s[7]
        entry = {16: ("BGRA;15Z", 2), 24: ("BGR", 3), 32: ("BGRA", 4)}.get(mapdepth)
        if entry is None:
            raise SyntaxError(f"TGA: unknown colour map depth {mapdepth}")
        palette = (entry[0], bytes(entry[1] * start) + f.read(entry[1] * size))
    rawmode = _TGA_MODES.get((imagetype & 7, depth))
    rle = bool(imagetype & 8)
    offset = f.tell()

    def decode(data, want):
        if rawmode is None:
            _refuse("TGA", f"{depth}-bit samples of image type {imagetype} "
                    "(PIL: cannot load this image)")
        _check_rawmode("TGA", mode, rawmode)
        pal = _palette(*palette) if palette is not None else None
        if pal is not None and mode not in ("P", "L", "LA"):
            _refuse("TGA", f"a colour map on a {mode} image (PIL: unrecognized image mode)")
        if rle:
            bpl = (w * _BITS[rawmode] + 7) // 8
            rows = np.empty((h, bpl), np.uint8)
            _native("TGA", "citlab_tga_rle_decode", data, len(data), offset, bpl, h,
                    depth // 8, rows.ctypes.data)
            px = _unpack(rows[::-1] if ystep < 0 else rows, rawmode, w)
        else:
            px = _raw("TGA", data, offset, w, h, rawmode, 0, ystep)
        if flip:
            px = px[:, ::-1]
        if pal is not None and mode in ("L", "LA"):
            # PIL puts the colour map on the grey image, whose pixels become
            # indices: every conversion goes through the map, but "L" of an
            # "L" image is a copy of the indices
            if mode == "L" and want == "L":
                return np.ascontiguousarray(px)
            return pal[px if mode == "L" else px[..., 0]]
        return _finish("TGA", np.ascontiguousarray(px), mode, pal, want)
    return _im("TGA", mode, (w, h), decode)


# DIB (BMP without a file header), CUR and ICO

_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _bitmap(f: _File, fmt: str, header: int = 0, offset: int = 0) -> dict:
    """BmpImageFile._bitmap: the info header at ``header`` (or where the
    file is), as bmp_gif's decoder reads it."""
    if header:
        f.seek(header)
    start = f.tell()
    hsize = _u32le(f.read(4))
    if hsize - 4 > len(f.data) - f.tell():
        _refuse(fmt, "truncated header (PIL: Truncated File Read)")
    if hsize not in _DIB_HEADERS:
        _refuse(fmt, f"header of {hsize} bytes (PIL: Unsupported BMP header type)")
    if hsize == 40 and f.data[start + 16:start + 20] == struct.pack("<I", 3) \
            and len(f.data) < start + 52:
        raise struct.error("truncated bitfields masks")
    try:
        h = bmp_gif._dib_header(f.data, start, offset, check_size=False)
    except NativeDecodeError as e:
        raise Refused(str(e).replace("BMP", fmt, 1)) from None
    return h


def _open_dib(f: _File):
    h = _bitmap(f, "DIB")
    return _im("DIB", h["mode"], (h["width"], h["height"]),
               lambda data, want: bmp_gif._decode_dib(data, h))


def _open_cur(f: _File):
    s = f.read(6)
    if not s.startswith(b"\0\0\2\0"):
        raise SyntaxError
    best = b""
    for _ in range(_u16le(s, 4)):
        s = f.read(16)
        if not best:
            best = s
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    if not best:
        raise TypeError("No cursors were found")
    h = _bitmap(f, "CUR", _u32le(best, 12))
    h["height"] //= 2
    return _im("CUR", h["mode"], (h["width"], h["height"]),
               lambda data, want: bmp_gif._decode_dib(data, h))


def _open_ico(f: _File):
    s = f.read(6)
    if not s.startswith(b"\0\0\1\0"):
        raise SyntaxError
    entries = []
    for _ in range(_u16le(s, 4)):
        s = f.read(16)
        width, height, nb_color, bpp = s[0] or 256, s[1] or 256, s[2], _u16le(s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append(dict(dim=(width, height), bpp=bpp, size=_u32le(s, 8),
                            offset=_u32le(s, 12), depth=depth, square=width * height))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    entry = entries[0]
    # IcoImageFile._open loads the image: its faults show at open
    arr, mode = _ico_frame(f, entry)
    return _im("ICO", mode, (arr.shape[1], arr.shape[0]), lambda data, want: arr)


def _ico_frame(f: _File, e: dict):
    from citlab_as_tpu_torch.utils import io as port_io
    data = f.data
    at = e["offset"]
    if data[at:at + 8] == b"\x89PNG\r\n\x1a\n":
        png = data[at:]
        w, hgt = struct.unpack_from(">II", png, 16)     # short: PIL's PNG open fails too
        if not w or not hgt or png[12:16] != b"IHDR" or port_io._png_broken(png):
            raise SyntaxError("PIL's PNG open rejects the entry")
        _bomb_check("ICO", (w, hgt))
        try:
            px = port_io._decode_png(png, "ICO")
        except Exception as err:        # noqa: BLE001 - every fault of the entry refuses
            raise Refused(f"ICO: its PNG image: {err}") from None
        return px, "PNG"
    f.seek(at)
    h = _bitmap(f, "ICO")
    if h["width"] <= 0 or h["height"] <= 0:
        raise SyntaxError
    _bomb_check("ICO", (h["width"], h["height"]))
    h = dict(h, height=int(h["height"] / 2))
    w, hgt = h["width"], h["height"]
    if e["bpp"] == 32:
        if len(data) - h["offset"] < w * hgt * 4:
            _refuse("ICO", "truncated alpha (PIL: buffer is not large enough)")
    else:
        padded = w + (32 - w % 32) % 32
        total = padded * hgt // 8
        mask_at = e["offset"] + e["size"] - total
        if mask_at < 0:
            _refuse("ICO", "the AND mask starts before the file (PIL: invalid argument)")
        if len(data[mask_at:mask_at + total]) < padded // 8 * (hgt - 1) + (w + 7) // 8:
            _refuse("ICO", "truncated AND mask (PIL: not enough image data)")
    return bmp_gif._decode_dib(data, h), h["mode"]


# SGI

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _open_sgi(f: _File):
    s = f.read(512)
    compression, bpc = s[2], s[3]
    dimension, w, h, z = _u16be(s, 4), _u16be(s, 6), _u16be(s, 8), _u16be(s, 10)
    rawmode = _SGI_MODES.get((bpc, dimension, z))
    if rawmode is None:
        _refuse("SGI", f"{bpc} bytes per channel, dimension {dimension}, {z} channels "
                "(PIL: Unsupported SGI image mode)")
    mode = rawmode.split(";")[0]
    bands = len(mode)

    def decode(data, want):
        if compression == 0 and bpc == 1:
            px = [_raw("SGI", data, 512 + k * w * h, w, h, band, 0, -1)
                  for k, band in enumerate(mode)]
        elif compression == 0:
            px = [_raw("SGI", data, 512 + 2 * k * w * h, w, h, "L;16B", 0, -1)
                  for k in range(bands)]
        elif compression == 1:
            rows = np.zeros((h, w * bands * bpc), np.uint8)
            _native("SGI", "citlab_sgi_rle_decode", data[512:], max(0, len(data) - 512), w, h,
                    bands, bpc, rows.ctypes.data)
            out = _unpack(rows[::-1], rawmode, w)
            return out
        else:
            _refuse("SGI", f"compression {compression} (PIL: cannot load this image)")
        return px[0] if bands == 1 else np.stack(px, -1)
    return _im("SGI", mode, (w, h), decode)


# SUN

def _open_sun(f: _File):
    s = f.read(32)
    if _u32be(s) != 0x59A66A95:
        raise SyntaxError
    w, h, depth = _u32be(s, 4), _u32be(s, 8), _u32be(s, 12)
    file_type, palette_type, palette_length = _u32be(s, 20), _u32be(s, 24), _u32be(s, 28)
    offset = 32
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth in (24, 32):
        mode = "RGB"
        rawmode = ("RGB" if file_type == 3 else "BGR") + ("X" if depth == 32 else "")
    else:
        raise SyntaxError
    palette = None
    if palette_length:
        if palette_length > 1024 or palette_type != 1:
            raise SyntaxError
        offset += palette_length
        palette = f.read(palette_length)
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    stride = ((w * depth + 15) // 16) * 2
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError

    def decode(data, want):
        pal = _palette("RGB;L", palette) if palette is not None else None
        if pal is not None and mode != "P":
            _refuse("SUN", f"a colour map on a {mode} image (PIL: unrecognized image mode)")
        if file_type == 2:
            bpl = (w * _BITS[rawmode] + 7) // 8
            rows = np.empty((h, bpl), np.uint8)
            _native("SUN", "citlab_sun_rle_decode", data, len(data), offset, bpl, h,
                    rows.ctypes.data)
            px = _unpack(rows, rawmode, w)
        else:
            px = _raw("SUN", data, offset, w, h, rawmode, stride)
        return _finish("SUN", px, mode, pal, want)
    return _im("SUN", mode, (w, h), decode)


# QOI

def _open_qoi(f: _File):
    if not f.read(4).startswith(b"qoif"):
        raise SyntaxError
    w, h = _u32be(f.read(4)), _u32be(f.read(4))
    channels = f.read(1)[0]
    mode = "RGB" if channels == 3 else "RGBA"
    f.seek(1, 1)
    offset = f.tell()

    def decode(data, want):
        n = 3 if mode == "RGB" else 4
        out = np.empty((h, w, n), np.uint8)
        _native("QOI", "citlab_qoi_decode", data, len(data), offset, w * h, n, out.ctypes.data)
        return out
    return _im("QOI", mode, (w, h), decode)


# MSP

def _open_msp(f: _File):
    s = f.read(32)
    if not s.startswith((b"DanM", b"LinS")):
        raise SyntaxError
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _u16le(s, i)
    if checksum:
        raise SyntaxError
    w, h = _u16le(s, 4), _u16le(s, 6)
    version1 = s.startswith(b"DanM")

    def decode(data, want):
        if version1:
            return _raw("MSP", data, 32, w, h, "1")
        bpl = (w + 7) // 8
        stream = np.empty(bpl * h, np.uint8)
        got = _lib().citlab_msp_decode(data, len(data), w, h, stream.ctypes.data, stream.size)
        if got < 0:
            _refuse("MSP", {-1: "truncated (a row runs past the end of the file)",
                            -3: "a run is cut short (PIL: corrupted MSP file)"}.get(
                got, _STATUS.get(got, "corrupt")))
        if got < stream.size:
            _refuse("MSP", "its rows hold fewer bytes than the image (PIL: not enough image "
                    "data)")
        return _unpack(stream.reshape(h, bpl), "1", w)
    return _im("MSP", "1", (w, h), decode)


# IM

_IM_OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
            "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
            "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
            "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
            "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
            "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
            "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
            "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
            "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _t in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_t} image"] = _IM_OPEN[f"L*{_t} image"] = ("F", f"F;{_t}")
for _t in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_t} image"] = _IM_OPEN[f"L*{_t} image"] = (f"I;{_t}", f"I;{_t}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _t in range(2, 33):
    _IM_OPEN[f"L*{_t} image"] = ("F", f"F;{_t}")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            _refuse("IM", f"header value {s!r} is not a number")


def _open_im(f: _File):
    if b"\n" not in f.read(100):
        raise SyntaxError
    f.seek(0)
    n = 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    s = b""
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s += f.readline()
        if len(s) > 100:
            raise SyntaxError
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_LINE.match(s)
        if not m:
            raise SyntaxError
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        raise SyntaxError
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise SyntaxError("IM: no 0x1A ends the header (PIL: File truncated)")
    palette = None
    if "Lut" in info:
        lut = f.read(768)
        grey = all(lut[i] == lut[i + 256] == lut[i + 512] for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = _palette("RGB;L", lut)
    offset = f.tell()

    def decode(data, want):
        if not (isinstance(size, tuple) and len(size) == 2
                and all(isinstance(v, int) for v in size)):
            _refuse("IM", f"image size {size} is not two whole numbers (PIL cannot load it)")
        w, h = size
        if mode not in _UNPACKERS and mode != "PA":
            _refuse("IM", f"image type {mode!r} (PIL cannot load it)")
        bits = int(rawmode[2:]) if re.fullmatch(r"F;\d+", rawmode) else 0
        if bits and bits not in (8, 16, 32):
            out = np.zeros((h, w), np.float32)
            _native("IM", "citlab_bit_decode", data, len(data), offset, bits, w, h,
                    out.ctypes.data)
            return out[::-1].copy()
        if rawmode in ("RGB;T", "RYB;T"):
            g, r, b = (_raw("IM", data, offset + k * w * h, w, h, band, 0, -1)
                       for k, band in enumerate("GRB"))
            return np.stack([r, g, b], -1)
        _check_rawmode("IM", mode, rawmode)
        px = _raw("IM", data, offset, w, h, rawmode, 0, -1)
        return _finish("IM", px, mode, palette, want)
    return _im("IM", mode, size, decode)


# XBM and XPM

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - 48
for _c in b"abcdef":
    _HEX[_c] = _HEX[_c - 32] = _c - 87


def _open_xbm(f: _File):
    m = _XBM_HEAD.match(f.read(512))
    if not m:
        raise SyntaxError
    w, h, offset = int(m.group("width")), int(m.group("height")), m.end()

    def decode(data, want):
        bpl = (w + 7) // 8
        need = bpl * h
        out = bytearray()
        pos = offset
        while len(out) < need:
            pos = data.find(b"x", pos)
            if pos < 0 or pos + 3 > len(data):
                _refuse("XBM", "truncated (the bytes end before the image is full)")
            out.append((int(_HEX[data[pos + 1]]) << 4) + int(_HEX[data[pos + 2]]))
            pos += 3
        return _unpack(np.frombuffer(bytes(out), np.uint8).reshape(h, bpl), "1;R", w)
    return _im("XBM", "1", (w, h), decode)


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _open_xpm(f: _File):
    if not f.read(9).startswith(b"/* XPM */"):
        raise SyntaxError
    while True:
        line = f.readline()
        if not line:
            raise SyntaxError
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, ncolours, bpp = (int(g) for g in m.groups())
    except ValueError:
        _refuse("XPM", "a header number is missing (PIL: invalid literal)")
    colours = {}
    for _ in range(ncolours):
        line = f.readline().rstrip()
        key = line[1:bpp + 1]
        words = line[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                rgb = words[i + 1]      # IndexError: PIL's open fails alike
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        _refuse("XPM", f"colour {rgb!r} (PIL: invalid literal)")
                    colours[key] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    _refuse("XPM", f"colour {rgb.decode('latin-1')!r} is not #rrggbb or None "
                            "(PIL: cannot read this XPM file)")
                break
        else:
            _refuse("XPM", "a colour line without a 'c' key (PIL: cannot read this XPM file)")
    mode = "RGB" if ncolours > 256 else "P"
    offset = f.tell()

    def decode(data, want):
        keys = list(colours)
        lookup = {k: i for i, k in reversed(list(enumerate(keys)))}
        n = w * h * (3 if mode == "RGB" else 1)
        out = bytearray()
        g = _File(data, offset)
        header = False
        while len(out) < n:
            line = g.readline()
            if not line:
                break
            if line.rstrip() == b"/* pixels */" and not header:
                header = True
                continue
            line = b'"'.join(line.split(b'"')[1:-1])
            for i in range(0, len(line), bpp):
                k = line[i:i + bpp]
                if k not in lookup:
                    _refuse("XPM", f"pixel {k!r} has no colour (PIL: not in the palette)")
                out += colours[k] if mode == "RGB" else bytes((lookup[k],))
        if len(out) < n:
            _refuse("XPM", "too few pixels (PIL: not enough image data)")
        px = np.frombuffer(bytes(out[:n]), np.uint8)
        if mode == "RGB":
            return px.reshape(h, w, 3)
        pal = _palette("RGB", b"".join(colours.values()))
        return pal[px.reshape(h, w)]
    return _im("XPM", mode, (w, h), decode)


# PIXAR, SPIDER, GBR, IMT, MCIDAS, XVTHUMB

def _open_pixar(f: _File):
    s = f.read(4)
    if not s.startswith(b"\x80\xe8\x00\x00"):
        raise SyntaxError
    s += f.read(508)
    w, h = _u16le(s, 418), _u16le(s, 416)
    mode = "RGB" if (_u16le(s, 424), _u16le(s, 426)) == (14, 2) else ""
    return _im("PIXAR", mode, (w, h),
               lambda data, want: _raw("PIXAR", data, 1024, w, h, "RGB"))


def _spider_header(t) -> int:
    h = (99,) + t

    def whole(v):
        try:
            return v - int(v) == 0
        except (ValueError, OverflowError):
            return False
    if not all(whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _open_spider(f: _File):
    s = f.read(108)
    if len(s) != 108:
        raise SyntaxError
    for big in (True, False):
        t = struct.unpack((">" if big else "<") + "27f", s)
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        raise SyntaxError
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        _refuse("SPIDER", "an image of a stack without its stack header (PIL: no attribute "
                "'stkoffset')")
    else:
        raise SyntaxError
    rawmode = "F;32BF" if big else "F;32F"
    return _im("SPIDER", "F", (w, ht),
               lambda data, want: _raw("SPIDER", data, offset, w, ht, rawmode))


def _open_gbr(f: _File):
    header_size = _u32be(f.read(4))
    if header_size < 20:
        raise SyntaxError
    version = _u32be(f.read(4))
    if version not in (1, 2):
        raise SyntaxError
    w, h, depth = _u32be(f.read(4)), _u32be(f.read(4)), _u32be(f.read(4))
    if w == 0 or h == 0 or depth not in (1, 4):
        raise SyntaxError
    if version == 1:
        comment = header_size - 20
    else:
        comment = header_size - 28
        if f.read(4) != b"GIMP":
            raise SyntaxError
        _u32be(f.read(4))
    f.read(comment)
    offset = f.tell()
    mode = "L" if depth == 1 else "RGBA"

    def decode(data, want):
        if len(data) - offset < w * h * depth:
            _refuse("GBR", "truncated (PIL: not enough image data)")
        return _raw("GBR", data, offset, w, h, mode)
    return _im("GBR", mode, (w, h), decode)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _open_imt(f: _File):
    buffer = f.read(100)
    if b"\n" not in buffer:
        raise SyntaxError
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = f.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            _refuse("IMT", f"{k.decode()} {v!r} is not a number")
        if k == b"pixel" and v == b"n8":
            mode = "L"

    def decode(data, want):
        if offset is None:
            _refuse("IMT", "no form feed before the pixels (PIL: cannot load this image)")
        return _raw("IMT", data, offset, w, h, "L")
    return _im("IMT", mode, (w, h), decode)


def _open_mcidas(f: _File):
    s = f.read(256)
    if not s.startswith(b"\0\0\0\0\0\0\0\x04") or len(s) != 256:
        raise SyntaxError
    d = (0,) + struct.unpack("!64i", s)
    mode, rawmode = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}.get(
        d[11], (None, None))
    if mode is None:
        raise SyntaxError
    w, h = d[10], d[9]
    offset, stride = d[34] + d[15], d[15] + d[10] * d[11] * d[14]

    def decode(data, want):
        if not -2 ** 31 <= stride < 2 ** 31:
            _refuse("MCIDAS", f"a line stride of {stride} bytes (PIL: signed integer overflow)")
        if mode == "I":
            return _raw("MCIDAS", data, offset, w, h, rawmode, stride)
        # "L" and "I;16B": PIL maps the file where its lines fit
        if offset < 0:
            _refuse("MCIDAS", "the samples start before the file (PIL: tile offset cannot be "
                    "negative)")
        if offset + h * stride > len(data):
            return _raw("MCIDAS", data, offset, w, h, rawmode, stride)
        return _mapped("MCIDAS", data, offset, w, h, rawmode, stride)
    return _im("MCIDAS", mode, (w, h), decode)


_XV_PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                        for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def _open_xvthumb(f: _File):
    if not f.read(6).startswith(b"P7 332"):
        raise SyntaxError
    f.readline()
    while True:
        s = f.readline()
        if not s:
            raise SyntaxError
        if s[0] != 35:
            break
    words = s.strip().split(maxsplit=2)[:2]
    try:
        w, h = (int(x) for x in words)
    except ValueError:
        _refuse("XVTHUMB", f"size line {s.strip()!r} (PIL: invalid literal)")
    offset = f.tell()
    return _im("XVTHUMB", "P", (w, h),
               lambda data, want: _XV_PALETTE[_raw("XVTHUMB", data, offset, w, h, "P")])


# the block-texture formats (utils/textures.py) and the rest of the registry
# (utils/registry_formats.py)

def _open_dds(f: _File):
    from citlab_as_tpu_torch.utils import textures
    return textures.open_dds(f)


def _open_blp(f: _File):
    from citlab_as_tpu_torch.utils import textures
    return textures.open_blp(f)


def _open_ftex(f: _File):
    from citlab_as_tpu_torch.utils import textures
    return textures.open_ftex(f)


# plugins this port does not decode: enough of their open to end where PIL ends

def _open_icns(f: _File):
    from citlab_as_tpu_torch.utils import registry_formats
    return registry_formats.open_icns(f)


def _open_pcd(f: _File):
    from citlab_as_tpu_torch.utils import registry_formats
    return registry_formats.open_pcd(f)


def _open_fits(f: _File):
    from citlab_as_tpu_torch.utils import registry_formats
    return registry_formats.open_fits(f)


def _open_fli(f: _File):
    from citlab_as_tpu_torch.utils import registry_formats
    return registry_formats.open_fli(f)


def _open_iptc(f: _File):
    from citlab_as_tpu_torch.utils import registry_formats
    return registry_formats.open_iptc(f)


def _open_wmf(f: _File):
    s = f.read(80)
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00") or (
            s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF"):
        return _im("WMF", "RGB", (1, 1), None)
    raise SyntaxError


# ------------------------------------------------------------------ PIL's order

def _dib_accept(prefix: bytes) -> bool:
    return _u32le(prefix) in _DIB_HEADERS


def _starts(*magics):
    return lambda prefix: prefix.startswith(magics)


def _avif_accept(prefix: bytes) -> bool:
    return prefix[4:8] == b"ftyp" and prefix[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1")


def _open_avif(f: _File):
    from citlab_as_tpu_torch.utils import avif
    info = avif.open_avif(f.data)
    return _im("AVIF", info.mode, (info.width, info.height),
               lambda data, want: avif.decode(data, info))


# (name, accept(prefix) or None, opener or None: named here, decoded by io.py
# or refused by name)
_PLUGINS = [
    ("BMP", bmp_gif.is_bmp, None),
    ("DIB", _dib_accept, _open_dib),
    ("GIF", bmp_gif.is_gif, None),
    # PIL's test is FF D8 FF; no later plugin opens the files between
    ("JPEG", _starts(b"\xff\xd8\xff"), None),
    ("PPM", lambda p: p[:1] == b"P" and len(p) >= 2 and p[1] in b"0123456fy", None),
    ("PNG", _starts(b"\x89PNG\r\n\x1a\n"), None),
    ("AVIF", _avif_accept, _open_avif),
    ("BLP", _starts(b"BLP1", b"BLP2"), _open_blp),
    ("BUFR", _starts(b"BUFR", b"ZCZC"), None),
    ("CUR", _starts(b"\0\0\2\0"), _open_cur),
    ("PCX", _pcx_accept, _open_pcx),
    ("DCX", lambda p: len(p) >= 4 and _u32le(p) == 0x3ADE68B1, _open_dcx),
    ("DDS", _starts(b"DDS "), _open_dds),
    ("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _u32le(p) == 0xC6D3D0C5),
     None),
    ("FITS", _starts(b"SIMPLE"), _open_fits),
    ("FLI", lambda p: len(p) >= 16 and _u16le(p, 4) in (0xAF11, 0xAF12)
     and _u16le(p, 14) in (0, 3), _open_fli),
    ("FTEX", _starts(b"FTEX"), _open_ftex),
    ("GBR", lambda p: len(p) >= 8 and _u32be(p) >= 20 and _u32be(p, 4) in (1, 2), _open_gbr),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, None),
    ("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), None),
    ("JPEG2000", jpeg2000.is_jpeg2000, None),
    ("ICNS", _starts(b"icns"), _open_icns),
    ("ICO", _starts(b"\0\0\1\0"), _open_ico),
    ("IM", None, _open_im),
    ("IMT", None, _open_imt),
    ("IPTC", None, _open_iptc),
    ("MCIDAS", _starts(b"\0\0\0\0\0\0\0\x04"), _open_mcidas),
    ("MPEG", _starts(b"\x00\x00\x01\xb3"), None),
    ("TIFF", _starts(b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                     b"MM\x00\x2b", b"II\x2b\x00"), None),
    ("MSP", _starts(b"DanM", b"LinS"), _open_msp),
    ("PCD", None, _open_pcd),
    ("PIXAR", _starts(b"\x80\xe8\x00\x00"), _open_pixar),
    ("PSD", _starts(b"8BPS"), _open_psd),
    ("QOI", _starts(b"qoif"), _open_qoi),
    ("SGI", lambda p: len(p) >= 2 and _u16be(p) == 474, _open_sgi),
    ("SPIDER", None, _open_spider),
    ("SUN", lambda p: len(p) >= 4 and _u32be(p) == 0x59A66A95, _open_sun),
    ("TGA", None, _open_tga),
    ("WEBP", webp.is_webp, None),
    ("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), _open_wmf),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _open_xbm),
    ("XPM", _starts(b"/* XPM */"), _open_xpm),
    ("XVTHUMB", _starts(b"P7 332"), _open_xvthumb),
]
# the formats decoded here
FORMATS = ("PCX", "DCX", "PSD", "TGA", "ICO", "CUR", "DIB", "SGI", "SUN", "QOI", "MSP", "IM",
           "XBM", "XPM", "PIXAR", "SPIDER", "GBR", "IMT", "MCIDAS", "XVTHUMB", "DDS", "BLP",
           "FTEX", "ICNS", "PCD", "FITS", "FLI", "IPTC", "AVIF")


def _bomb_check(fmt: str, size) -> None:
    """PIL's decompression-bomb check of an ICO entry, which has a size of
    its own (the file's size is checked in ``utils/io.py``)."""
    from citlab_as_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    if max(1, size[0]) * max(1, size[1]) > 2 * MAX_IMAGE_PIXELS:
        _refuse(fmt, f"{size[0]} x {size[1]} pixels (PIL: decompression bomb)")


def identify(data: bytes):
    """(PIL's format name, the opened header; None for a format decoded
    elsewhere or not at all). Where PIL identifies nothing: (None, [(name,
    why)] of the plugins whose accept test let the file in). Raises
    :class:`Refused` where PIL's open raises past its plugin loop."""
    prefix = data[:16]
    tried = []
    for name, accept, opener in _PLUGINS:
        try:
            if accept is not None and not accept(prefix):
                continue
            if opener is None:
                return name, None
            im = opener(_File(data))
            if not im.mode or im.size[0] <= 0 or im.size[1] <= 0:
                raise SyntaxError("not identified by this driver")
        except _CAUGHT as e:
            if accept is not None or str(e).startswith(name):
                tried.append((name, f"{type(e).__name__}: {e}" if str(e) else type(e).__name__))
            continue
        return name, im if im.decode is not None else None
    return None, tried
