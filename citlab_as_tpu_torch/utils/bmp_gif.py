"""BMP and GIF as PIL 12.1 reads them (``BmpImagePlugin`` and the first
frame of ``GifImagePlugin``), equal bit for bit to
``Image.open(path).convert(mode)``.

BMP: the OS/2 v1 (12-byte) and Windows 40- to 124-byte headers; 1-, 4-,
8-, 16-, 24- and 32-bit samples, bottom-up or top-down; RLE8 and RLE4
through PIL's own decoder (its quirks included, host C++ in
``csrc/image_decode.cpp``); BI_BITFIELDS in the mask layouts PIL accepts;
palettes of any length, and PIL's rule that opens a palette of grey ramp
entries as "L" (or "1" for black and white), read with the raw unpacking
PIL then picks. GIF: the logical screen, grown to the first frame's extent;
global and local colour tables, either dropped by PIL where it is the
identity grey ramp ("L"); the first frame's transparency index as the
background outside its extent; LZW (host C++), interlaced or not.

Everything PIL refuses raises ``NativeDecodeError`` naming the variant:
JPEG- or PNG-in-BMP, other header sizes, sample depths and bitfields
layouts, truncated data. ``decode`` returns PIL's image as uint8 [H, W]
("L", "1" as 0/255), [H, W, 3] ("RGB", palettes expanded) or [H, W, 4]
("RGBA").
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from citlab_as_tpu_torch.utils.image_native import (DECODER_BLOCK, NativeDecodeError, bmp_rle,
                                                    gif_lzw)

# ------------------------------------------------------------------ BMP

_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# BI_BITFIELDS: (bits, masks) -> the rawmode PIL reads them with
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# bits per pixel of each rawmode PIL's raw decoder unpacks
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16,
             "BGR": 24}
_COMPRESSIONS = {4: "JPEG", 5: "PNG"}


def _u32(data: bytes, at: int) -> int:
    return struct.unpack_from("<I", data, at)[0]


def _u16(data: bytes, at: int) -> int:
    return struct.unpack_from("<H", data, at)[0]


def _bmp_header(data: bytes) -> dict:
    """BmpImageFile._bitmap of a BMP file: size, row direction, sample
    layout, palette and where the samples start; raises where PIL's open
    does."""
    if len(data) < 18:
        raise NativeDecodeError("BMP: truncated header")
    return _dib_header(data, 14, _u32(data, 10))


def _dib_header(data: bytes, at: int, offset: int, check_size: bool = True) -> dict:
    """The info header at ``at`` (a BMP's after its file header, a DIB's,
    CUR's or ICO's at its own start), the samples at ``offset`` (0: right
    after the header and palette, as PIL reads a DIB)."""
    hsize = _u32(data, at)
    if hsize not in (12, 40, 52, 56, 64, 108, 124):
        raise NativeDecodeError(
            f"BMP: header of {hsize} bytes is not supported (PIL reads 12, 40, 52, 56, 64, "
            "108 and 124)")
    hd = data[at + 4:at + hsize]
    if len(hd) < hsize - 4:
        raise NativeDecodeError("BMP: truncated header")
    pos = at + hsize
    masks = None
    if hsize == 12:
        width, height, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        compression, colors, padding, direction = 0, 0, 3, -1
    else:
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        width = _u32(hd, 0)
        height = 2 ** 32 - _u32(hd, 4) if flip else _u32(hd, 4)
        bits, compression, colors = _u16(hd, 10), _u32(hd, 12), _u32(hd, 28)
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                masks = tuple(_u32(hd, 36 + 4 * i) for i in range(4 if len(hd) >= 52 else 3))
                masks += (0,) * (4 - len(masks))
            else:        # a 40-byte header: three masks after it
                if len(data) < pos + 12:
                    raise NativeDecodeError("BMP: truncated bitfields masks")
                masks = tuple(_u32(data, pos + 4 * i) for i in range(3)) + (0,)
                pos += 12
    if check_size and (width <= 0 or height <= 0):
        raise NativeDecodeError(f"BMP: image of {width} x {height} pixels")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise NativeDecodeError(f"BMP: {bits}-bit samples are not supported (PIL reads "
                                "1, 4, 8, 16, 24 and 32)")
    mode, rawmode = _BIT2MODE[bits]
    rle = False
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise NativeDecodeError(
                f"BMP: bitfields layout {bits}-bit masks "
                f"{tuple(hex(m) for m in key[1])} is not supported (PIL refuses it)")
        rawmode = _MASK_MODES[key]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        name = _COMPRESSIONS.get(compression, str(compression))
        raise NativeDecodeError(
            f"BMP: {name} compression is not supported (PIL refuses it)")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise NativeDecodeError(f"BMP: palette of {colors} colours")
        raw = data[pos:pos + padding * colors]
        entries = np.frombuffer(raw[:len(raw) // padding * padding], np.uint8)
        entries = entries.reshape(-1, padding)[:, 2::-1]             # BGR(X) -> RGB
        grey = np.array([0, 255]) if colors == 2 else np.arange(colors)
        if len(entries) == colors and (entries == grey[:, None]).all():
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            palette = entries
        pos += padding * colors
    return dict(width=width, height=height, direction=direction, bits=bits, mode=mode,
                rawmode=rawmode, rle=rle, rle4=compression == 2, palette=palette,
                offset=offset or pos)


def _bmp_raw(data: bytes, h: dict) -> np.ndarray:
    """PIL's raw decoder: rows of ((width * bits + 31) >> 3) & ~3 bytes,
    each unpacked with the rawmode; the last row needs only its samples."""
    w, ht, rawmode = h["width"], h["height"], h["rawmode"]
    stride = ((w * h["bits"] + 31) >> 3) & ~3
    bits = _RAW_BITS.get(rawmode, 32)
    nbytes = (w * bits + 7) // 8
    if stride < nbytes:
        raise NativeDecodeError(
            f"BMP: {h['bits']}-bit rows read as {rawmode} (PIL's raw decoder refuses them)")
    need = stride * (ht - 1) + nbytes
    if h["offset"] + need > len(data):
        raise NativeDecodeError("BMP: truncated file (the samples run past its end)")
    rows = np.zeros(stride * ht, np.uint8)
    rows[:need] = np.frombuffer(data, np.uint8, need, h["offset"])
    rows = rows.reshape(ht, stride)[:, :nbytes]
    if h["direction"] < 0:
        rows = rows[::-1]
    if bits < 8:
        px = np.unpackbits(rows, axis=1).reshape(ht, -1, bits)[:, :w]
        px = px @ (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        return px * np.uint8(255) if rawmode == "1" else px
    if bits == 8:
        return rows
    if bits == 16:
        v = rows.reshape(ht, w, 2).astype(np.uint32)
        v = v[..., 0] | v[..., 1] << 8
        if rawmode == "BGR;16":
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], -1).astype(np.uint8)
        r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
        return np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], -1).astype(np.uint8)
    px = rows.reshape(ht, w, bits // 8)
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    return np.ascontiguousarray(px[..., order])


def _decode_bmp(data: bytes) -> np.ndarray:
    return _decode_dib(data, _bmp_header(data))


def _decode_dib(data: bytes, h: dict) -> np.ndarray:
    """The samples a header of :func:`_dib_header` describes."""
    if h["width"] <= 0 or h["height"] <= 0:
        raise NativeDecodeError(f"BMP: image of {h['width']} x {h['height']} pixels")
    if h["palette"] is not None and len(h["palette"]) > 256:
        raise NativeDecodeError(f"BMP: palette of {len(h['palette'])} colours (PIL's load "
                                "refuses more than 256: invalid palette size)")
    if h["rle"]:
        if h["mode"] not in ("P", "L"):
            raise NativeDecodeError(
                f"BMP: RLE samples of PIL mode {h['mode']} (PIL cannot unpack them)")
        px, got = bmp_rle(data, h["offset"], h["rle4"], h["width"], h["height"])
        if got < h["width"] * h["height"]:
            raise NativeDecodeError("BMP: the RLE data ends before the image is full "
                                    "(PIL: not enough image data)")
        if h["direction"] < 0:
            px = px[::-1]
    else:
        px = _bmp_raw(data, h)
    if h["palette"] is not None:
        return _expand(px, h["palette"])
    return np.ascontiguousarray(px)


def _expand(index: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Indices -> RGB through the palette; PIL's palette holds 256 entries,
    those past the file's black."""
    full = np.zeros((256, 3), np.uint8)
    n = min(len(palette), 256)
    full[:n] = palette[:n]
    return full[index]


# ------------------------------------------------------------------ GIF

def _sub_block(data: bytes, pos: int):
    """GifImageFile.data: one sub-block (None at a terminator or the end)."""
    if pos >= len(data) or data[pos] == 0:
        return None, pos + 1
    n = data[pos]
    return data[pos + 1:pos + 1 + n], pos + 1 + n


def _palette_needed(p: bytes) -> bool:
    """A colour table that is not the identity grey ramp (PIL then reads the
    indices as grey, mode "L")."""
    t = np.frombuffer(p[:len(p) // 3 * 3], np.uint8).reshape(-1, 3)
    return len(p) % 3 != 0 or not (t == np.arange(len(t))[:, None]).all()


def _gif_header(data: bytes) -> dict:
    """The logical screen and the first frame (GifImageFile._open and
    _seek(0)): size, extent, palette, transparency, interlace and where the
    image data starts."""
    if not data.startswith((b"GIF87a", b"GIF89a")) or len(data) < 13:
        raise NativeDecodeError("GIF: not a GIF87a / GIF89a file")
    w, h = _u16(data, 6), _u16(data, 8)
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += 3 << ((flags & 7) + 1)
        if _palette_needed(p):
            global_palette = p
    transparency = interlace = local = None
    while pos < len(data):
        s = data[pos]
        pos += 1
        if s == 0x3B:                                   # ";" trailer
            break
        if s == 0x21:                                   # "!" extension
            if pos >= len(data):
                break
            label = data[pos]
            block, pos = _sub_block(data, pos + 1)
            if label == 249 and block is not None:
                if len(block) < 4:
                    raise NativeDecodeError("GIF: short graphic control extension")
                if block[0] & 1:
                    transparency = block[3]
            elif label == 254:
                while block:
                    block, pos = _sub_block(data, pos)
                continue
            elif label == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                block, pos = _sub_block(data, pos)
            while True:
                block, pos = _sub_block(data, pos)
                if not block:
                    break
        elif s == 0x2C:                                 # "," image descriptor
            if pos + 10 > len(data):
                raise NativeDecodeError("GIF: truncated image descriptor")
            x0, y0, fw, fh, f = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            w, h = max(w, x0 + fw), max(h, y0 + fh)
            interlace = bool(f & 64)
            if f & 128:
                p = data[pos:pos + (3 << ((f & 7) + 1))]
                pos += 3 << ((f & 7) + 1)
                local = p if _palette_needed(p) else False
            if pos >= len(data):
                raise NativeDecodeError("GIF: truncated image data")
            bits = data[pos]
            pos += 1
            palette = local if local is not None else global_palette
            return dict(size=(w, h), extent=(x0, y0, fw, fh), palette=palette or None,
                        global_palette=global_palette, transparency=transparency,
                        interlace=interlace, bits=bits, offset=pos)
    raise NativeDecodeError("GIF: no image in the first frame")


def _decode_gif(data: bytes, mode: str) -> np.ndarray:
    g = _gif_header(data)
    (w, h), (x0, y0, fw, fh) = g["size"], g["extent"]
    canvas = np.full((h, w), g["transparency"] or 0, np.uint8)
    if x0 == 0 and fw == 0:
        # PIL's decoder.setimage (decode.c) reads a tile whose x0 and x1
        # are both 0 as the whole image, whatever its y0 and height
        x0, y0, fw, fh = 0, 0, w, h
    elif not fw or not fh:
        raise NativeDecodeError("GIF: a frame of width or height 0 (PIL: tile cannot "
                                "extend outside image)")
    # PIL's GifDecode reads sub-blocks to the end of the file (a
    # terminator is an empty block, the trailer one more block), each
    # only once it is whole; it returns at an end code, and ImageFile
    # hands it more only where its reads of 64 KiB have not reached the
    # end of the file; a frame it leaves short is a truncated file
    last_read = g["offset"] + (len(data) - 1 - g["offset"]) // DECODER_BLOCK * DECODER_BLOCK
    blocks, pos, end_skip = [], g["offset"], 0
    while pos < len(data) and pos + 1 + data[pos] <= len(data):
        n = data[pos]
        blocks.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
        if pos <= last_read:
            end_skip += n
    frame = canvas[y0:y0 + fh, x0:x0 + fw].copy()
    got = gif_lzw(b"".join(blocks), g["bits"], frame, g["interlace"], end_skip)
    if got < fw * fh:
        raise NativeDecodeError("GIF: the image data ends before the frame is full "
                                "(PIL: image file is truncated)")
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    palette = g["palette"]
    if palette is None and mode == "RGB":
        # a local grey ramp under a global table: PIL's image is "L", but
        # it carries the global table, which its "RGB" conversion applies
        palette = g["global_palette"]
    if palette is None:
        return canvas
    return _expand(canvas, np.frombuffer(palette, np.uint8).reshape(-1, 3))


# ------------------------------------------------------------------ entry points

def is_bmp(head: bytes) -> bool:
    return head.startswith(b"BM")


def is_gif(head: bytes) -> bool:
    return head.startswith((b"GIF87a", b"GIF89a"))


def size(data: bytes) -> Tuple[int, int]:
    """(width, height) as PIL's open reports them; raises where it does."""
    if is_bmp(data):
        h = _bmp_header(data)
        return h["width"], h["height"]
    return _gif_header(data)["size"]


def decode(data: bytes, mode: str = "L") -> np.ndarray:
    """PIL's image of the file, for its conversion to ``mode`` ("L" or
    "RGB": they differ only for a GIF whose local grey ramp hides a global
    table)."""
    return _decode_bmp(data) if is_bmp(data) else _decode_gif(data, mode)
