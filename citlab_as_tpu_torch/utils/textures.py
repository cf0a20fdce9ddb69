"""The block-texture formats of PIL's registry, DDS, BLP and FTEX, as PIL
12.1 reads them: equal bit for bit to ``Image.open(path).convert(mode)``.

- DDS (``DdsImagePlugin``): the first surface only. Block-compressed
  (FourCC DXT1 / DXT3 / DXT5, ATI1 / BC4U, ATI2 / BC5U, BC5S, and the DX10
  header's BC1-BC7 and R8G8B8A8 formats PIL maps), uncompressed RGB(A)
  through PIL's ``dds_rgb`` decoder (any channel masks, each channel
  scaled as ``int(value / max * 255)``, pixels past the file's end zero),
  luminance "L" and "LA", and 8-bit palette images with their RGBA palette.
- BLP (``BlpImagePlugin``): BLP1 JPEG-compressed (the header's JPEG tables
  and the first mipmap joined into one JPEG stream, decoded by the port's
  JPEG decoder, whose RGB PIL then reads as BGR; a 4-component stream is
  taken as CMYK, YCCK unconverted) and BLP1 palette images; BLP2 palette images and
  DXT1 / DXT3 / DXT5 blocks, as PIL's own Python block decoder widens and
  rounds them, its rows of whole blocks read at the image's width.
- FTEX (``FtexImagePlugin``): format 0 (BC1) and 1 (raw RGB), first mipmap.

The BC1-BC7 blocks are decoded by host C++ (``csrc/bcn_decode.cpp``,
PIL's ``BcnDecode.c`` and ``decode_dxt*``, built with g++ at first use);
headers, palettes and channel masks are numpy. Every file PIL refuses,
at its open or at its load, raises here, naming the format and the fault.
``decode`` returns the forms ``utils/io.py`` converts from.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from citlab_as_tpu_torch.utils import raster_formats as rf


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("bcn_decode")
    i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    lib.citlab_bcn_decode.argtypes = [ctypes.c_char_p, i64, i32, i32, i32, i32, p]
    lib.citlab_bcn_decode.restype = i64
    lib.citlab_blp_dxt_decode.argtypes = [ctypes.c_char_p, i64, i32, i32, i32, i32, p]
    lib.citlab_blp_dxt_decode.restype = i64
    return lib


def bcn(fmt: str, data: bytes, kind: int, sign: bool, w: int, h: int) -> np.ndarray:
    """BcnDecode.c over ``data``: uint8 [h, w] for BC4, else [h, w, 4]
    (RGBA, or RGB and an unused byte for BC5 and BC6H)."""
    out = np.zeros((h, w) if kind == 4 else (h, w, 4), np.uint8)
    if _lib().citlab_bcn_decode(data, len(data), kind, int(sign), w, h, out.ctypes.data) < 0:
        rf._refuse(fmt, f"truncated (the BC{kind} blocks end before the image is full; PIL: "
                   "image file is truncated)")
    return out


# ------------------------------------------------------------------ DDS

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000


def _fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


# FourCC -> (mode, BCn kind, signed)
_DDS_FOURCC = {_fourcc(b"DXT1"): ("RGBA", 1, False), _fourcc(b"DXT3"): ("RGBA", 2, False),
               _fourcc(b"DXT5"): ("RGBA", 3, False), _fourcc(b"BC4U"): ("L", 4, False),
               _fourcc(b"ATI1"): ("L", 4, False), _fourcc(b"BC5S"): ("RGB", 5, True),
               _fourcc(b"BC5U"): ("RGB", 5, False), _fourcc(b"ATI2"): ("RGB", 5, False)}
# DXGI format -> (mode, BCn kind or 0 for raw RGBA, signed)
_DDS_DXGI = {70: ("RGBA", 1, False), 71: ("RGBA", 1, False), 73: ("RGBA", 2, False),
             74: ("RGBA", 2, False), 76: ("RGBA", 3, False), 77: ("RGBA", 3, False),
             79: ("L", 4, False), 80: ("L", 4, False), 82: ("RGB", 5, False),
             83: ("RGB", 5, False), 84: ("RGB", 5, True), 95: ("RGB", 6, False),
             96: ("RGB", 6, True), 97: ("RGBA", 7, False), 98: ("RGBA", 7, False),
             99: ("RGBA", 7, False), 27: ("RGBA", 0, False), 28: ("RGBA", 0, False),
             29: ("RGBA", 0, False)}


def _dds_rgb(data: bytes, pos: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """DdsRgbDecoder: one little-endian value of bitcount / 8 bytes a pixel
    (a read past the file's end gives 0), each mask's bits shifted down and
    scaled as ``int(v / max * 255)``."""
    n_px = w * h
    step = bitcount // 8
    if step == 0:
        values = np.zeros(n_px, np.uint64)
    else:
        # only a value's low four bytes meet the 32-bit masks
        keep = min(step, 4)
        raw = np.frombuffer(data, np.uint8)[pos:]
        need = n_px * step
        if raw.size < need:
            raw = np.concatenate([raw, np.zeros(need - raw.size, np.uint8)])
        cols = raw[:need].reshape(n_px, step)[:, :keep].astype(np.uint64)
        values = np.zeros(n_px, np.uint64)
        for k in range(keep):
            values |= cols[:, k] << np.uint64(8 * k)
    out = np.zeros((n_px, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = (values & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = (v.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def open_dds(f) -> object:
    if not f.read(4).startswith(b"DDS "):
        raise SyntaxError("not a DDS file")
    header_size = struct.unpack("<I", f.read(4))[0]
    if header_size != 124:
        rf._refuse("DDS", f"header size {header_size} (PIL: Unsupported header size)")
    header = f.read(120)
    if len(header) != 120:
        rf._refuse("DDS", f"a header of {len(header)} bytes (PIL: Incomplete header)")
    height, width = struct.unpack_from("<2I", header, 4)
    pfflags, fourcc, bitcount = struct.unpack_from("<3I", header, 72)
    size = (width, height)
    if pfflags & _DDPF_RGB:
        mode = "RGBA" if pfflags & _DDPF_ALPHAPIXELS else "RGB"
        masks = struct.unpack_from(f"<{len(mode)}I", header, 84)
        pos = f.tell()
        return rf._im("DDS", mode, size, lambda data, want: _dds_rgb(
            data, pos, width, height, bitcount, masks))
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            rf._refuse("DDS", f"a luminance image of {bitcount} bits (PIL: Unsupported "
                       "bitcount)")
        pos = f.tell()
        return rf._im("DDS", mode, size,
                      lambda data, want: rf._raw("DDS", data, pos, width, height, mode))
    if pfflags & _DDPF_PAL8:
        palette = np.frombuffer(f.read(1024), np.uint8)
        pos = f.tell()

        def decode(data, want):
            index = rf._raw("DDS", data, pos, width, height, "P")
            full = np.zeros((256, 3), np.uint8)     # PIL's palette: black past the file's
            n = palette.size // 4
            full[:n] = palette[:4 * n].reshape(n, 4)[:, :3]
            return full[index]
        return rf._im("DDS", "P", size, decode)
    if pfflags & _DDPF_FOURCC:
        if fourcc == _fourcc(b"DX10"):
            dxgi = struct.unpack("<I", f.read(4))[0]
            f.read(16)
            if dxgi not in _DDS_DXGI:
                rf._refuse("DDS", f"DXGI format {dxgi} (PIL: Unimplemented DXGI format)")
            mode, kind, sign = _DDS_DXGI[dxgi]
        elif fourcc in _DDS_FOURCC:
            mode, kind, sign = _DDS_FOURCC[fourcc]
        else:
            rf._refuse("DDS", f"pixel format {struct.pack('<I', fourcc)!r} (PIL: Unimplemented "
                       "pixel format)")
        pos = f.tell()
        if not kind:
            return rf._im("DDS", mode, size,
                          lambda data, want: rf._raw("DDS", data, pos, width, height, mode))

        def decode(data, want):
            px = bcn("DDS", data[pos:], kind, sign, width, height)
            # BC5 and BC6H: RGB, the fourth byte unused
            return np.ascontiguousarray(px[..., :3]) if mode == "RGB" else px
        return rf._im("DDS", mode, size, decode)
    rf._refuse("DDS", f"pixel format flags {pfflags} (PIL: Unknown pixel format flags)")


# ------------------------------------------------------------------ FTEX

def open_ftex(f) -> object:
    if not f.read(4).startswith(b"FTEX"):
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", f.read(4))
    width, height = struct.unpack("<2i", f.read(8))
    _, format_count = struct.unpack("<2i", f.read(8))
    if format_count != 1:
        rf._refuse("FTEX", f"{format_count} texture formats (PIL: assertion error)")
    fmt, where = struct.unpack("<2i", f.read(8))
    f.seek(where)
    mipmap_size = struct.unpack("<i", f.read(4))[0]
    if mipmap_size < -1:
        rf._refuse("FTEX", f"a mipmap of {mipmap_size} bytes (PIL: read length must be "
                   "non-negative or -1)")
    body = f.read(mipmap_size)
    if fmt == 0:
        return rf._im("FTEX", "RGBA", (width, height),
                      lambda data, want: bcn("FTEX", body, 1, False, width, height))
    if fmt == 1:
        return rf._im("FTEX", "RGB", (width, height),
                      lambda data, want: rf._raw("FTEX", body, 0, width, height, "RGB"))
    rf._refuse("FTEX", f"texture format {fmt} (PIL: Invalid texture compression format)")


# ------------------------------------------------------------------ BLP

def open_blp(f) -> object:
    magic = f.read(4)
    if magic not in (b"BLP1", b"BLP2"):
        rf._refuse("BLP", f"magic {magic!r} (PIL: Bad BLP magic)")
    compression = struct.unpack("<i", f.read(4))[0]
    if magic == b"BLP1":
        alpha = struct.unpack("<I", f.read(4))[0] != 0
        alpha_encoding = 0
    else:
        encoding = struct.unpack("<b", f.read(1))[0]
        alpha = struct.unpack("<b", f.read(1))[0] != 0
        alpha_encoding = struct.unpack("<b", f.read(1))[0]
        f.seek(1, 1)
    width, height = struct.unpack("<II", f.read(8))
    if magic == b"BLP1":
        encoding = struct.unpack("<i", f.read(4))[0]
        f.seek(4, 1)
        offset = 28
    else:
        offset = 20
    mode = "RGBA" if alpha else "RGB"

    def decode(data, want):
        return _blp_decode(data, magic, offset, compression, encoding, alpha, alpha_encoding,
                           width, height, mode)
    return rf._im("BLP", mode, (width, height), decode)


class _Reader:
    """BLP's reads from the file: ImageFile._safe_read, which raises where
    the file holds fewer bytes than asked ("Truncated File Read")."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            rf._refuse("BLP", "truncated (PIL: Truncated File Read)")
        self.pos += n
        return out


def _blp_palette(r: _Reader) -> np.ndarray:
    """_read_palette: 256 BGRA entries (a short read is a truncated file)."""
    return np.frombuffer(r.read(1024), np.uint8).reshape(256, 4)


def _blp_indexed(r: _Reader, length: int, palette, alpha: bool) -> np.ndarray:
    """_read_bgra: each byte of the first mipmap through the BGRA palette,
    as RGB or RGBA bytes."""
    index = np.frombuffer(r.read(length), np.uint8)
    rgba = palette[:, [2, 1, 0, 3]]
    return rgba[index][:, :4 if alpha else 3].reshape(-1)


def _as_raw(flat: np.ndarray, w: int, h: int, channels: int) -> np.ndarray:
    """ImageFile.set_as_raw: the image's rows read from the bytes in order;
    fewer bytes than the image is an error."""
    need = w * h * channels
    if flat.size < need:
        rf._refuse("BLP", "fewer pixels than the image (PIL: not enough image data)")
    return flat[:need].reshape(h, w, channels)


def _as_cmyk(stream: bytes) -> bytes:
    """The JPEG stream with every Adobe marker's transform set to 0: PIL
    tells libjpeg that a 4-component BLP stream is CMYK (its tile's
    ``jpegmode``), so a YCCK one is not converted."""
    out = bytearray(stream)
    at = out.find(b"\xff\xee")
    while at >= 0:
        if out[at + 4:at + 9] == b"Adobe" and at + 15 < len(out):
            out[at + 15] = 0
        at = out.find(b"\xff\xee", at + 2)
    return bytes(out)


def _blp_decode(data, magic, offset, compression, encoding, alpha, alpha_encoding, w, h, mode):
    from citlab_as_tpu_torch.utils import image_native
    ch = len(mode)
    r = _Reader(data, offset)
    offsets = struct.unpack("<16I", r.read(64))
    lengths = struct.unpack("<16I", r.read(64))
    if magic == b"BLP1":
        if compression == 0:
            header = r.read(struct.unpack("<I", r.read(4))[0])
            r.read(offsets[0] - r.pos)
            stream = header + r.read(lengths[0])
            if not stream.startswith(b"\xff\xd8\xff"):
                rf._refuse("BLP", "its JPEG stream does not start with FF D8 FF (PIL: not a "
                           "JPEG file)")
            try:
                px = image_native.decode(_as_cmyk(stream))
            except image_native.NativeDecodeError as e:
                rf._refuse("BLP", f"its JPEG stream: {e}")
            if px.ndim == 2:
                px = np.repeat(px[..., None], 3, -1)
            bgr = np.ascontiguousarray(px[..., ::-1]).reshape(-1)
            out = _as_raw(bgr, w, h, 3)
            if ch == 4:
                out = np.concatenate([out, np.full((h, w, 1), 255, np.uint8)], -1)
            return out
        if compression == 1:
            if encoding not in (4, 5):
                rf._refuse("BLP", f"BLP1 encoding {encoding} (PIL: Unsupported BLP encoding)")
            palette = _blp_palette(r)
            return _as_raw(_blp_indexed(r, lengths[0], palette, alpha), w, h, ch)
        rf._refuse("BLP", f"BLP1 compression {compression} (PIL: Unsupported BLP compression)")
    palette = _blp_palette(r)
    r.pos = offsets[0]
    if compression != 1:
        rf._refuse("BLP", f"BLP2 compression {compression} (PIL: Unknown BLP compression)")
    if encoding == 1:
        flat = _blp_indexed(r, lengths[0], palette, alpha)
    elif encoding == 2:
        kind = {0: 1, 1: 3, 7: 5}.get(alpha_encoding)
        if kind is None:
            rf._refuse("BLP", f"alpha encoding {alpha_encoding} (PIL: Unsupported alpha "
                       "encoding)")
        bw, bh = (w + 3) // 4, (h + 3) // 4
        line = bw * (8 if kind == 1 else 16)
        body = r.read(bh * line) if bh * line else b""
        px_ch = 3 if kind == 1 and not alpha else 4
        flat = np.zeros(bh * 4 * bw * 4 * px_ch, np.uint8)
        if bh and bw:
            _lib().citlab_blp_dxt_decode(body, len(body), kind, int(alpha), w, h,
                                         flat.ctypes.data)
    else:
        rf._refuse("BLP", f"BLP2 encoding {encoding} (PIL: Unknown BLP encoding)")
    return _as_raw(flat, w, h, ch)
