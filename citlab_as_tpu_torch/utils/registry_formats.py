"""The rest of PIL's registry that the port decodes, ICNS, PCD, FITS, FLI
and IPTC, as PIL 12.1 reads them: equal bit for bit to
``Image.open(path).convert(mode)``.

- ICNS (``IcnsImagePlugin``): the largest entry PIL finds; PNG entries by
  the port's PNG decoder and JPEG 2000 entries by ``utils/jpeg2000.py``
  (each entry's own size through PIL's decompression-bomb check), the RLE
  entries ``is32`` / ``il32`` / ``ih32`` / ``it32`` (with its four-byte
  lead) and their ``s8mk`` / ``l8mk`` / ``h8mk`` / ``t8mk`` masks; every
  reader of the chosen size runs, so a broken one refuses the file.
- PCD (``PcdImagePlugin``, ``PcdDecode.c``): the 768 x 512 base image at
  sector 96, two rows of luma and one of each chroma at a time, PhotoYCC to
  RGB with Pillow's tables (``Unpack.c`` "YCC;P"), rotated as the
  orientation byte says (1 and 3: 512 x 768).
- FITS (``FitsImagePlugin``): the header cards as PIL reads them, BITPIX
  8 / 16 / 32 / -32 / -64 into "L" / "I;16" / "I" / "F" with PIL's raw
  reading of them (little-endian, bottom-up, "F" of 4-byte words), and the
  GZIP_1 ``ZIMAGE`` binary table through the standard library's gzip as
  ``FitsGzipDecoder`` reads it.
- FLI / FLC (``FliImagePlugin``, ``FliDecode.c``): the first frame with the
  palette of its first colour chunk (64 levels shifted as PIL shifts them),
  its chunks decoded by host C++ (``csrc/raster_decode.cpp``).
- IPTC (``IptcImagePlugin``): PIL's tag reader, the image data fields
  joined, a raw image wrapped as a P5 stream (or a JPEG one) and decoded by
  the port's PNM (or JPEG) decoder, one band of an RGB or CMYK image.

Every file PIL refuses, at its open or at its load, raises here naming the
format. ``decode`` returns the forms ``utils/io.py`` converts from.
"""
from __future__ import annotations

import base64
import functools
import gzip
import math
import struct
import zlib

import numpy as np

from citlab_as_tpu_torch.utils import raster_formats as rf


# ------------------------------------------------------------------ ICNS

# (size, scale) -> its entries, in the order PIL reads them
_ICNS_SIZES = {
    (512, 512, 2): [b"ic10"], (512, 512, 1): [b"ic09"], (256, 256, 2): [b"ic14"],
    (256, 256, 1): [b"ic08"], (128, 128, 2): [b"ic13"],
    (128, 128, 1): [b"ic07", b"it32", b"t8mk"], (64, 64, 1): [b"icp6"],
    (32, 32, 2): [b"ic12"], (48, 48, 1): [b"ih32", b"h8mk"],
    (32, 32, 1): [b"icp5", b"il32", b"l8mk"], (16, 16, 2): [b"ic11"],
    (16, 16, 1): [b"icp4", b"is32", b"s8mk"]}
_ICNS_RLE = (b"it32", b"ih32", b"il32", b"is32")
_ICNS_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")


def open_icns(f) -> object:
    sig, filesize = struct.unpack(">4sI", f.read(8))
    if not sig.startswith(b"icns"):
        raise SyntaxError("not an icns file")
    entries = {}
    i = 8
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", f.read(8))
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocksize -= 8
        entries[sig] = (i, blocksize)
        f.seek(blocksize, 1)
        i += blocksize
    sizes = [size for size, codes in _ICNS_SIZES.items() if any(c in entries for c in codes)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    best = max(sizes)
    size = (best[0] * best[2], best[1] * best[2])
    return rf._im("ICNS", "RGBA", size,
                  lambda data, want: _icns_image(data, entries, best, want))


def _icns_image(data, entries, best, want):
    """IcnsFile.getimage of the best size: every reader of the size runs
    (dataforsize), then the PNG or JPEG 2000 image, or the RGB channels with
    the mask as alpha; the result's size must be one PIL's size setter
    allows."""
    channels = {}
    pixel = (best[0] * best[2], best[1] * best[2])
    for code in _ICNS_SIZES[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if code in _ICNS_RLE:
            channels["RGB"] = _icns_rgb(data, start, length, pixel, code == b"it32")
        elif code in _ICNS_MASKS:
            mask = data[start:start + pixel[0] * pixel[1]]
            if len(mask) < pixel[0] * pixel[1]:
                rf._refuse("ICNS", "a truncated mask (PIL: not enough image data)")
            channels["A"] = np.frombuffer(mask, np.uint8).reshape(pixel[1], pixel[0])
        else:
            channels["RGBA"] = _icns_png_or_jpeg2000(data, start, length, want)
    if "RGBA" in channels:
        out = channels["RGBA"]
    elif "RGB" not in channels:
        rf._refuse("ICNS", "a mask without its RGB entry (PIL: KeyError 'RGB')")
    else:
        out = channels["RGB"]
        if "A" in channels:
            out = np.concatenate([out, channels["A"][..., None]], -1)
    h, w = out.shape[:2]
    sizes = [(s[0] * s[2], s[1] * s[2]) for s, codes in _ICNS_SIZES.items()
             if any(c in entries for c in codes)]
    if not any(w and h and sw // w and sh / h == sw // w for sw, sh in sizes):
        rf._refuse("ICNS", f"an entry of {w} x {h} pixels (PIL: This is not one of the "
                   "allowed sizes of this image)")
    return out


def _icns_rgb(data, start, length, pixel, lead):
    """read_32t / read_32: raw RGB where the entry holds exactly 3 bytes a
    pixel, else three bands of PIL's run-length code read on from the
    entry's start (a control byte c < 128: c + 1 literal bytes; else a run
    of c - 125 copies of the next byte)."""
    if lead:
        if data[start:start + 4] != b"\0\0\0\0":
            rf._refuse("ICNS", "it32 without its four zero bytes (PIL: Unknown signature)")
        start, length = start + 4, length - 4
    w, h = pixel
    n = w * h
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < n * 3:
            rf._refuse("ICNS", "truncated RGB data (PIL: not enough image data)")
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    bands = []
    pos = start
    for band in range(3):
        parts = []
        left = n
        while left > 0:
            if pos >= len(data):
                break
            c = data[pos]
            pos += 1
            if c & 0x80:
                count = c - 125
                parts.append(data[pos:pos + 1] * count)
                pos += 1
            else:
                count = c + 1
                parts.append(data[pos:pos + count])
                pos += count
            left -= count
        if left != 0:
            rf._refuse("ICNS", f"a run-length band that ends {left} bytes from its size (PIL: "
                       "Error reading channel)")
        raw = b"".join(parts)
        if len(raw) < n:
            rf._refuse("ICNS", "a truncated run-length band (PIL: not enough image data)")
        bands.append(np.frombuffer(raw, np.uint8, n).reshape(h, w))
    return np.stack(bands, -1)


def _icns_png_or_jpeg2000(data, start, length, want):
    from citlab_as_tpu_torch.utils import io as port_io
    from citlab_as_tpu_torch.utils import jpeg2000
    sig = data[start:start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        png = data[start:]
        if port_io._png_broken(png) or png[12:16] != b"IHDR" or len(png) < 24:
            raise rf.Refused("ICNS: its PNG entry PIL's PNG reader refuses")
        w, h = struct.unpack_from(">II", png, 16)
        if not w or not h:
            raise rf.Refused("ICNS: its PNG entry PIL's PNG reader refuses")
        rf._bomb_check("ICNS", (w, h))
        try:
            return port_io._decode_png(png, "ICNS")
        except Exception as err:        # noqa: BLE001 - every fault of the entry refuses
            raise rf.Refused(f"ICNS: its PNG entry: {err}") from None
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
            sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        stream = data[start:start + length]
        try:
            rf._bomb_check("ICNS", jpeg2000.size(stream))
            return jpeg2000.decode(stream, want)
        except rf.Refused:
            raise
        except Exception as err:        # noqa: BLE001 - every fault of the entry refuses
            raise rf.Refused(f"ICNS: its JPEG 2000 entry: {err}") from None
    rf._refuse("ICNS", "an entry neither PNG nor JPEG 2000 (PIL: Unsupported icon subimage "
               "format)")


# ------------------------------------------------------------------ PCD

# Pillow's PhotoYCC tables (Unpack.c "YCC;P"): L, CB, GB, CR, GR, int16,
# zlib, base64; r = L[y] + CR[cr], g = L[y] + GR[cr] + GB[cb],
# b = L[y] + CB[cb], clipped
_PHOTO_YCC = (
    "eNpN1omfjXUcxfHztY9tmNBkso5hLI3dIPskSSNJQoukXdqktElJ0iKV9qK02KJCCaEkW6k0hckembJHCPmdzv3S0z"
    "PvP+A+z32dz/cOYCiMIiiK4iiBkiiF0iiLZJRDCs5ABVTCmUhFZaShCqqiGmqgJtKRgdqog7qoh/o4B1lohMZogmZo"
    "jhZoiVZojTZoi3bogI7IwXnojC64AF3RDRchFxejB3riUvRCb1yOPuiHK3AlrkZ/XINrMRDX4wbciJtxCwZhMG7D7b"
    "gTd2EIhuIeDMN9uB8P4iEMxwg8gkfxGEbhcTyBMXgKT+MZPItxeA4vYDxexMt4Ba/idbyBCZiItzAJ7+BdvI/JmIJp"
    "mI4ZmIkP8TFmYTY+waeYi3mYjwVYiEX4Al9iCZbiayzDCqzEKnyL1fgOP2AN8vATfsY6rEc+NmAjNmELtmIbtmMHdq"
    "IAv2MXdmMP9mE/DuAgDuEwjuAojuE4TuAkAgizQlbYiloxK2FJVtJKWxkra+WsvKVYBatolSzVzrI0O9uqWDWrbjUs"
    "3WpZhtWxTKtr9a2BZVlDa2RNrKk1sxaWbS2ttZ1rba2dtbeO1slyrLOdb12sq11o3SzXulsPu8R6Wi+7zHpbH+tr/W"
    "xymBqmh5nhozArzAlzw7ywICwMi8OSsDQsCyvCqrA6fB/WhLywNqwPv4SNYXPYFraH30JB2BX2hH3hQDgYDoej4Vg4"
    "EYJerBCLsBiTWIplmMzyrMBKTGVlVmE11mA6M5jJemzALDZmUzZnNluxDduxAzvxPHZhV3ZjLnuwJ3uxN/vwCl7F/h"
    "zA63gDb+ItvJW3804O4VDey/v5IIdzBEdyFEdzDJ/iWI7j8xzPl/kqX+ebnMhJfJfvcwqncwY/5MeczU/5Gefzcy7i"
    "l/yKX3M5V/Fbfscf+CN/5jrmcwM3cyt/5Q7u5B/czb3czz/5F4/wbx7nSZJAIVVTHEkqpozXkmgl1TtJVJKuQjLVRw"
    "M0VBtNVUa2V5FoIsd7SNTQ3UtIdNBXDVylAq7FdVr/Tdr+YN/9EN98YvHDtfaR2vpoPKmdj9XKn/eFJ/b9pm87seyp"
    "vurEpudoz59pzQuxWEv+Sjte4RtOLDjP15uv5eZIJ+noOkh7aefaShs517WWVtLSZUsLaS7NXFNpIo1dI2koWe4caS"
    "D1XT2pK5mujtSWDFdL0qWmqyHVpZqrKlXkbJcmleUslypnSiVXUSrIGS5Fyks5SXZlpYyUdqWkpCS5ElJcirmiUkQK"
    "u0Ji8v+fpsDgTso/csIdl2PytzsqR+Sw+0sOyUH3pxyQ/bLP7ZU9stvtkj/kd1cgO+U3t0O2y69um2yVLW6zbJKNbo"
    "P8IvluvayTtSweKzUlajUtVmvtqNdGsWJbx5rtHFXbPdZt36jcgbF2B8fqHRb1+0is4Kejhl+KVfxW1PG0WMlzYi0v"
    "jmpeGes5Lyp6U6zpgljVB6Ou/4mVXTRqOzlWd+VY37WiwrNijbeMKu8U6zw3VvrlUesDYrUPinofGit+RNT8mFj142"
    "PdT4jKnxJrf3ZU/+ex/pfHLsCa0zfgYX3KQ/qsB/SJ98kw3KvPH4q79SR36Xnu0FPdpme7VQbpOW/W096oZ75eTz5Q"
    "zz9Av9n95Wq90ZV6r356uz56x964TG97qfTEJXr3i/UN5OrXvxsu1Ddygb6X86Wz/jfI8evTwa9OW782/92ZbL8vzf"
    "yuNPZ78t8lqe8XJNMvR4ZfjJrRpajqFyLNL0OqX4SKpy9Bit+AZG+/tDef5K2f6ryI922nqw5e86mSj3nBR7zcQ17s"
    "gdOt7vVKd3mdBV7lDq/xVIlbvMCNXl6+F7dWa/xJ8rTMNdrn91rpam31Gy12JVfIci7ThpdqyUu05y+06kVcqH0vkP"
    "mcp7XP1eY/0fJnc5Ya+EglzJQZ/EBdTONUFTJZnbynWt5RM5P4ttqZyAmq6A219JqKekVdvcQXZTz/BfJnSxk="
)


@functools.cache
def _photo_ycc():
    raw = zlib.decompress(base64.b64decode("".join(_PHOTO_YCC)))
    return np.frombuffer(raw, "<i2").reshape(5, 256).astype(np.int32)


def open_pcd(f) -> object:
    f.seek(2048)
    s = f.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    orientation = s[1538] & 3
    size = (512, 768) if orientation in (1, 3) else (768, 512)
    return rf._im("PCD", "RGB", size, lambda data, want: _pcd_image(data, orientation))


def _pcd_image(data, orientation):
    """PcdDecode.c from sector 96: chunks of two 768-sample luma rows, a
    384-sample Cb row and a 384-sample Cr row, each chroma sample on two
    pixels; then the rotation of an upright image (90 or 270 degrees
    anticlockwise, PIL's ``rotate(..., expand=True)``)."""
    start, chunk = 96 * 2048, 3 * 768
    body = np.frombuffer(data, np.uint8)[start:start + 256 * chunk]
    if body.size < 256 * chunk:
        rf._refuse("PCD", "truncated (the base image ends early; PIL: image file is truncated)")
    body = body.reshape(256, chunk)
    y = body[:, :1536].reshape(512, 768).astype(np.int32)
    cb = np.repeat(np.repeat(body[:, 1536:1920], 2, axis=1), 2, axis=0).astype(np.int32)
    cr = np.repeat(np.repeat(body[:, 1920:2304], 2, axis=1), 2, axis=0).astype(np.int32)
    lum, t_cb, t_gb, t_cr, t_gr = _photo_ycc()
    ly = lum[y]
    rgb = np.stack([ly + t_cr[cr], ly + t_gr[cr] + t_gb[cb], ly + t_cb[cb]], -1)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, -1)
    return np.ascontiguousarray(rgb)


# ------------------------------------------------------------------ FITS

def open_fits(f) -> object:
    headers = {}
    in_progress = False
    decoder = None
    while True:
        card = f.read(80)
        if not card:
            rf._refuse("FITS", "truncated (PIL: Truncated FITS file)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break               # the data unit
        elif keyword == b"END":
            f.seek(math.ceil(f.tell() / 2880) * 2880)
            if decoder is None:
                decoder = _fits_parse(headers)
                if decoder[0] is None:      # no image in this header: read on
                    decoder = None
            in_progress = False
            continue
        if decoder is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if decoder is None:
        rf._refuse("FITS", "no image data (PIL: No image data)")
    kind, offset, size, mode, bits = decoder
    offset += f.tell() - 80
    if kind == "raw":
        return rf._im("FITS", mode, size, lambda data, want: _fits_raw(data, offset, size, mode))
    return rf._im("FITS", mode, size,
                  lambda data, want: _fits_gzip(data, offset, size, mode, bits))


def _fits_int(value: bytes) -> int:
    try:
        return int(value)
    except ValueError:
        rf._refuse("FITS", f"header value {value!r} is not a whole number (PIL: invalid "
                   "literal)")


def _fits_size(headers, prefix):
    naxis = _fits_int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _fits_int(headers[prefix + b"NAXIS1"])
    return _fits_int(headers[prefix + b"NAXIS1"]), _fits_int(headers[prefix + b"NAXIS2"])


def _fits_parse(headers):
    """FitsImageFile._parse_headers: (decoder, offset, size, mode, bits),
    decoder None where the header has no image."""
    prefix, kind, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _fits_size(headers, prefix) or (0, 0)
        bits = _fits_int(headers[b"BITPIX"])
        offset = table[0] * table[1] * (bits // 8)
        prefix, kind = b"Z", "fits_gzip"
    size = _fits_size(headers, prefix)
    if not size:
        return None, 0, None, "", 0
    bits = _fits_int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    return kind, offset, size, mode, bits


# PIL reads each mode's raw samples in its own (native, little-endian) order
_FITS_DTYPE = {"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}


def _fits_rows(raw: bytes, size, mode) -> np.ndarray:
    w, h = size
    dt = np.dtype(_FITS_DTYPE[mode])
    px = np.frombuffer(raw, dt, w * h).reshape(h, w)[::-1]
    return px.astype({"L": np.uint8, "I;16": np.uint16, "I": np.int32, "F": np.float32}[mode])


def _fits_raw(data, offset, size, mode):
    """The raw decoder with ystep -1: rows bottom-up, every byte there."""
    w, h = size
    need = w * h * np.dtype(_FITS_DTYPE[mode]).itemsize
    if offset < 0 or len(data) - offset < need:
        rf._refuse("FITS", "truncated (the data unit ends before the image is full)")
    return _fits_rows(data[offset:offset + need], size, mode)


def _fits_gzip(data, offset, size, mode, bits):
    """FitsGzipDecoder: the rest of the file gunzipped, of each 4-byte word
    the last bits / 8 bytes (none for a float image), rows bottom-up."""
    if offset < 0:
        rf._refuse("FITS", "the compressed data starts before the file (PIL: invalid "
                   "argument)")
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:
        rf._refuse("FITS", f"broken GZIP_1 data (PIL: {e})")
    w, h = size
    nb = min(bits // 8, 4)
    # every pixel's word whole in the data, else too few bytes for PIL
    if nb <= 0 or len(value) < 4 * w * h:
        rf._refuse("FITS", "fewer pixels than the image (PIL: not enough image data)")
    words = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - nb:]
    dt = np.dtype(_FITS_DTYPE[mode])
    px = np.frombuffer(words.tobytes(), dt, w * h).reshape(h, w)
    return px.astype({"L": np.uint8, "I;16": np.uint16, "I": np.int32, "F": np.float32}[mode])


# ------------------------------------------------------------------ FLI

def open_fli(f) -> object:
    s = f.read(128)
    if not (len(s) >= 16 and rf._u16le(s, 4) in (0xAF11, 0xAF12) and rf._u16le(s, 14) in (0, 3)
            and s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    n_frames = rf._u16le(s, 6)
    size = (rf._u16le(s, 8), rf._u16le(s, 10))
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    s = f.read(16)
    if rf._u16le(s, 4) == 0xF100:              # a prefix chunk
        f.seek(128 + rf._u32le(s))
        s = f.read(16)
    if rf._u16le(s, 4) == 0xF1FA:              # the first frame: its colour chunk
        chunk_size = None
        for _ in range(rf._u16le(s, 6)):
            if chunk_size is not None:
                f.seek(chunk_size - 6, 1)
            s = f.read(6)
            chunk_type = rf._u16le(s, 4)
            if chunk_type in (4, 11):
                _fli_palette(f, palette, 2 if chunk_type == 11 else 0)
                break
            chunk_size = rf._u32le(s)
            if not chunk_size:
                break
    if n_frames == 0:
        raise EOFError("attempt to seek outside sequence")
    f.seek(128)
    s = f.read(4)
    if not s:
        raise EOFError("missing frame size")
    framesize = rf._u32le(s)
    w, h = size
    return rf._im("FLI", "P", size,
                  lambda data, want: _fli_frame(data, framesize, w, h, palette))


def _fli_palette(f, palette, shift):
    """FliImageFile._palette: packets of (skip, count) and count RGB
    triples, shifted (a 64-level chunk) and kept to 8 bits."""
    i = 0
    for _ in range(rf._u16le(f.read(2))):
        s = f.read(2)
        i += s[0]
        n = s[1] or 256
        s = f.read(n * 3)
        for k in range(0, len(s), 3):
            palette[i] = ((s[k] << shift) & 255, (s[k + 1] << shift) & 255,
                          (s[k + 2] << shift) & 255)
            i += 1


def _fli_frame(data, framesize, w, h, palette):
    index = np.zeros((h, w), np.uint8)
    rf._native("FLI", "citlab_fli_decode", data, len(data), 128, framesize, w, h,
               index.ctypes.data)
    return palette[index]


# ------------------------------------------------------------------ IPTC

_IPTC_TAGS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _iptc_field(f):
    """IptcImageFile.field: (tag, size), (None, 0) at the end."""
    s = f.read(5)
    if not s.strip(b"\0"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _IPTC_TAGS:
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        rf._refuse("IPTC", "illegal field length")
    elif size == 128:
        size = 0
    elif size > 128:
        size = struct.unpack(">I", (bytes(4) + f.read(size - 128))[-4:])[0]
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def open_iptc(f) -> object:
    info = {}
    while True:
        offset = f.tell()
        tag, size = _iptc_field(f)
        if not tag or tag == (8, 10):
            break
        data = f.read(size) if size else None
        info[tag] = [info[tag], data] if tag in info else data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    band = None
    if layers == 1 and not component:
        mode = "L"
    else:
        mode = "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else ""
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0

    def getint(key):
        return struct.unpack(">I", (bytes(4) + info[key])[-4:])[0]
    size = getint((3, 20)), getint((3, 30))
    compression = {1: "raw", 5: "jpeg"}.get(getint((3, 120)))
    if compression is None:
        rf._refuse("IPTC", "compression other than raw or JPEG (PIL: Unknown IPTC image "
                   "compression)")
    if tag != (8, 10):
        return rf._im("IPTC", mode, size, lambda data, want: rf._refuse(
            "IPTC", "no image data field (PIL: cannot load this image)"))
    return rf._im("IPTC", mode, size, lambda data, want: _iptc_image(
        data, offset, size, mode, band, compression, want))


def _iptc_image(data, offset, size, mode, band, compression, want):
    """IptcImageFile.load: the image data fields from ``offset`` joined (a
    P5 header first for raw data) and opened as an image file; an RGB or
    CMYK image gets it as one band, the others black."""
    from citlab_as_tpu_torch.utils import io as port_io
    f = rf._File(data, offset)
    parts = [b"P5\n%d %d\n255\n" % size] if compression == "raw" else []
    try:
        while True:
            tag, n = _iptc_field(f)
            if tag != (8, 10):
                break
            parts.append(f.read(n))
    except (SyntaxError, IndexError, struct.error) as e:
        rf._refuse("IPTC", f"a field after the image data PIL cannot read ({e!r})")
    try:
        px = port_io._decode_data(b"".join(parts), "IPTC", "L")
    except port_io.UnsupportedImageFormat as e:
        rf._refuse("IPTC", f"its image data: {e}")
    if px.dtype != np.uint8 or px.ndim != 2:
        rf._refuse("IPTC", "image data of other bands than one grey band (PIL keeps its "
                   "bands under the IPTC mode unconverted, or refuses to merge them: decided "
                   "divergence)")
    if band is None:
        return px
    bands = 4 if mode == "CMYK" else 3
    if not -bands <= band < bands:
        rf._refuse("IPTC", f"band {band + 1} of a {mode} image (PIL: list index out of range)")
    out = np.zeros(px.shape + (bands,), np.uint8)
    out[..., band] = px
    return rf.cmyk_to_rgb(out) if mode == "CMYK" else out
