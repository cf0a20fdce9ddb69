"""JPEG 2000 as PIL 12.1 reads it (``Jpeg2KImagePlugin``, which hands JP2,
JPX and raw J2K codestreams to OpenJPEG 2.5.4 tile by tile and unpacks
each tile with Pillow's own converters), equal bit for bit to
``Image.open(path).convert(mode)``.

The decoder is the port's host C++ library ``csrc/jpeg2000_decode.cpp``
(built with the host C++ compiler at first use, like
``csrc/image_decode.cpp``): the JP2 boxes, every main- and tile-part-header
marker, the five progression orders and POC, PPM / PPT, SOP / EPH, every
code-block style, ROI, the 5/3 and 9/7 wavelets with OpenJPEG's float
arithmetic, RCT / ICT, and Pillow's unpacking of 1- to 31-bit, signed and
subsampled components into "L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P" or
"PA" (a pclr box as PIL builds its palette, sYCC through PIL's YCbCr
tables); then PIL's conversion to "L" or "RGB".

A file PIL refuses (a malformed or truncated box or codestream, a colour
space Pillow has no unpacker for, a first component subsampled) raises
``NativeDecodeError`` naming the fault (a size past PIL's
decompression-bomb limit is refused by ``utils/io.py``), and so do the features no oracle file can be written for
(high-throughput code-blocks, Part 2 multi-component transforms): the
decoder returns no partial image.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from citlab_as_tpu_torch.utils.image_native import NativeDecodeError

_ERRLEN = 256
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_SOC_SIZ = b"\xff\x4f\xff\x51"


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("jpeg2000_decode")
    lib.citlab_j2k_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                    ctypes.c_int32]
    lib.citlab_j2k_info.restype = ctypes.c_int32
    lib.citlab_j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_int32]
    lib.citlab_j2k_decode.restype = ctypes.c_int32
    return lib


def is_jpeg2000(head: bytes) -> bool:
    """The JP2 signature box (JP2 and JPX files) or a raw codestream's SOC
    and SIZ markers: the prefixes PIL's plugin accepts."""
    return head.startswith((_JP2_SIGNATURE, _SOC_SIZ))


def size(data: bytes) -> Tuple[int, int]:
    """(width, height) from SIZ or the ihdr box, as PIL's open reports it;
    raises where PIL's open does."""
    out = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_j2k_info(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                              err, _ERRLEN):
        raise NativeDecodeError(err.value.decode(errors="replace"))
    return int(out[0]), int(out[1])


def decode(data: bytes, mode: str = "L") -> np.ndarray:
    """PIL's ``convert(mode)`` of the image: uint8 [H, W] for "L",
    [H, W, 3] for "RGB"."""
    w, h = size(data)
    out = np.empty((h, w, 3) if mode == "RGB" else (h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_j2k_decode(data, len(data), int(mode == "RGB"), out.ctypes.data,
                                out.nbytes, err, _ERRLEN):
        raise NativeDecodeError(err.value.decode(errors="replace"))
    return out
