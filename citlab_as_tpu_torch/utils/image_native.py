"""ctypes bindings of the port's host image decoder
(``csrc/image_decode.cpp``): JPEG and TIFF files to uint8 arrays equal to
PIL's decode in the file's own mode (see the source for what is decoded
and what raises).

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
import zlib
from typing import Tuple

import numpy as np

_ERRLEN = 512
_INFLATE_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64)


class NativeDecodeError(ValueError):
    """The decoder refused the file; the message names the variant."""


@_INFLATE_FN
def _inflate(src, n, dst, dst_n):
    """zlib stream at ``src`` -> at most ``dst_n`` bytes at ``dst``; the
    count written, or -1 for corrupt data."""
    try:
        out = zlib.decompressobj().decompress(ctypes.string_at(src, n), dst_n)
    except zlib.error:
        return -1
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
    return lib


def info(data: bytes) -> Tuple[int, int, int]:
    """(width, height, channels) from the headers alone."""
    out = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_image_info(data, len(data), out, err, _ERRLEN):
        raise NativeDecodeError(err.value.decode())
    return out[0], out[1], out[2]


def decode(data: bytes) -> np.ndarray:
    """[H, W] grey, [H, W, 2] grey + alpha, [H, W, 3] RGB or [H, W, 4] RGBA
    uint8 (a palette image comes expanded to RGB, a bilevel one as 0/255)."""
    w, h, ch = info(data)
    out = np.empty((h, w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_image_decode(data, len(data), out.ctypes.data, out.size, _inflate,
                                  err, _ERRLEN):
        raise NativeDecodeError(err.value.decode())
    return out[..., 0] if ch == 1 else out
