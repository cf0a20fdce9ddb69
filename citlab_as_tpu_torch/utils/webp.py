"""WebP as PIL 12.1 reads it (``WebPImagePlugin``, which hands every file to
libwebp 1.6.0's ``WebPAnimDecoder``), equal bit for bit to
``Image.open(path).convert(mode)``.

The decoder is the port's host C++ library ``csrc/webp_decode.cpp`` (built
with the host C++ compiler at first use, like ``csrc/image_decode.cpp``):
lossy (VP8) frames with libwebp's loop filters, its "fancy" 4:2:0
upsampler and its fixed-point Y'CbCr -> RGB; lossless (VP8L) frames with
every transform, the colour cache and the meta prefix codes; ALPH alpha
(raw or VP8L-compressed, filter methods 0-3); the extended format (VP8X,
its ICCP / EXIF / XMP and unknown chunks skipped, as PIL applies no ICC
profile); and the first frame of an animation, drawn at its offset onto a
canvas of transparent black, which is what PIL shows outside that frame.

PIL's mode is "RGBA" where libwebp's ``WebPGetFeatures`` reports alpha
(in an extended file the VP8X flag or an ALPH chunk before the frame,
overridden by the alpha hint of a VP8L frame; the VP8X flag alone for an
animation; the alpha hint alone for a simple lossless file), else "RGB". A
file PIL refuses (a RIFF chunk that runs past the file's end, a chunk past
the RIFF chunk's end, a bad VP8 start code or VP8L signature, a VP8X
canvas another size than its frame, a damaged bitstream) raises
``NativeDecodeError`` naming the fault; the decoder returns no partial
image. A canvas past PIL's decompression-bomb limit is refused by
``utils/io.py`` from the size :func:`size` reports.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from citlab_as_tpu_torch.utils.image_native import NativeDecodeError

_ERRLEN = 256
_INFO_LEN = 3
_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("webp_decode")
    lib.citlab_webp_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                     ctypes.c_int32]
    lib.citlab_webp_info.restype = ctypes.c_int32
    lib.citlab_webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32]
    lib.citlab_webp_decode.restype = ctypes.c_int32
    return lib


def is_webp(head: bytes) -> bool:
    """A RIFF "WEBP" file whose first chunk is one PIL opens: "VP8 ",
    "VP8L" or "VP8X"."""
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP" and head[12:16] in _CHUNKS


def _info(data: bytes) -> np.ndarray:
    out = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_webp_info(data, len(data),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err,
                               _ERRLEN):
        raise NativeDecodeError(err.value.decode(errors="replace"))
    return out


def size(data: bytes) -> Tuple[int, int]:
    """(width, height) of the canvas, as PIL's open reports them; raises
    where it does."""
    m = _info(data)
    return int(m[0]), int(m[1])


def decode(data: bytes) -> np.ndarray:
    """PIL's image: uint8 [H, W, 4] for "RGBA", [H, W, 3] for "RGB"."""
    m = _info(data)
    w, h, channels = int(m[0]), int(m[1]), int(m[2])
    out = np.empty((h, w, 4), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().citlab_webp_decode(data, len(data), out.ctypes.data, out.nbytes, err, _ERRLEN):
        raise NativeDecodeError(err.value.decode(errors="replace"))
    return out if channels == 4 else np.ascontiguousarray(out[..., :3])
