"""Zstandard (RFC 8878) and CRC-32C on the host, for the JAX package's orbax
checkpoints: tensorstore's OCDBT manifests and b-tree nodes and the zarr
chunks they hold are zstd frames, and every manifest and node closes with a
CRC-32C.

Both are the port's host C++ library ``csrc/zstd_decode.cpp`` (built with
the host C++ compiler at first use, like ``csrc/image_decode.cpp``), so the
card's machine needs neither libzstd nor a Python package for them.
:func:`decompress` decodes every frame of its input (zstd frames and
skippable frames, one after another) and refuses a damaged or truncated one
by raising :class:`ZstdError` naming the fault; it returns no partial
content.

:func:`compress` writes one frame of raw and RLE blocks (no entropy
coding: a trainer's weights are near-incompressible floats, and zstd's
literal coding gains them under 8 %), which every zstd decoder reads.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

_ERRLEN = 256
_MAGIC = b"\x28\xb5\x2f\xfd"
_BLOCK = 128 * 1024
#: Window_Descriptor of a 128 KiB window (exponent 17 - 10, mantissa 0):
#: the largest block, and no block refers back past itself
_WINDOW = bytes([(17 - 10) << 3])


class ZstdError(ValueError):
    """The input is not a sequence of whole, valid zstd frames."""


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("zstd_decode")
    lib.citlab_zstd_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int32]
    lib.citlab_zstd_decompress.restype = ctypes.c_int32
    lib.citlab_zstd_free.argtypes = [ctypes.c_void_p]
    lib.citlab_zstd_free.restype = None
    lib.citlab_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.citlab_crc32c.restype = ctypes.c_uint32
    return lib


def decompress(data: bytes) -> bytes:
    """The content of every frame of ``data``, concatenated."""
    data = bytes(data)
    out = ctypes.c_void_p()
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = _lib()
    if lib.citlab_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(n),
                                  err, _ERRLEN):
        raise ZstdError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.citlab_zstd_free(out)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(_lib().citlab_crc32c(data, len(data)))


def compress(data) -> bytes:
    """One RFC 8878 frame holding ``data``: a header with the content size
    and no checksum, then blocks of at most 128 KiB, each RLE where it is
    one repeated byte and raw elsewhere."""
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    n = buf.size
    # Frame_Header_Descriptor: Frame_Content_Size on 2, 4 or 8 bytes (flag
    # 1 stores size - 256), not single-segment, no checksum, no dictionary
    if 256 <= n < 256 + 65536:
        head = bytes([1 << 6]) + _WINDOW + (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        head = bytes([2 << 6]) + _WINDOW + n.to_bytes(4, "little")
    else:
        head = bytes([3 << 6]) + _WINDOW + n.to_bytes(8, "little")
    out = [_MAGIC, head]
    starts = range(0, n, _BLOCK) if n else [0]
    for start in starts:
        block = buf[start:start + _BLOCK]
        last = int(start + _BLOCK >= n)
        size = block.size
        if size > 1 and not (block != block[0]).any():
            out += [(last | 1 << 1 | size << 3).to_bytes(3, "little"), block[:1].tobytes()]
        else:
            out += [(last | size << 3).to_bytes(3, "little"), block.tobytes()]
    return b"".join(out)
