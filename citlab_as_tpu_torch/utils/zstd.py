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
"""
from __future__ import annotations

import ctypes
import functools

_ERRLEN = 256


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
