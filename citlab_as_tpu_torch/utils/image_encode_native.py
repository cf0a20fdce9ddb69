"""ctypes bindings of the port's host image writer
(``csrc/image_encode.cpp``): Pillow's polygon, line, ellipse and
rectangle drawing, its bilinear resize and libjpeg-turbo's baseline grey
JPEG, each equal bit for bit to PIL 12.1. The drawing calls are bound in ``utils/draw.py``.

The library is built with the host C++ compiler at first use
(``ops/kernels/build.py``); a failed build raises. The calls keep no
state, and ctypes releases the GIL while they run.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

_ERRLEN = 512


@functools.cache
def lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("image_encode")
    i32, vp = ctypes.c_int32, ctypes.c_void_p
    lib.citlab_draw_polygon.argtypes = [vp, i32, i32, vp, i32, i32]
    lib.citlab_draw_polygon.restype = None
    lib.citlab_draw_wide_lines.argtypes = [vp, i32, i32, vp, i32, i32, i32]
    lib.citlab_draw_wide_lines.restype = None
    lib.citlab_draw_lines.argtypes = [vp, i32, i32, vp, i32, i32]
    lib.citlab_draw_lines.restype = None
    for name in ("citlab_draw_ellipse", "citlab_draw_rectangle"):
        getattr(lib, name).argtypes = [vp, i32, i32, vp, i32, i32, i32]
        getattr(lib, name).restype = None
    lib.citlab_resize_bilinear.argtypes = [vp, i32, i32, vp, i32, i32]
    lib.citlab_resize_bilinear.restype = None
    lib.citlab_jpeg_encode_grey.argtypes = [vp, i32, i32, vp, ctypes.c_int64,
                                            ctypes.c_char_p, i32]
    lib.citlab_jpeg_encode_grey.restype = ctypes.c_int64
    return lib


def resize_bilinear(image: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 [H, W] -> uint8 [out_h, out_w]."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 2:
        raise ValueError("resize_bilinear takes a grey [H, W] image")
    if out_w <= 0 or out_h <= 0:
        raise ValueError("output size must be positive")
    h, w = image.shape
    out = np.empty((out_h, out_w), np.uint8)
    lib().citlab_resize_bilinear(image.ctypes.data, w, h, out.ctypes.data, out_w, out_h)
    return out


def jpeg_encode_grey(image: np.ndarray) -> bytes:
    """Baseline JPEG bytes of a uint8 [H, W] image."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 2:
        raise ValueError("jpeg_encode_grey takes a grey [H, W] image")
    h, w = image.shape
    err = ctypes.create_string_buffer(_ERRLEN)
    cap = image.size + 4096
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib().citlab_jpeg_encode_grey(image.ctypes.data, w, h, buf, cap, err, _ERRLEN)
        if n == -1:
            raise ValueError(err.value.decode())
        if n >= 0:
            return buf.raw[:n]
        cap = -n
