"""Drawing on 8-bit grey canvases, equal bit for bit to PIL 12.1's
``ImageDraw`` (the JAX package draws its ground-truth masks with PIL,
``citlab_as_tpu/stages/ground_truth.py::plot_polys_binary``).

- :func:`polygon` is ``ImageDraw.polygon(xy, outline=ink, fill=ink)``: the
  float vertices are truncated to int, then Pillow's scan-line fill runs
  with its corner rules, horizontal edges drawn as spans.
- :func:`line` is ``ImageDraw.line(xy, fill=ink, width=width)`` for
  ``width`` > 1: every segment is a wide-line quad, with no joints; a
  zero-length segment sets one pixel.

Both run in the port's host C++ library (``csrc/image_encode.cpp``, loaded
by ``utils/image_encode_native.py``) and draw in place on a C-contiguous
uint8 [H, W] array.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.utils import image_encode_native

Point = Tuple[float, float]


def new_canvas(width: int, height: int) -> np.ndarray:
    """``Image.new("L", (width, height), 0)`` as a uint8 [H, W] array."""
    return np.zeros((height, width), np.uint8)


def _args(canvas: np.ndarray, points: Sequence[Point]):
    if canvas.dtype != np.uint8 or canvas.ndim != 2 or not canvas.flags.c_contiguous:
        raise ValueError("canvas must be a C-contiguous uint8 [H, W] array")
    xy = np.ascontiguousarray(points, np.float64)
    if xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError("points must be an [N, 2] array")
    h, w = canvas.shape
    return canvas.ctypes.data, w, h, xy, len(xy)


def polygon(canvas: np.ndarray, points: Sequence[Point], ink: int = 255) -> None:
    """Fill the polygon through ``points`` (closed implicitly); PIL refuses
    fewer than two points, and so does this."""
    if len(points) < 2:
        raise ValueError("a polygon needs at least 2 points")
    data, w, h, xy, n = _args(canvas, points)
    image_encode_native.lib().citlab_draw_polygon(data, w, h, xy.ctypes.data, n, ink)


def line(canvas: np.ndarray, points: Sequence[Point], ink: int = 255,
         width: int = 7) -> None:
    """Draw the polyline through ``points``, ``width`` (> 1) pixels wide."""
    if width < 2:
        raise ValueError("line draws lines of width 2 or more")
    if len(points) < 2:
        return
    data, w, h, xy, n = _args(canvas, points)
    image_encode_native.lib().citlab_draw_wide_lines(data, w, h, xy.ctypes.data, n, ink,
                                                     width)
