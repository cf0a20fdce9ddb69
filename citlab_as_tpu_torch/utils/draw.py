"""Drawing on 8-bit grey canvases, equal bit for bit to PIL 12.1's
``ImageDraw`` (the JAX package draws its ground-truth masks with PIL,
``citlab_as_tpu/stages/ground_truth.py::plot_polys_binary``).

- :func:`polygon` is ``ImageDraw.polygon(xy, outline=ink, fill=ink)``: the
  float vertices are truncated to int, then Pillow's scan-line fill runs
  with its corner rules, horizontal edges drawn as spans.
- :func:`line` is ``ImageDraw.line(xy, fill=ink, width=width)``: for
  ``width`` > 1 every segment is a wide-line quad, with no joints, and a
  zero-length segment sets one pixel; width 1 is Pillow's Bresenham per
  segment (the end point left to the next segment) and then the last
  point.
- :func:`ellipse` and :func:`rectangle` are ``ImageDraw.ellipse`` /
  ``ImageDraw.rectangle(xy, fill=, outline=, width=)``: the box's float
  corners are truncated to int; a fill, then an outline ``width`` pixels
  wide where its ink differs from the fill's.

All of them run in the port's host C++ library (``csrc/image_encode.cpp``, loaded
by ``utils/image_encode_native.py``) and draw in place on a C-contiguous
uint8 [H, W] array.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    """Draw the polyline through ``points``, ``width`` pixels wide (PIL
    draws width 0 as width 1)."""
    if len(points) < 2:
        return
    data, w, h, xy, n = _args(canvas, points)
    if width <= 1:
        image_encode_native.lib().citlab_draw_lines(data, w, h, xy.ctypes.data, n, ink)
    else:
        image_encode_native.lib().citlab_draw_wide_lines(data, w, h, xy.ctypes.data, n,
                                                         ink, width)


def _box(canvas: np.ndarray, box) -> Tuple:
    """PIL's checks of a bounding box; the args of the C calls."""
    data, w, h, xy, _ = _args(canvas, np.reshape(np.asarray(box, np.float64), (2, 2)))
    if xy[1, 0] < xy[0, 0]:
        raise ValueError("x1 must be greater than or equal to x0")
    if xy[1, 1] < xy[0, 1]:
        raise ValueError("y1 must be greater than or equal to y0")
    return data, w, h, xy


def _shape(fn_name: str, canvas, box, fill, outline, width) -> None:
    data, w, h, xy = _box(canvas, box)
    fn = getattr(image_encode_native.lib(), fn_name)
    if fill is not None:
        fn(data, w, h, xy.ctypes.data, fill, 1, 0)
    if outline is not None and outline != fill and width != 0:
        fn(data, w, h, xy.ctypes.data, outline, 0, width)


def ellipse(canvas: np.ndarray, box, fill: Optional[int] = None,
            outline: Optional[int] = None, width: int = 1) -> None:
    """The ellipse inside ``box`` = (x0, y0, x1, y1) (or [(x0, y0), (x1,
    y1)]), filled with ``fill`` and/or outlined with ``outline``."""
    _shape("citlab_draw_ellipse", canvas, box, fill, outline, width)


def rectangle(canvas: np.ndarray, box, fill: Optional[int] = None,
              outline: Optional[int] = None, width: int = 1) -> None:
    """The rectangle ``box`` = (x0, y0, x1, y1) (or [(x0, y0), (x1, y1)]),
    corners included, filled with ``fill`` and/or outlined with
    ``outline``."""
    _shape("citlab_draw_rectangle", canvas, box, fill, outline, width)
