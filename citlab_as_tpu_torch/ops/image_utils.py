"""Image helpers (port of ``citlab_as_tpu/ops/image_utils.py``).

The Otsu pass of :func:`get_binarization` runs on the given device through
``ops/binarize.py::otsu_threshold`` (one host round trip for the 256
counts), and so does :func:`apply_transform` (rect kernels through
``ops/morphology.py``'s windowed max, ellipse / cross through its masked
ops). ``resize_image_ratio`` and :class:`ImageResizer` use the port's
``ops/resize.py::resize_image`` (the JAX package's antialiased linear
weights, as float32 matmuls) on the host; :func:`shape_to_mask` draws with
``utils/draw.py`` (PIL's rasteriser, bit for bit) and
:func:`get_rotation_angle` rotates with ``scipy.ndimage.rotate``, as the
JAX package does.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.ops import morphology
from citlab_as_tpu_torch.ops.binarize import otsu_threshold
from citlab_as_tpu_torch.ops.resize import resize_image


def get_binarization(image, device: DeviceLike = "cuda") -> np.ndarray:
    """Otsu binarization with black=1, white=0 (image_binarizer.py:11-34),
    as an int64 [H, W] array. Accepts an image path or a grey array; the
    Otsu pass runs on ``device``."""
    if isinstance(image, str):
        from citlab_as_tpu_torch.utils.io import load_image
        image = load_image(image, mode="L")
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    _, binary = otsu_threshold(x[None])
    # otsu: foreground (> t) = 255 = white -> invert to black = 1
    return (binary[0] == 0).to(torch.int64).cpu().numpy()


def is_whitespace(binarized_image: np.ndarray, rectangle,
                  threshold: float = 0.05) -> bool:
    """Whitespace test of a rect region of a black=1 binarized image
    (white_space_detection.py:33-53)."""
    crop = binarized_image[rectangle.y:rectangle.y + rectangle.height + 1,
                           rectangle.x:rectangle.x + rectangle.width + 1]
    n = (rectangle.height + 1) * (rectangle.width + 1)
    return float(np.sum(crop)) / n < threshold


def apply_transform(img: np.ndarray, transform_type: Optional[str] = None,
                    kernel_size: Tuple[int, int] = (4, 4),
                    kernel_type: str = "rect", iterations: int = 1,
                    device: DeviceLike = "cuda") -> np.ndarray:
    """Morphological transform dispatcher (morphology.py:5-45, with the
    MORPH_ELLIPSE / MORPH_CROSS kernel types of morphology.py:30): erosion,
    dilation, opening, closing, gradient, tophat or blackhat with a
    (kw, kh) = ``kernel_size`` kernel, ``iterations`` times (at least once),
    on ``device``; the result in ``img``'s dtype."""
    if kernel_type == "rect":
        _erode, _dilate = morphology.erode, morphology.dilate
        _open, _close = morphology.morph_open, morphology.morph_close
    elif kernel_type in ("ellipse", "cross"):
        _erode = partial(morphology.erode_masked, kind=kernel_type)
        _dilate = partial(morphology.dilate_masked, kind=kernel_type)
        _open = partial(morphology.morph_open_masked, kind=kernel_type)
        _close = partial(morphology.morph_close_masked, kind=kernel_type)
    else:
        raise ValueError(f"Unknown kernel_type '{kernel_type}'")
    kw, kh = kernel_size
    dev = resolve_device(device)
    img = np.asarray(img)
    original = torch.as_tensor(np.asarray(img, np.float32)).to(dev)
    x = original
    for _ in range(max(1, iterations)):
        if transform_type == "erosion":
            x = _erode(x, kw, kh)
        elif transform_type == "dilation":
            x = _dilate(x, kw, kh)
        elif transform_type == "opening":
            x = _open(x, kw, kh)
        elif transform_type == "closing":
            x = _close(x, kw, kh)
        elif transform_type == "gradient":
            x = _dilate(x, kw, kh) - _erode(x, kw, kh)
        elif transform_type == "tophat":
            x = original - _open(x, kw, kh)
        elif transform_type == "blackhat":
            x = _close(x, kw, kh) - original
        else:
            raise ValueError(f"Unknown transform_type '{transform_type}'")
    return x.cpu().numpy().astype(img.dtype)


def shape_to_mask(img_shape, points, shape_type: Optional[str] = None,
                  line_width: int = 10, point_size: int = 5,
                  dtype=bool) -> np.ndarray:
    """Rasterize a labeled shape into a binary mask (shape_to_mask.py:6-34):
    circle (centre, point on the rim), rectangle (two corners), line (two
    points) or linestrip, ``line_width`` wide, point (a disc of radius
    ``point_size``), else a polygon (more than 2 points)."""
    from citlab_as_tpu_torch.utils import draw
    mask = draw.new_canvas(int(img_shape[1]), int(img_shape[0]))
    xy = [tuple(p) for p in points]
    if shape_type == "circle":
        assert len(xy) == 2, "circle needs 2 points"
        (cx, cy), (px, py) = xy
        d = math.sqrt((cx - px) ** 2 + (cy - py) ** 2)
        draw.ellipse(mask, [cx - d, cy - d, cx + d, cy + d], fill=1, outline=1)
    elif shape_type == "rectangle":
        assert len(xy) == 2, "rectangle needs 2 points"
        draw.rectangle(mask, xy, fill=1, outline=1)
    elif shape_type in ("line", "linestrip"):
        if shape_type == "line":
            assert len(xy) == 2, "line needs 2 points"
        draw.line(mask, xy, ink=1, width=line_width)
    elif shape_type == "point":
        assert len(xy) == 1, "point needs 1 point"
        cx, cy = xy[0]
        draw.ellipse(mask, [cx - point_size, cy - point_size,
                            cx + point_size, cy + point_size], fill=1, outline=1)
    else:
        assert len(xy) > 2, "polygon needs more than 2 points"
        draw.polygon(mask, xy, ink=1)
    return np.array(mask, dtype=dtype)


def get_rotation_angle(image: np.ndarray, delta: float = 0.1,
                       limit: float = 2.0) -> Tuple[float, float]:
    """Projection-profile deskew (image_stats.py:32-48): the best (score,
    angle) over [-limit, limit] in steps of ``delta``, maximizing the
    squared differences of the horizontal projection histogram."""
    from scipy.ndimage import rotate

    def score_of(angle):
        data = rotate(image, angle, reshape=False, order=0)
        hist = np.sum(data, axis=1)
        return float(np.sum((hist[1:] - hist[:-1]) ** 2))

    angles = np.arange(-limit, limit + delta, delta)
    scores = [score_of(a) for a in angles]
    best = int(np.argmax(scores))
    return scores[best], float(angles[best])


def resize_image_ratio(image: np.ndarray, min_dimension: int = 600,
                       max_dimension: int = 1024,
                       pad_to_max_dimension: bool = False
                       ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Ratio-preserving min/max resize (image_resizer.py:111-168): scale so
    the smaller side reaches ``min_dimension`` unless the larger side would
    exceed ``max_dimension`` (then cap by the larger side); optionally zero
    pad to a ``max_dimension`` square. [H, W] in, float32 out; returns
    (image, (new_h, new_w))."""
    h, w = image.shape[:2]
    small, large = min(h, w), max(h, w)
    scale = min_dimension / small
    if large * scale > max_dimension:
        scale = max_dimension / large
    new_h = int(round(h * scale))
    new_w = int(round(w * scale))
    out = resize_image(torch.from_numpy(np.asarray(image, np.float32)), new_h, new_w).numpy()
    if pad_to_max_dimension:
        padded = np.zeros((max_dimension, max_dimension) + out.shape[2:], out.dtype)
        padded[:new_h, :new_w] = out
        out = padded
    return out, (new_h, new_w)


class ImageResizer:
    """Batch image resizer (image_resizer.py:1-236): holds a list of images
    (paths, read as grey float32, or arrays) and resizes them all by a
    fixed scaling factor or through :func:`resize_image_ratio`, caching
    the former."""

    def __init__(self, images=None, scaling_factor: float = 1.0):
        self._images = []
        if images:
            for image in images:
                self._images.append(self._load(image))
        self.scaling_factor = float(scaling_factor)
        self._resized = None

    @staticmethod
    def _load(image):
        if isinstance(image, str):
            from citlab_as_tpu_torch.utils.io import load_image
            return np.asarray(load_image(image, mode="L"), np.float32)
        return np.asarray(image)

    def add_image(self, image):
        self._images.append(self._load(image))
        self._resized = None

    @property
    def images(self):
        return self._images

    def resize(self):
        """Scale every image by ``scaling_factor`` (rounded sizes)."""
        if self._resized is None:
            out = []
            for image in self._images:
                h = max(1, int(round(image.shape[0] * self.scaling_factor)))
                w = max(1, int(round(image.shape[1] * self.scaling_factor)))
                out.append(resize_image(torch.from_numpy(np.asarray(image, np.float32)),
                                        h, w).numpy())
            self._resized = out
        return self._resized

    def resize_ratio(self, min_dimension: int = 600, max_dimension: int = 1024,
                     pad_to_max_dimension: bool = False):
        """:func:`resize_image_ratio` of every image: (images, true shapes),
        ready for batching into the visual branch."""
        outs, shapes = [], []
        for image in self._images:
            out, shape = resize_image_ratio(image, min_dimension, max_dimension,
                                            pad_to_max_dimension)
            outs.append(out)
            shapes.append(shape)
        return outs, shapes
