"""Image helpers (port of ``citlab_as_tpu/ops/image_utils.py``:
``get_binarization``, ``is_whitespace`` and ``resize_image_ratio``).

The Otsu pass of :func:`get_binarization` runs on the given device through
``ops/binarize.py::otsu_threshold`` (one host round trip for the 256
counts); ``resize_image_ratio`` is the port's ``ops/resize.py::resize_image``
(the JAX package's antialiased linear weights, as float32 matmuls), run on
the host, for the visual relation GNN's page input. Not ported:
``apply_transform`` and the reference's other morphology wrappers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
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
