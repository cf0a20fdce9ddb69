"""Image helpers (port of ``citlab_as_tpu/ops/image_utils.py``:
``resize_image_ratio`` only, for the visual relation GNN's page input).

The resize is the port's ``ops/resize.py::resize_image`` (the JAX
package's antialiased linear weights, as float32 matmuls), run on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from citlab_as_tpu_torch.ops.resize import resize_image


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
