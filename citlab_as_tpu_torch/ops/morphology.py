"""Rect-kernel grayscale morphology (port of ``citlab_as_tpu/ops/morphology.py``
``erode`` / ``dilate`` / ``morph_open``).

cv2 border rules, as the reference: the kernel is anchored at k//2, so a
window covers [i - k//2, i - k//2 + k - 1]; erosion pads with +inf and
dilation with -inf (positions outside the image never win). The windows
are ``F.max_pool2d`` over explicitly padded inputs, on the last two axes
of a float tensor (leading axes are batch).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window_max(image: torch.Tensor, kw: int, kh: int, pad_value: float
                ) -> torch.Tensor:
    x = image.to(torch.float32)
    lead_shape = x.shape[:-2]
    x = x.reshape((-1, 1) + x.shape[-2:])
    x = F.pad(x, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
              value=pad_value)
    y = F.max_pool2d(x, (kh, kw), stride=1)
    return y.reshape(lead_shape + y.shape[-2:])


def erode(image: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Erosion with a (kw x kh) rect kernel (cv2 width-first order)."""
    return -_window_max(-image.to(torch.float32), kw, kh, -math.inf)


def dilate(image: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    return _window_max(image, kw, kh, -math.inf)


def morph_open(image: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Opening = erode then dilate; removes runs shorter than the kernel."""
    return dilate(erode(image, kw, kh), kw, kh)
