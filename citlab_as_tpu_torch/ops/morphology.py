"""Grayscale morphology (port of ``citlab_as_tpu/ops/morphology.py``): rect
kernels (``erode`` / ``dilate`` / ``morph_open`` / ``morph_close``) and the
ellipse / cross structuring elements of ``structuring_element`` (the
``*_masked`` ops, which ``ops/image_utils.py::apply_transform`` reaches).

cv2 border rules, as the reference: the kernel is anchored at k//2, so a
window covers [i - k//2, i - k//2 + k - 1]; erosion pads with +inf and
dilation with -inf (positions outside the image never win). The windows
are ``F.max_pool2d`` over explicitly padded inputs, on the last two axes
of a float tensor (leading axes are batch). A masked op folds min / max
over one shifted view of the padded input per active offset of the
element, as the reference's shifted slices.
"""
from __future__ import annotations

import math

import numpy as np
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


def morph_close(image: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Closing = dilate then erode."""
    return erode(dilate(image, kw, kh), kw, kh)


def structuring_element(kind: str, kw: int, kh: int) -> np.ndarray:
    """cv2.getStructuringElement twin: a (kh, kw) uint8 mask for kind
    'rect' | 'ellipse' | 'cross', anchored at (kh//2, kw//2). The ellipse is
    cv2's row scan: per row the half-width is
    ``round_half_even(c * sqrt((r^2 - dy^2) / r^2))`` with r = kh//2,
    c = kw//2; the cross is the anchor row plus the anchor column."""
    if kind == "rect" or (kw == 1 and kh == 1):
        return np.ones((kh, kw), np.uint8)
    mask = np.zeros((kh, kw), np.uint8)
    ax, ay = kw // 2, kh // 2
    if kind == "cross":
        mask[ay, :] = 1
        mask[:, ax] = 1
        return mask
    if kind != "ellipse":
        raise ValueError(f"Unknown structuring-element kind '{kind}'")
    r, c = kh // 2, kw // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(kh):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
        j1, j2 = max(c - dx, 0), min(c + dx + 1, kw)
        mask[i, j1:j2] = 1
    return mask


def _masked_reduce(image: torch.Tensor, kind: str, kw: int, kh: int, op,
                   fill: float) -> torch.Tensor:
    """min / max (``op``) over the active offsets of a structuring element,
    one shifted view of the ``fill``-padded image per offset; the cv2
    anchor of :func:`_window_max`."""
    mask = structuring_element(kind, kw, kh)
    x = image.to(torch.float32)
    h, w = x.shape[-2:]
    padded = F.pad(x.reshape((-1, 1) + x.shape[-2:]),
                   (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
                   value=fill).reshape(x.shape[:-2] + (h + kh - 1, w + kw - 1))
    out = None
    for i, j in np.argwhere(mask):
        window = padded[..., int(i):int(i) + h, int(j):int(j) + w]
        out = window if out is None else op(out, window)
    return out


def erode_masked(image: torch.Tensor, kw: int, kh: int,
                 kind: str = "ellipse") -> torch.Tensor:
    """Erosion with an ellipse / cross structuring element (cv2.erode
    parity; morphology.py:30 MORPH_ELLIPSE / MORPH_CROSS)."""
    return _masked_reduce(image, kind, kw, kh, torch.minimum, math.inf)


def dilate_masked(image: torch.Tensor, kw: int, kh: int,
                  kind: str = "ellipse") -> torch.Tensor:
    return _masked_reduce(image, kind, kw, kh, torch.maximum, -math.inf)


def morph_open_masked(image: torch.Tensor, kw: int, kh: int,
                      kind: str = "ellipse") -> torch.Tensor:
    return dilate_masked(erode_masked(image, kw, kh, kind), kw, kh, kind)


def morph_close_masked(image: torch.Tensor, kw: int, kh: int,
                       kind: str = "ellipse") -> torch.Tensor:
    return erode_masked(dilate_masked(image, kw, kh, kind), kw, kh, kind)
