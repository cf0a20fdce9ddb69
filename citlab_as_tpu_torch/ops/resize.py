"""Image scaling (port of ``citlab_as_tpu/ops/resize.py``).

``jax.image.resize(method="linear", antialias=True)`` is a separable
resampling: one weight matrix per axis from ``compute_weight_mat``
(jax/_src/image/scale.py) — a triangle kernel scaled by max(1/scale, 1),
normalised per output sample, zeroed where the sample lies outside the
input — applied as two float32 contractions, the width axis first. It is
not ``F.interpolate(antialias=True)``, whose filter differs, so the matrices
are built here with the same float32 arithmetic and applied as matmuls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def get_scaling_factor(image_height: int, image_width: int,
                       scaling_factor: Optional[float],
                       fixed_height: Optional[int] = None,
                       fixed_width: Optional[int] = None) -> float:
    """Scaling factor from fixed target dims and/or a plain factor: a fixed
    dim combined with a factor > 0.1 multiplies; otherwise the fixed dim or
    bare factor wins."""
    if fixed_height is not None and scaling_factor is not None and 0.1 < scaling_factor:
        return scaling_factor * fixed_height / image_height
    if fixed_width is not None and scaling_factor is not None and 0.1 < scaling_factor:
        return scaling_factor * fixed_width / image_width
    if fixed_height:
        return fixed_height / image_height
    if fixed_width:
        return fixed_width / image_width
    return scaling_factor if scaling_factor else 1.0


def linear_weight_matrix(input_size: int, output_size: int,
                         device=None) -> torch.Tensor:
    """[input_size, output_size] float32 antialiased triangle weights,
    the same arithmetic as jax's ``compute_weight_mat``."""
    inv_scale = 1.0 / (output_size / input_size)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32)
    inv = torch.tensor(inv_scale, dtype=torch.float32)
    sample_f = ((torch.arange(output_size, dtype=torch.float32) + 0.5) * inv
                - 0.5)
    x = (torch.abs(sample_f[None, :]
                   - torch.arange(input_size, dtype=torch.float32)[:, None])
         / kernel_scale)
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        torch.abs(total) > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def resize_image(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of [..., H, W] to (out_h, out_w); float32."""
    x = image.to(torch.float32)
    h, w = x.shape[-2:]
    if w != out_w:
        x = torch.matmul(x, linear_weight_matrix(w, out_w, x.device))
    if h != out_h:
        x = torch.matmul(linear_weight_matrix(h, out_h, x.device).T, x)
    return x


def scale_image(image: torch.Tensor, fixed_height: Optional[int] = None,
                scaling_factor: Optional[float] = 1.0
                ) -> Tuple[torch.Tensor, float]:
    """Scale an [H, W] image by the factor derived from ``fixed_height`` /
    ``scaling_factor``. No-op (float32 copy) when the factor is 1."""
    h, w = image.shape[:2]
    sc = get_scaling_factor(h, w, scaling_factor, fixed_height=fixed_height)
    if sc == 1.0:
        return image.to(torch.float32), sc
    return resize_image(image, int(h * sc), int(w * sc)), sc
