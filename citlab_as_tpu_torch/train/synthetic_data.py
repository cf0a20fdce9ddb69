"""Synthetic newspaper-page generator for segmentation training, on the
device (port of ``citlab_as_tpu/train/synthetic_data.py``).

Newspaper-like pages (text-line bands in columns, thin horizontal/vertical
separator rules, scan noise) with labels per the separator-net contract
(channel 0 = separator, channel 1 = other) or the heading-net contract
(channel 0 = heading text).

jax's threefry numbers cannot be drawn in PyTorch, so the module is split
in two: :func:`page_draws` makes a batch's random scalars and low-resolution
noise fields from an explicit ``torch.Generator``, and
:func:`compose_pages` turns draws into pages with the JAX function's
expressions. Fed the draws the JAX function makes from its key, the
composition gives the JAX pages bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

WORDS_SCALE, NOISE_SCALE = 6, 2
_F32_008 = 0.07999999821186066          # float32(0.08), exactly


def _low_shape(h: int, w: int, scale: int):
    return max(1, -(-h // scale)), max(1, -(-w // scale))


def page_draws(generator: torch.Generator, batch: int, h: int, w: int,
               device=None) -> Dict[str, torch.Tensor]:
    """The random inputs of ``batch`` pages: per page the column rule
    (``col_x`` in [0.3w, 0.7w), ``col_w`` in [2, 5), ``v_y0`` in [0, h/4),
    ``v_y1`` in [3h/4, h)), three horizontal rules (``rule_y`` in [0.1h,
    0.9h), ``rule_thick`` in [2, 4), ``rule_left`` a fair coin),
    ``line_spacing`` in [18, 30), the heading band (``head_y`` in [0.1h,
    0.8h), ``head_h`` in [24, 40)), and uniform [0, 1) fields for the word
    mask (``words_low``, 1/6 resolution) and the scan noise (``noise_low``,
    1/2). ``generator`` lives on ``device``."""
    def randint(lo, hi, shape=()):
        return torch.randint(lo, hi, (batch,) + shape, generator=generator,
                             device=device, dtype=torch.int32)

    return {
        "col_x": randint(int(0.3 * w), int(0.7 * w)),
        "col_w": randint(2, 5),
        "v_y0": randint(0, h // 4),
        "v_y1": randint(3 * h // 4, h),
        "rule_y": randint(int(0.1 * h), int(0.9 * h), (3,)),
        "rule_thick": randint(2, 4, (3,)),
        "rule_left": randint(0, 2, (3,)).bool(),
        "line_spacing": randint(18, 30),
        "words_low": torch.rand((batch,) + _low_shape(h, w, WORDS_SCALE),
                                generator=generator, device=device),
        "head_y": randint(int(0.1 * h), int(0.8 * h)),
        "head_h": randint(24, 40),
        "noise_low": torch.rand((batch,) + _low_shape(h, w, NOISE_SCALE),
                                generator=generator, device=device),
    }


def _upsample(low: torch.Tensor, scale: int, h: int, w: int) -> torch.Tensor:
    """Block upsampling of [B, lh, lw] by ``scale``, cropped to h x w."""
    up = low.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
    return up[:, :h, :w]


def compose_pages(draws: Dict[str, torch.Tensor], h: int, w: int,
                  heading_mode: bool = False):
    """(image [B,H,W,1] float32 in [0,1], label [B,H,W] int32
    {0=target,1=other}) from :func:`page_draws`' dict."""
    d = {k: (v[:, None, None] if v.dim() == 1 else v) for k, v in draws.items()}
    dev = d["col_x"].device
    yy = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    col_x, col_w = d["col_x"], d["col_w"]

    # ---- columns: one vertical separator at a random x
    v_sep = ((xx - col_x).abs() < col_w) & (yy >= d["v_y0"]) & (yy < d["v_y1"])

    # ---- horizontal separators: 3 rules at random ys inside a column
    h_sep = torch.zeros((1, 1, 1), dtype=torch.bool, device=dev)
    for i in range(3):
        y = d["rule_y"][:, i, None, None]
        thick = d["rule_thick"][:, i, None, None]
        left = d["rule_left"][:, i, None, None]
        x_lo = torch.where(left, torch.full_like(col_x, 10), col_x + col_w + 5)
        x_hi = torch.where(left, col_x - col_w - 5, torch.full_like(col_x, w - 10))
        h_sep = h_sep | (((yy - y).abs() < thick) & (xx >= x_lo) & (xx < x_hi))

    sep = v_sep | h_sep

    # ---- text: line bands with blobby word masks, margins at borders
    line_spacing = d["line_spacing"]
    text_height = torch.div(line_spacing * 3, 5, rounding_mode="floor")
    band = torch.remainder(yy, line_spacing) < text_height
    words = _upsample(d["words_low"], WORDS_SCALE, h, w) > 0.45
    margin = ((xx > 8) & (xx < w - 8) & (yy > 8) & (yy < h - 8)
              & ((xx - col_x).abs() > col_w + 3))
    text = band & words & margin & ~sep

    # ---- heading text: a thicker, taller band near a horizontal rule
    heading_zone = (yy >= d["head_y"]) & (yy < d["head_y"] + d["head_h"])
    heading = heading_zone & words & margin & ~sep

    # ---- compose grayscale image in [0, 1]
    # noise = up * 0.08; text 0.25 + 2 * noise, heading 0.1, separator 0.15,
    # all minus noise. Rounded as the JAX function's compiled code rounds
    # them: it folds (up * 0.08) * 2 into up * 0.16 and fuses both
    # multiply-adds (one rounding each). In float64 the float32 products and
    # these sums are exact, so rounding them to float32 gives the fused
    # results.
    up = _upsample(d["noise_low"], NOISE_SCALE, h, w).double()
    img = torch.ones(up.shape, dtype=torch.float32, device=dev)
    img = torch.where(text, (0.25 + up * (2 * _F32_008)).float(), img)
    img = torch.where(heading, torch.full_like(img, 0.1), img)
    img = torch.where(sep, torch.full_like(img, 0.15), img)
    img = (img.double() - up * _F32_008).float()

    target = heading if heading_mode else sep
    label = torch.where(target, 0, 1).to(torch.int32)
    return img[..., None], label


def synthetic_batch(generator: torch.Generator, batch: int, h: int, w: int,
                    heading_mode: bool = False, device: Optional[torch.device] = None):
    """(image [B,H,W,1] in [0,1], label [B,H,W] int {0=target,1=other}) on
    ``device`` (the generator's)."""
    return compose_pages(page_draws(generator, batch, h, w, device), h, w,
                         heading_mode)
