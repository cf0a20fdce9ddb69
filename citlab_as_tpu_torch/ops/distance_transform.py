"""Euclidean distance transform on the device via jump flooding (port of
``citlab_as_tpu/ops/distance_transform.py``).

For every non-zero pixel, the L2 distance to the nearest zero pixel
(cv2.distanceTransform(DIST_L2, DIST_MASK_PRECISE)). Jump flooding
propagates nearest-seed coordinates in O(log max(H, W)) fully parallel
steps of 9 shifted candidates each; the 1+JFA variant (an extra step at
offset 1) removes almost all of plain JFA's rare off-by-small errors.

Batched over pages [B, H, W]. Same packed seed, same step list and same
candidate order as the JAX function, so ties between seeds resolve alike;
``dy*dy + dx*dx`` is an exact integer in float32 and float32 ``sqrt`` is
correctly rounded, so the result is the JAX function's bit for bit.
"""
from __future__ import annotations

from typing import List

import torch

_NOSEED = 0x7FFFFFFF      # "no seed known yet" in the packed (y << 16 | x) field


def _shift2d(arr: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[..., y, x] = arr[..., y - dy, x - dx], ``fill`` where that lies
    outside (a shift of a whole axis length or more leaves only ``fill``)."""
    h, w = arr.shape[-2:]
    out = torch.full_like(arr, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    ys_dst = slice(max(dy, 0), h + min(dy, 0))
    ys_src = slice(max(-dy, 0), h + min(-dy, 0))
    xs_dst = slice(max(dx, 0), w + min(dx, 0))
    xs_src = slice(max(-dx, 0), w + min(-dx, 0))
    out[..., ys_dst, xs_dst] = arr[..., ys_src, xs_src]
    return out


def jfa_steps(h: int, w: int, cap: float = 0.0) -> List[int]:
    """The step series: pow2ceil(max(h, w)) (with ``cap`` > 0 at most
    pow2ceil(cap + 1): seeds farther than cap + 1 never matter, and the
    series k, k/2, ..., 1 reaches any seed within 2k - 1) halved down to 1,
    then 1 once more."""
    k = 1
    while k < max(h, w):
        k <<= 1
    if cap > 0:
        limit = 1
        while limit < cap + 1:
            limit <<= 1
        k = min(k, limit)
    steps = []
    while k >= 1:
        steps.append(k)
        k >>= 1
    steps.append(1)
    return steps


@torch.no_grad()
def distance_transform_edt(binary: torch.Tensor, cap: float = 0.0) -> torch.Tensor:
    """L2 distance of each non-zero pixel to the nearest zero pixel.

    ``binary``: [B, H, W], zero = seed/background. Returns float32 distances
    (0 at seeds). ``cap`` > 0 clips the output (pixels with no seed in reach
    report inf, clipped to ``cap``)."""
    fg = binary != 0
    h, w = fg.shape[-2:]
    assert h < (1 << 15) and w < (1 << 16), "packed-seed JFA needs h<32768"
    dev = fg.device
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    seed = torch.where(fg, _NOSEED, (yy << 16) | xx)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)

    def dist2(p):
        dy = ((p >> 16) - yy).to(torch.float32)
        dx = ((p & 0xFFFF) - xx).to(torch.float32)
        return torch.where(p == _NOSEED, inf, dy * dy + dx * dx)

    for step in jfa_steps(h, w, cap):
        best_d = dist2(seed)
        # the three row-shifted fields are made once; the diagonal
        # candidates reuse them with a column shift
        rows = {0: seed,
                1: _shift2d(seed, step, 0, _NOSEED),
                -1: _shift2d(seed, -step, 0, _NOSEED)}
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                cand = (rows[dy] if dx == 0
                        else _shift2d(rows[dy], 0, dx * step, _NOSEED))
                cd = dist2(cand)
                better = cd < best_d
                seed = torch.where(better, cand, seed)
                best_d = torch.where(better, cd, best_d)

    dist = torch.sqrt(dist2(seed))
    dist = torch.where(fg, dist, 0.0)
    if cap > 0:
        dist = torch.clamp(dist, max=cap)
    return dist
