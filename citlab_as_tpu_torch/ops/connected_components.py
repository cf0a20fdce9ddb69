"""Connected-component filter on the device (port of
``citlab_as_tpu/ops/connected_components.py``: ``connected_components``,
``_component_sizes``, ``remove_small_components``, ``cc_stats``,
``segment_max_per_component``). The propagation sweep
:func:`propagate_max_step` is the one definition of the reference's
``ops/swt_device.py::_propagate_step_stack``; the per-line component
statistics (``ops/swt_device.py`` here) run on it too.

Batched over [B, H, W]. Same algorithm and the same caps, so results are
bit-exact against the reference even where a cap is hit:

- labeling: label = min row-major index of the 8-connected component,
  reached by iterating {row-run min, column-run min, 3x3 min} to a
  fixpoint, at most 256 iterations;
- sizes per root label, clamped to 32767 (the reference's uint16 field;
  held here in int32 with the same values);
- size propagation: {row-run max, column-run max, 3x3 max} to a fixpoint,
  at most 256 iterations; components of at least ``min_size`` pixels
  survive as 255.

A run's min/max is exact in one step: a segmented prefix scan as one
``cummax`` over packed (run id, value) keys, forward and backward. Each
iteration's convergence test is a host sync (the reference's
``while_loop`` condition), one per iteration.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BG = 1 << 30          # label of background pixels (the min identity)
SIZE_CAP = 32767      # the reference's uint16 size-field clamp
MAX_ITERS = 256


def _shift(x: torch.Tensor, dim: int, fill) -> torch.Tensor:
    """x shifted by +1 along ``dim`` (out[i] = x[i-1]); out[0] = fill."""
    pad = [0, 0] * (x.dim() - dim % x.dim() - 1) + [1, 0]
    return F.pad(x, pad, value=fill).narrow(dim, 0, x.shape[dim])


def _segmented_prefix_max(vals: torch.Tensor, fg: torch.Tensor, dim: int,
                          scale: int) -> torch.Tensor:
    """Prefix max of ``vals`` (0 <= vals < scale) within each foreground run
    along ``dim``: packed key runid * scale + val, whose running max stays
    inside the current run because later runs have larger run ids. ``fg``
    broadcasts against ``vals`` (one mask for a stack of channels). The key
    is int32 where the largest one fits, else int64."""
    start = fg & ~_shift(fg, dim, False)
    max_key = (fg.shape[dim] // 2 + 2) * scale
    kt = torch.int32 if max_key < (1 << 31) else torch.int64
    runid = torch.cumsum(start, dim, dtype=kt)
    key = runid * scale + torch.where(fg, vals.to(kt), 0)
    return torch.cummax(key, dim).values % scale


def _run_max(vals: torch.Tensor, fg: torch.Tensor, dim: int,
             scale: int) -> torch.Tensor:
    fwd = _segmented_prefix_max(vals, fg, dim, scale)
    bwd = _segmented_prefix_max(vals.flip(dim), fg.flip(dim), dim, scale).flip(dim)
    return torch.maximum(fwd, bwd)


def propagate_max_step(vals: torch.Tensor, fg: torch.Tensor,
                       scale: int) -> torch.Tensor:
    """One propagation sweep of per-component maxima: run max along rows,
    run max along columns, 3x3 window max — adjacent foreground pixels are
    one 8-connected component, so iterating this to a fixpoint leaves each
    component's maximum at all of its pixels. ``vals`` [..., H, W] int32 with
    0 <= vals < scale and 0 at background; ``fg`` [..., H, W] bool,
    broadcast over leading channel dimensions of ``vals``."""
    new = vals
    for dim in (-1, -2):
        run = _run_max(new, fg, dim, scale).to(vals.dtype)
        new = torch.where(fg, torch.maximum(new, run), new)
    return torch.where(fg, torch.maximum(new, _window3(new, 0, torch.maximum)),
                       new)


def _run_min_labels(labels: torch.Tensor, fg: torch.Tensor, dim: int,
                    vmax: int) -> torch.Tensor:
    """``_run_min`` of the reference: min label over each fg run, at fg."""
    comp = torch.where(fg, vmax - labels.to(torch.int64), 0)
    run_min = vmax - _run_max(comp, fg, dim, vmax + 1)
    return torch.where(fg, torch.minimum(labels, run_min.to(labels.dtype)),
                       labels)


def _window3(x: torch.Tensor, fill: int, op) -> torch.Tensor:
    """3x3 window reduce over the last two axes, ``fill`` outside."""
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    rows = op(op(p[..., :, :-2], p[..., :, 1:-1]), p[..., :, 2:])
    return op(op(rows[..., :-2, :], rows[..., 1:-1, :]), rows[..., 2:, :])


def connected_components(binary: torch.Tensor, max_iters: int = MAX_ITERS
                         ) -> torch.Tensor:
    """8-connected labeling of [B, H, W] (nonzero = foreground). Returns int32
    [B, H, W]: the min row-major index of each component at its pixels, BG
    at background."""
    fg = binary != 0
    _, h, w = fg.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=fg.device).reshape(h, w)
    labels = torch.where(fg, idx, BG)
    vmax = h * w
    for _ in range(max_iters):
        new = _run_min_labels(labels, fg, -1, vmax)
        new = _run_min_labels(new, fg, -2, vmax)
        new = torch.where(fg, torch.minimum(new, _window3(new, BG, torch.minimum)),
                          new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def _component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """[B, H*W] pixel count per root label (nonzero only at roots)."""
    b, h, w = labels.shape
    n = h * w
    seg = torch.where(labels < BG, labels, n).reshape(b, n).to(torch.int64)
    seg = seg + torch.arange(b, device=labels.device)[:, None] * (n + 1)
    counts = torch.bincount(seg.reshape(-1), minlength=b * (n + 1))
    return counts.reshape(b, n + 1)[:, :n]


def remove_small_components(binary: torch.Tensor, min_size: int = 100
                            ) -> torch.Tensor:
    """Zero out components smaller than ``min_size`` pixels; survivors
    become 255. [B, H, W] in, uint8 [B, H, W] out."""
    labels = connected_components(binary)
    b, h, w = labels.shape
    sizes = _component_sizes(labels).reshape(b, h, w)
    fg = labels < BG
    idx = torch.arange(h * w, dtype=torch.int32, device=fg.device).reshape(h, w)
    isroot = fg & (labels == idx)
    field = torch.where(isroot, torch.clamp(sizes, max=SIZE_CAP), 0).to(torch.int32)
    for _ in range(MAX_ITERS):
        new = propagate_max_step(field, fg, SIZE_CAP + 1)
        changed = bool((new != field).any())
        field = new
        if not changed:
            break
    keep = fg & (field >= min(int(min_size), SIZE_CAP))
    return torch.where(keep, 255, 0).to(torch.uint8)


def cc_stats(binary: torch.Tensor) -> Tuple[np.ndarray, List[Tuple[int, int, int, int, int]]]:
    """Labels of one [H, W] page on its device and per-component (x, y, w,
    h, size): (labels int32 ndarray, BG at background; stats in the order
    of each component's first pixel in row-major order, the order
    cv2.connectedComponentsWithStats finds them)."""
    labels = connected_components(binary[None])[0]
    h, w = labels.shape
    n = h * w
    fg = labels < BG
    seg = torch.where(fg, labels, n).reshape(-1).to(torch.int64)
    yy = torch.arange(h, device=labels.device).repeat_interleave(w)
    xx = torch.arange(w, device=labels.device).repeat(h)
    size = torch.bincount(seg, minlength=n + 1)[:n]

    def reduce(vals, how, init):
        out = torch.full((n + 1,), init, dtype=torch.int64, device=labels.device)
        return out.scatter_reduce(0, seg, vals, how)[:n]
    x0, x1 = reduce(xx, "amin", n), reduce(xx, "amax", -1)
    y0, y1 = reduce(yy, "amin", n), reduce(yy, "amax", -1)
    labels_np = labels.cpu().numpy()
    roots = np.unique(labels_np[labels_np < BG])
    size, x0, y0, x1, y1 = (t.cpu().numpy() for t in (size, x0, y0, x1, y1))
    stats = [(int(x0[r]), int(y0[r]), int(x1[r] - x0[r] + 1), int(y1[r] - y0[r] + 1),
              int(size[r])) for r in roots]
    return labels_np, stats


def segment_max_per_component(labels: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Max of ``values`` [H, W] per component of ``labels`` [H, W] (the
    flat per-root array, [H * W]; a label that is no root holds the dtype's
    lowest value, -inf for floats, as ``jax.ops.segment_max``); per-CC
    stroke width, the max distance-transform value inside the CC."""
    h, w = labels.shape
    n = h * w
    seg = torch.where(labels < BG, labels, n).reshape(-1).to(torch.int64)
    low = (-math.inf if values.dtype.is_floating_point
           else torch.iinfo(values.dtype).min)
    out = torch.full((n + 1,), low, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg, values.reshape(-1), "amax")[:n]
