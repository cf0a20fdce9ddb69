"""Device-resident SWT feature extraction for the heading stage (port of the
default path of ``citlab_as_tpu/ops/swt_device.py``).

Per page, a full-resolution stroke-width distance transform (invert ->
Gaussian+Otsu -> capped EDT); per text line a crop of that DT image is
connected-component labeled and cleaned, yielding ``stroke_width`` (median
of per-CC max DT) and ``text_height`` (max CC height); plus the mean net
probability over the (rescaled) line bbox. The whole chain runs on the
device and only ``[n_lines, 3]`` integers per page are read back.

Formulation:
- per-line crops: indexed out of the zero-padded DT into a static
  [crop_h, crop_w] bucket, masked to the true bbox (numpy-slice clip
  semantics), batched over a padded line bucket, in chunks of lines;
- per-crop CC stats without scatters or sorts: 8-adjacent foreground pixels
  are by definition the same component, so per-component aggregates are the
  fixpoint of {run max along rows, along columns, 3x3 window max}. Four
  channels propagate together as one max stack: min flat index (the
  label/root, riding as ``h*w - index``), max x, max (W-1-x), max y; min y
  falls out of the root index;
- the fixpoint loop is a Python loop with one host sync per sweep (the
  convergence test); ``COUNTS`` tallies sweeps and syncs;
- per-CC median: component maxima live at root pixels only; DT is uint8, so
  the median is an 8-step binary search over counts;
- net probability: exact integer sums from a summed-area table.

The stack is carried in int32 (the JAX package carries uint16 where the
crop allows it): values, not dtypes, are the contract, and one function
covers crops of every size.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from citlab_as_tpu_torch.ops.connected_components import propagate_max_step

_BG = 1 << 30             # label of background pixels
_STATS_CHUNK = 64         # crops per fixpoint: bounds the working set

# tallies of the component fixpoints since the last reset: sweeps run, and
# host syncs taken (one convergence test per sweep)
COUNTS: Dict[str, int] = {"sweeps": 0, "syncs": 0}


def reset_counts() -> None:
    COUNTS["sweeps"] = 0
    COUNTS["syncs"] = 0


def _fixpoint(stack: torch.Tensor, fg: torch.Tensor, scale: int,
              max_iters: int) -> torch.Tensor:
    """Iterate the sweep over a [C, L, H, W] max stack (each run's exact max
    along rows, along columns, then the 3x3 window) until nothing changes.
    ``max_iters`` is a pure safety net: each non-converged sweep advances
    every front >= 1 px along its 8-connected path and no path exceeds h*w."""
    for _ in range(max_iters):
        new = propagate_max_step(stack, fg[None], scale)
        COUNTS["sweeps"] += 1
        COUNTS["syncs"] += 1
        changed = bool((new != stack).any())
        stack = new
        if not changed:
            break
    return stack


def _grids(l: int, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.int32, device=device)[None, :, None].expand(l, h, w)
    xx = torch.arange(w, dtype=torch.int32, device=device)[None, None, :].expand(l, h, w)
    return yy, xx


@torch.no_grad()
def component_stats(crops_dt: torch.Tensor, fg: torch.Tensor,
                    max_iters: int = 0):
    """Per-pixel per-component aggregates for a stack of crops (the JAX
    package's ``component_stats_u16`` and ``component_stats`` in one).

    ``crops_dt``: [L, H, W] DT values; ``fg``: [L, H, W] bool. Returns
    (lab, mxx, mnx, mxy), int32 [L, H, W]: min flat index per component
    (``_BG`` at background) and the component's max x / min x / max y at
    every foreground pixel (0 / W-1 / 0 at background)."""
    l, h, w = crops_dt.shape
    if not max_iters:
        max_iters = h * w
    yy, xx = _grids(l, h, w, crops_dt.device)
    flat = yy * w + xx
    stack = torch.stack([
        torch.where(fg, h * w - flat, 0),        # max -> min flat index
        torch.where(fg, xx, 0),                  # max x
        torch.where(fg, w - 1 - xx, 0),          # max (w-1-x) -> min x
        torch.where(fg, yy, 0),                  # max y
    ]).to(torch.int32)
    stack = _fixpoint(stack, fg, h * w + 1, max_iters)
    lab = torch.where(fg, h * w - stack[0], _BG)
    return lab, stack[1], w - 1 - stack[2], stack[3]


def _bbox_max(crops: torch.Tensor, fg: torch.Tensor, mny: torch.Tensor,
              mxy: torch.Tensor) -> torch.Tensor:
    """Max DT over each component's BOUNDING BOX (not the component itself:
    the reference reads np.max over the bbox crop, so pixels of overlapping
    neighbour components count too).

    1. every column x in [x0..x1] of an 8-connected component contains at
       least one of its pixels (x changes by <= 1 along any connecting path);
    2. so rect-max = component-max of C[p] := max dt over column x_p, rows
       [y0..y1] — and C comes from sweeping the crop's rows once, each row
       broadcast against the per-pixel converged [y0, y1] fields;
    3. C then propagates to the root by one more (single-channel) fixpoint.
    """
    l, h, w = crops.shape
    crops = crops.to(torch.int32)
    acc = torch.zeros_like(crops)                 # 0 = max identity (dt>0 at fg)
    for y in range(h):
        row = crops[:, y:y + 1, :]                # [L, 1, W] -> bcast over rows
        in_range = (mny <= y) & (mxy >= y)
        acc = torch.maximum(acc, torch.where(in_range, row, 0))
    r = torch.where(fg, acc, 0)[None]
    return _fixpoint(r, fg, 256, h * w)[0]


@torch.no_grad()
def _line_stats_from_crops(crops: torch.Tensor, clean_ccs: int) -> torch.Tensor:
    """[L, crop_h, crop_w] DT crops -> [L, 2] int32 (2 * stroke width, text
    height). Twice the stroke width is the sum of the two middle order
    statistics: an exact integer."""
    crops = crops.to(torch.int32)
    fg = crops > 0
    l, crop_h, crop_w = crops.shape
    lab, mxx, mnx, mxy = component_stats(crops, fg)
    mny = torch.div(lab, crop_w, rounding_mode="floor")   # root = min row-major index
    mdt = _bbox_max(crops, fg, mny, mxy)          # max over the CC bbox

    ch = mxy - mny + 1
    cw = mxx - mnx + 1
    kept = fg
    if clean_ccs > 0:
        kept = kept & (cw >= 3) & (ch >= 3) & (ch <= 500) & (cw <= 500)
    if clean_ccs > 1:
        kept = kept & (cw <= 8 * ch) & (ch <= 8 * cw)

    yy, xx = _grids(l, crop_h, crop_w, crops.device)
    isroot = kept & (lab == yy * crop_w + xx)

    text_height = torch.where(isroot, ch, 0).amax(dim=(1, 2))
    k = isroot.sum(dim=(1, 2), dtype=torch.int32)

    # median of root DT maxima: the m-th order statistic is
    # min{t: #(vals <= t) > m}, an 8-step binary search per crop
    root_vals = torch.where(isroot, mdt, 1 << 20).reshape(l, -1)
    m1 = torch.div(torch.clamp(k - 1, min=0), 2, rounding_mode="floor")
    m2 = torch.div(k, 2, rounding_mode="floor")

    def order_stat(m):
        lo = torch.zeros(l, dtype=torch.int32, device=crops.device)
        hi = torch.full((l,), 255, dtype=torch.int32, device=crops.device)
        for _ in range(8):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            n_le = (root_vals <= mid[:, None]).sum(dim=1, dtype=torch.int32)
            go_right = n_le <= m
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        return lo

    stroke2 = torch.where(k > 0, order_stat(m1) + order_stat(m2), 0)
    return torch.stack([stroke2, text_height], dim=1).to(torch.int32)


def _take_crops(padded: torch.Tensor, pages: torch.Tensor, boxes: torch.Tensor,
                rr: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """[n, crop_h, crop_w] crops of the zero-padded pages starting at each
    box's (x, y); a box that starts beyond the padding reads zeros."""
    hp, wp = padded.shape[1:]
    ys = torch.clamp(boxes[:, 1][:, None, None] + rr, 0, hp - 1)
    xs = torch.clamp(boxes[:, 0][:, None, None] + cc, 0, wp - 1)
    return padded[pages[:, None, None], ys, xs]


@torch.no_grad()
def swt_line_stats_batch_gather2(dt_u8: torch.Tensor, boxes: torch.Tensor,
                                 crop_h: int, crop_w: int, clean_ccs: int = 2,
                                 boxes_host: Optional[np.ndarray] = None
                                 ) -> torch.Tensor:
    """[B, H, W] uint8 DT + [B, L, 4] int32 (x, y, w, h) boxes -> [B, L, 2]
    int32 (2 * stroke width, text height). The crop of a line is
    ``dt[y:y+h+1, x:x+w+1]``, zero beyond the bbox and beyond the image, and
    needs h+1 <= crop_h, w+1 <= crop_w (the caller picks the bucket). Crops
    are taken by index out of the padded pages (the JAX function selects
    the same bytes with a one-hot product) and stream through the component
    fixpoint in chunks of ``_STATS_CHUNK`` lines, each converging on its own.

    Each chunk shrinks the bucket to its own largest line, rounded up like
    the bucket itself: beyond a line's bbox a crop holds zeros, so the
    result is the same and the fixpoint moves fewer bytes where a few long
    or tall lines set the bucket for a page of short ones. ``boxes_host``
    (the same boxes as a numpy array) saves the readback of the boxes."""
    b, l = boxes.shape[:2]
    padded = F.pad(dt_u8, (0, crop_w, 0, crop_h))
    boxes_flat = boxes.reshape(b * l, 4).to(torch.int64)
    pages = torch.arange(b * l, device=boxes.device) // l
    rows = torch.arange(crop_h, device=boxes.device)[None, :, None]
    cols = torch.arange(crop_w, device=boxes.device)[None, None, :]
    if boxes_host is None:
        boxes_host = boxes.cpu().numpy()
    sizes = boxes_host.reshape(b * l, 4)[:, 2:]
    outs = []
    chunk = _STATS_CHUNK
    for s in range(0, b * l, chunk):
        eb = boxes_flat[s:s + chunk]
        ch = min(crop_h, _round_up(int(sizes[s:s + chunk, 1].max(initial=0)) + 1, 16, floor=32))
        cw = min(crop_w, _round_up(int(sizes[s:s + chunk, 0].max(initial=0)) + 1, 128, floor=256))
        rr, cc = rows[:, :ch], cols[:, :, :cw]
        crops = _take_crops(padded, pages[s:s + chunk], eb, rr, cc)
        valid = ((rr <= eb[:, 3][:, None, None])      # inclusive crop:
                 & (cc <= eb[:, 2][:, None, None]))   # dt[y:y+h+1, x:x+w+1]
        outs.append(_line_stats_from_crops(torch.where(valid, crops, 0),
                                           clean_ccs))
    return torch.cat(outs, dim=0).reshape(b, l, 2)


@torch.no_grad()
def net_prob_sums_batch_sat(prob_u8: torch.Tensor, boxes: torch.Tensor
                            ) -> torch.Tensor:
    """[B, H, W] uint8 maps + [B, L, 4] (x, y, w, h) boxes -> exact int32
    sums [B, L] of ``prob[y:y+h, x:x+w]`` (numpy clip semantics) from a
    summed-area table: two cumsums per page, four corner lookups per box.
    int32 holds the full-page sum as long as 255*H*W < 2^31."""
    b, h, w = prob_u8.shape
    sat = torch.cumsum(torch.cumsum(prob_u8.to(torch.int32), dim=1,
                                    dtype=torch.int32), dim=2, dtype=torch.int32)
    satp = F.pad(sat, (1, 0, 1, 0))                  # [B, H+1, W+1]
    boxes = boxes.to(torch.int64)
    x0 = torch.clamp(boxes[..., 0], 0, w)
    y0 = torch.clamp(boxes[..., 1], 0, h)
    x1 = torch.maximum(x0, torch.clamp(boxes[..., 0] + boxes[..., 2], 0, w))
    y1 = torch.maximum(y0, torch.clamp(boxes[..., 1] + boxes[..., 3], 0, h))
    page = torch.arange(b, device=boxes.device)[:, None]

    def look(yy, xx):
        return satp[page, yy, xx]

    return look(y1, x1) - look(y0, x1) - look(y1, x0) + look(y0, x0)


@torch.no_grad()
def net_prob_sums_batch(prob_u8: torch.Tensor, boxes: torch.Tensor,
                        crop_h: int, crop_w: int) -> torch.Tensor:
    """Crop variant of :func:`net_prob_sums_batch_sat` for pages too large
    for an int32 table: [B, H, W] maps + [B, L, 4] boxes -> int32 [B, L].
    Boxes must fit the [crop_h, crop_w] bucket and start inside the padded
    page (the dispatcher zeroes invalid ones)."""
    b, l = boxes.shape[:2]
    padded = F.pad(prob_u8, (0, crop_w, 0, crop_h))
    flat = boxes.reshape(b * l, 4).to(torch.int64)
    pages = torch.arange(b * l, device=boxes.device) // l
    rr = torch.arange(crop_h, device=boxes.device)[None, :, None]
    cc = torch.arange(crop_w, device=boxes.device)[None, None, :]
    outs = []
    chunk = _STATS_CHUNK
    for s in range(0, b * l, chunk):
        eb = flat[s:s + chunk]
        crops = _take_crops(padded, pages[s:s + chunk], eb, rr, cc)
        valid = (rr < eb[:, 3][:, None, None]) & (cc < eb[:, 2][:, None, None])
        outs.append(torch.where(valid, crops, 0).sum(dim=(1, 2), dtype=torch.int32))
    return torch.cat(outs).reshape(b, l)


@torch.no_grad()
def line_features_batch(dt_u8: torch.Tensor, prob_u8: torch.Tensor,
                        swt_boxes: torch.Tensor, net_boxes: torch.Tensor,
                        crop_h: int, crop_w: int, clean_ccs: int = 2,
                        swt_boxes_host: Optional[np.ndarray] = None
                        ) -> torch.Tensor:
    """A group's full per-line feature set in one tensor: int32 [B, L, 3] of
    (exact net-prob sum, 2 * stroke width, text height), for one readback
    per page group."""
    sw_th = swt_line_stats_batch_gather2(
        dt_u8, swt_boxes, crop_h=crop_h, crop_w=crop_w, clean_ccs=clean_ccs,
        boxes_host=swt_boxes_host)
    sums = net_prob_sums_batch_sat(prob_u8, net_boxes)
    return torch.cat([sums[..., None].to(torch.int32), sw_th], dim=-1)


def _pow2(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _round_up(n: int, step: int, floor: int) -> int:
    """Round ``n`` up to a multiple of ``step`` (at least ``floor``)."""
    return max(floor, -(-n // step) * step)


class DeviceLineFeatures:
    """Host bridge: pick the buckets, pad the boxes, run the per-line
    programs against device-resident DT / probability maps, slice results.

    Bucket policy: the line count rounds up to a power of two, the SWT crop
    to multiples of 16 x 128 and the net crop to powers of two; buckets only
    grow, so a corpus settles on a few tensor shapes.
    """

    def __init__(self):
        self._line_bucket = 16
        self._swt_crop = [32, 256]
        self._net_crop = [32, 256]

    def _sanitize(self, boxes_list):
        """Pad a page group's box lists to shared [B, L, 4] buckets; returns
        (padded array, per-page valid masks, per-page counts)."""
        counts = [len(b) for b in boxes_list]
        lb = max(self._line_bucket, _pow2(max(max(counts), 1), floor=16))
        self._line_bucket = lb
        out = np.zeros((len(boxes_list), lb, 4), np.int32)
        valids = []
        for i, boxes in enumerate(boxes_list):
            n = counts[i]
            valid = np.ones(n, bool)
            if n:
                out[i, :n] = boxes
                valid = np.asarray(boxes)[:, 2] >= 0
                out[i, :n][~valid] = 0
            valids.append(valid)
        return out, valids, counts

    def dispatch_batch(self, dt_dev: torch.Tensor, prob_dev: torch.Tensor,
                       swt_boxes_list, net_boxes_list
                       ) -> Callable[[], List[Tuple[np.ndarray, np.ndarray]]]:
        """Run the page group's per-line programs (one box upload, one
        packed result left on the device); returns a zero-arg callable that
        reads it back and yields a list of ([L_i] net_prob f64, [L_i, 2]
        f32 stroke width / text height) per page. Box rows with w < 0 mark
        invalid lines -> zeros."""
        sb, svalids, counts = self._sanitize(swt_boxes_list)
        nb, _, _ = self._sanitize(net_boxes_list)
        if nb.shape[1] != sb.shape[1]:   # shared line bucket
            pad = max(nb.shape[1], sb.shape[1])
            sb = np.pad(sb, ((0, 0), (0, pad - sb.shape[1]), (0, 0)))
            nb = np.pad(nb, ((0, 0), (0, pad - nb.shape[1]), (0, 0)))
        self._swt_crop[0] = max(self._swt_crop[0],
                                _round_up(int(sb[..., 3].max(initial=0)) + 1,
                                          16, floor=32))
        self._swt_crop[1] = max(self._swt_crop[1],
                                _round_up(int(sb[..., 2].max(initial=0)) + 1,
                                          128, floor=256))
        self._net_crop[0] = max(self._net_crop[0],
                                _pow2(int(nb[..., 3].max(initial=0))))
        self._net_crop[1] = max(self._net_crop[1],
                                _pow2(int(nb[..., 2].max(initial=0))))
        b = len(counts)
        boxes_dev = torch.from_numpy(np.stack([sb, nb])).to(dt_dev.device)
        sb_dev, nb_dev = boxes_dev[0], boxes_dev[1]
        dt_s, prob_s = dt_dev[:b], prob_dev[:b]
        ph, pw = prob_dev.shape[1:]
        if 255 * ph * pw < 2 ** 31:
            packed_dev = line_features_batch(
                dt_s, prob_s, sb_dev, nb_dev,
                crop_h=self._swt_crop[0], crop_w=self._swt_crop[1],
                swt_boxes_host=sb)
        else:   # the table would overflow int32 on huge pages
            sw_th = swt_line_stats_batch_gather2(
                dt_s, sb_dev, crop_h=self._swt_crop[0],
                crop_w=self._swt_crop[1], boxes_host=sb)
            sums = net_prob_sums_batch(prob_s, nb_dev,
                                       crop_h=self._net_crop[0],
                                       crop_w=self._net_crop[1])
            packed_dev = torch.cat([sums[..., None], sw_th], dim=-1)

        def materialize():
            packed = packed_dev.cpu().numpy()        # ONE bulk readback
            sums = packed[..., 0].astype(np.float64)
            sw_th_all = np.stack(
                [packed[..., 1].astype(np.float32) / 2.0,
                 packed[..., 2].astype(np.float32)], axis=-1)
            out = []
            for i, n in enumerate(counts):
                denom = nb[i, :n, 2].astype(np.float64) * nb[i, :n, 3] * 255.0
                netp = np.where((nb[i, :n, 2] > 0) & (nb[i, :n, 3] > 0),
                                sums[i, :n] / np.where(denom != 0, denom, 1.0),
                                0.0)
                sw_th = sw_th_all[i, :n]
                netp[~svalids[i]] = 0.0
                sw_th[~svalids[i]] = 0.0
                out.append((netp, sw_th))
            return out
        return materialize

    def dispatch(self, dt_dev, prob_dev, swt_boxes: np.ndarray,
                 net_boxes: np.ndarray):
        """Single-page variant of :meth:`dispatch_batch`."""
        handle = self.dispatch_batch(dt_dev[None], prob_dev[None],
                                     [swt_boxes], [net_boxes])

        def materialize():
            return handle()[0]
        return materialize

    def __call__(self, dt_dev, prob_dev, swt_boxes, net_boxes):
        return self.dispatch(dt_dev, prob_dev, swt_boxes, net_boxes)()
