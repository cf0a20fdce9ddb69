"""Host-side contour tracing: binary mask -> ring polygons per component.

Port copy of ``citlab_as_tpu/ops/contours.py`` (``trace_contours``,
``_group_rings_by_nesting``, ``_chain_rings_fast``): numpy only, with
``np.nonzero`` in place of the C foreground scan.

Replaces rasterio.features.shapes (region_net_post_processor_base.py:178-197).
Output matches its contract: per 8-connected component a list of closed rings
in pixel-corner coordinates [(x, y), ...] — exterior ring first, then holes.

The boundary-edge extraction is vectorized numpy; only the ring chaining is a
Python loop over boundary edges (output is irreducibly irregular — this is
exactly the work SURVEY.md keeps on host).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Point = Tuple[int, int]
Ring = List[Point]


def trace_contours(binary, labels=None) -> List[List[Ring]]:
    """Ring polygons of the 8-connected components of ``binary`` (255/0 or
    bool). Returns one entry per component: [exterior_ring, *hole_rings].
    With a ``labels`` image (one id per component) the rings are grouped by
    label, components in ascending label order."""
    mask = np.asarray(binary) != 0
    if not mask.any():
        return []
    if labels is None:
        # hole rings are grouped with their component's exterior by ring
        # nesting (a hole's innermost enclosing exterior ring IS its
        # component's exterior), so no connected-component labeling is needed
        return _group_rings_by_nesting(_chain_rings_fast(mask))

    by_label: Dict[int, List[Tuple[Ring, float]]] = {}
    for ring, label, area in _chain_rings_fast(mask, np.asarray(labels)):
        by_label.setdefault(label, []).append((ring, area))
    out = []
    for label in sorted(by_label):
        comp = by_label[label]
        exteriors = [r for r, a in comp if a > 0]
        holes = [r for r, a in comp if a <= 0]
        # a component has exactly one exterior; keep largest as safety
        exteriors.sort(key=lambda r: -abs(_ring_area(r)))
        out.append([exteriors[0]] + holes if exteriors else [comp[0][0]])
    return out


def _ring_area(ring: Ring) -> float:
    """Signed shoelace area of a closed ring (first == last)."""
    area = 0.0
    for (x1, y1), (x2, y2) in zip(ring[:-1], ring[1:]):
        area += x1 * y2 - x2 * y1
    return area / 2.0


def _group_rings_by_nesting(rings) -> List[List[Ring]]:
    """[exterior, *holes] per component without a label image.

    Component ORDER matches the labeled path (scipy's row-major
    first-pixel numbering): ring discovery in :func:`_chain_rings_fast`
    starts from the smallest corner-edge index of each ring; for an
    exterior that is the top edge of its component's topmost-leftmost
    pixel, and top edges come first in the edge arrays in row-major order
    — so exteriors are discovered exactly in first-pixel row-major order.

    Hole assignment: a half-integer point strictly inside the hole (the
    cell below-right of the hole ring's topmost-leftmost vertex) is tested
    against enclosing exteriors; the innermost (smallest-area) containing
    exterior is the component's. Half-integer coordinates can never lie ON
    a crack ring (rectilinear, integer coords), so the even-odd test is
    exact."""
    from citlab_as_tpu_torch.geometry.booleans import point_in_ring

    exteriors: List[Tuple[Ring, float]] = []
    holes: List[Ring] = []
    for ring, _lab, area in rings:
        (exteriors if area > 0 else holes).append(
            (ring, area) if area > 0 else ring)
    comps: List[List[Ring]] = [[ext] for ext, _ in exteriors]
    extra: List[List[Ring]] = []
    if holes:
        bboxes = []
        for ext, _ in exteriors:
            arr = np.asarray(ext, np.float64)
            bboxes.append((arr[:, 0].min(), arr[:, 1].min(),
                           arr[:, 0].max(), arr[:, 1].max()))
        for hole in holes:
            vx, vy = min(hole[:-1], key=lambda p: (p[1], p[0]))
            px, py = vx + 0.5, vy + 0.5
            best, best_area = None, None
            for i, (ext, area) in enumerate(exteriors):
                x0, y0, x1, y1 = bboxes[i]
                if not (x0 < px < x1 and y0 < py < y1):
                    continue
                if ((best_area is None or area < best_area)
                        and point_in_ring((px, py), ext)):
                    best, best_area = i, area
            if best is None:          # malformed mask: emit standalone
                extra.append([hole])
            else:
                comps[best].append(hole)
    return comps + extra


def _chain_rings_fast(mask: np.ndarray, labels=None
                      ) -> List[Tuple[Ring, int, float]]:
    """Vectorized ring chaining: crack edges as arrays, successor assignment
    via one sort + searchsorted (at pinch corners the sharpest left turn
    wins, so diagonal 8-connected neighbours stay on one ring), collinear
    runs skipped with pointer doubling, then a Python walk over CORNER edges
    only: O(E log E) numpy + O(corners) Python. Returns (ring, label, signed
    area) triples (label 0 without a label image); rings are closed
    (first == last).
    """
    h, w = mask.shape
    padded = np.zeros((h + 2, w + 2), dtype=bool)
    padded[1:-1, 1:-1] = mask
    stride = w + 2

    # one sparse foreground scan + neighbor gathers at those K points —
    # building a full-frame boolean selector per direction (8 H x W
    # temporaries + 4 scans) dominated this function on sparse masks
    frs, fcs = np.nonzero(mask)
    flabs = (labels[frs, fcs] if labels is not None
             else np.zeros(frs.shape[0], np.int32))
    nb_top = padded[frs, fcs + 1]
    nb_right = padded[frs + 1, fcs + 2]
    nb_bottom = padded[frs + 2, fcs + 1]
    nb_left = padded[frs + 1, fcs]

    starts, ends, dirs, labs = [], [], [], []

    def add(nb, s_dx, s_dy, e_dx, e_dy, d):
        idx = np.flatnonzero(~nb)   # row-major order, as np.nonzero gave
        rs, cs = frs[idx], fcs[idx]
        starts.append((rs + s_dy) * stride + (cs + s_dx))
        ends.append((rs + e_dy) * stride + (cs + e_dx))
        dirs.append(np.full(idx.shape[0], d, np.int8))
        labs.append(flabs[idx])

    add(nb_top, 0, 0, 1, 0, 0)       # top: walk +x
    add(nb_right, 1, 0, 1, 1, 1)     # right: walk +y
    add(nb_bottom, 1, 1, 0, 1, 2)    # bottom: walk -x
    add(nb_left, 0, 1, 0, 0, 3)      # left: walk -y

    S = np.concatenate(starts)
    E = np.concatenate(ends)
    D = np.concatenate(dirs).astype(np.int16)
    L = np.concatenate(labs)
    n = S.shape[0]
    if n == 0:
        return []

    # successor: the edge starting where this one ends; at pinch corners
    # (two candidates) take the sharpest left turn
    order = np.argsort(S, kind="stable")
    s_sorted = S[order]
    lo = np.searchsorted(s_sorted, E, "left")
    hi = np.searchsorted(s_sorted, E, "right")
    succ = order[np.minimum(lo, n - 1)]
    two = np.flatnonzero(hi - lo == 2)
    if two.size:
        c0 = order[lo[two]]
        c1 = order[lo[two] + 1]
        cur = D[two]
        s0 = (D[c0] - cur + 1) % 4
        s1 = (D[c1] - cur + 1) % 4
        succ[two] = np.where(s0 <= s1, c0, c1)

    pred = np.empty(n, np.int64)
    pred[succ] = np.arange(n)
    is_corner = D != D[pred]

    # next-corner pointers: first successor whose direction differs
    ptr = succ.copy()
    done = D[ptr] != D
    while True:
        nd = np.flatnonzero(~done)
        if nd.size == 0:
            break
        p = ptr[nd]
        done[nd] = done[p]
        ptr[nd] = ptr[p]

    rings: List[Tuple[Ring, int, float]] = []
    visited = np.zeros(n, dtype=bool)
    for c0 in np.flatnonzero(is_corner):
        if visited[c0]:
            continue
        chain = []
        c = int(c0)
        while not visited[c]:
            visited[c] = True
            chain.append(c)
            c = int(ptr[c])
        pts: Ring = [(int(S[c] % stride), int(S[c] // stride)) for c in chain]
        pts.append(pts[0])
        xs = np.asarray([p[0] for p in pts], np.float64)
        ys = np.asarray([p[1] for p in pts], np.float64)
        area = float(np.dot(xs[:-1], ys[1:]) - np.dot(xs[1:], ys[:-1])) / 2.0
        rings.append((pts, int(L[c0]), area))
    return rings
