"""Stroke-width distance transform (SWT), host path (port of
``citlab_as_tpu/ops/swt.py``).

Invert, Gaussian+Otsu binarization and the Euclidean distance transform of
a whole page, then per text line the connected-component statistics over a
small bbox crop (scipy label, mirroring cv2.connectedComponentsWithStats
per crop). This is what ``HeadingNetPostProcessor.run`` uses; the fused
stage computes the same quantities on the device (``ops/swt_device.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Tuple

import numpy as np
import scipy.ndimage as ndi

_EIGHT = np.ones((3, 3), dtype=np.int8)


class StrokeWidthDistanceTransform:
    """SWT feature extractor: distance-transform image + cleaned CC stats."""

    # process-wide DT memo: the heading and GNN-feature stages both need the
    # full-resolution distance transform of the same page image. Keyed by
    # caller-supplied cache_key (image path) + polarity; bounded LRU.
    _DT_CACHE: "OrderedDict" = OrderedDict()
    _DT_CACHE_MAX = 16

    def __init__(self, dark_on_bright: bool = True, clean_ccs: int = 2):
        self._dark_on_bright = dark_on_bright
        self._clean_ccs = clean_ccs

    def distance_transform(self, image: np.ndarray,
                           cache_key: str = None) -> np.ndarray:
        """Grayscale image -> uint8 distance-transform image. Values are
        clipped at 255 rather than wrapped. ``cache_key`` (e.g. the image
        path) memoizes the result across pipeline stages."""
        cache = StrokeWidthDistanceTransform._DT_CACHE
        key = (cache_key, self._dark_on_bright) if cache_key else None
        if key is not None and key in cache:
            cache.move_to_end(key)
            return cache[key]

        # imported here: ops/binarize.py imports torch, which the host-tail
        # workers (stages/host_chain.py) need not pay for at start-up
        from citlab_as_tpu_torch.ops.binarize import otsu_binarize_host
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[..., 0]
        if self._dark_on_bright:
            img = 255 - img.astype(np.int32)
        _, binary = otsu_binarize_host(img.astype(np.float32), blur_ksize=5)
        dist = np.minimum(ndi.distance_transform_edt(binary != 0), 255.0)
        out = dist.astype(np.uint8)
        if key is not None:
            cache[key] = out
            while len(cache) > StrokeWidthDistanceTransform._DT_CACHE_MAX:
                cache.popitem(last=False)
        return out

    def distance_transform_from_file(self, img_file: str) -> np.ndarray:
        from citlab_as_tpu_torch.utils.io import load_image
        return self.distance_transform(load_image(img_file, mode="L"))

    def apply_swt_dist_trafo(self, image: np.ndarray):
        swt = self.distance_transform(image)
        ccs = self.connected_components(swt)
        return swt, self.clean_connected_components(ccs)

    # ---------------- host crop path ----------------
    @staticmethod
    def connected_components(image: np.ndarray) -> List[Tuple[int, int, int, int]]:
        """(x, y, w, h) bboxes of the 8-connected nonzero components
        (background skipped)."""
        mask = np.asarray(image) != 0
        if not mask.any():
            return []
        labels, n = ndi.label(mask, structure=_EIGHT)
        slices = ndi.find_objects(labels)
        out = []
        for sl in slices:
            if sl is None:
                continue
            ys, xs = sl
            out.append((int(xs.start), int(ys.start),
                        int(xs.stop - xs.start), int(ys.stop - ys.start)))
        return out

    def clean_connected_components(self, components):
        """Reject tiny/huge components and extreme aspect ratios."""
        out = []
        for x, y, w, h in components:
            if self._clean_ccs > 0 and (w < 3 or h < 3 or h > 500 or w > 500):
                continue
            if self._clean_ccs > 1 and (w / h > 8 or h / w > 8):
                continue
            out.append((x, y, w, h))
        return out

    # ---------------- per-text-line features ----------------
    def textline_features(self, swt_image: np.ndarray, bbox) -> Tuple[float, int]:
        """(stroke_width, text_height) for one text line bbox: median of the
        per-CC max distance values and max CC height inside the crop."""
        x, y, w, h = bbox
        crop = swt_image[y:y + h + 1, x:x + w + 1]
        ccs = self.clean_connected_components(self.connected_components(crop))
        swt_values = []
        text_height = 0
        for cx, cy, cw, ch in ccs:
            swt_values.append(np.max(crop[cy:cy + ch, cx:cx + cw]))
            text_height = max(text_height, ch)
        stroke_width = float(np.median(swt_values)) if swt_values else 0.0
        return stroke_width, text_height
