"""Text block post-processors (port of
``citlab_as_tpu/stages/textblock_postprocess.py``; legacy / experimental
stage variants).

Reference: image_segmentation/net_post_processing/
{text_block_net_post_processor.py:4-62, textblock_net_post_processor_old.py:
19-345}. The newer processor turns a text-block segmentation map into
TextRegion contours (CC filter on the device, ``ops/connected_components.py``;
contour tracing on the host, ``ops/contours.py``; point thinning); the old
one is a recursive XY-cut over projection profiles, on the host.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.geometry.rectangle import Rectangle
from citlab_as_tpu_torch.ops.connected_components import remove_small_components
from citlab_as_tpu_torch.ops.contours import trace_contours
from citlab_as_tpu_torch.stages.separator import apply_threshold


def remove_every_nth_point(polygon: list, n: int = 2, min_num_points: int = 20,
                           iterations: int = 1) -> list:
    """Thin a contour by keeping every n-th point
    (region_net_post_processor_base.py:145-163)."""
    if iterations <= 0:
        return polygon
    if len(polygon) // n < min_num_points:
        return polygon
    res = polygon[::n]
    if polygon[0] == polygon[-1] and res[0] != res[-1]:
        res.append(res[0])
    return remove_every_nth_point(res, n, min_num_points, iterations - 1)


class TextBlockNetPostProcessor:
    """Text-block segmentation map -> TextRegion contour polygons
    (text_block_net_post_processor.py:4-36). The CC filter runs on
    ``device`` ("cuda" unless told "cpu")."""

    def __init__(self, predict_fn: Optional[Callable] = None,
                 threshold: float = 0.05, device: DeviceLike = "cuda"):
        self.predict_fn = predict_fn
        self.threshold = threshold
        self.device = resolve_device(device)

    def post_process(self, net_output: np.ndarray) -> np.ndarray:
        """Drop the 'other' channel, remove CCs below 1% of the pixels
        (the reference's expression, which rounds to 99 or 100)."""
        channel = net_output[:, :, 0]
        binary = apply_threshold(
            np.asarray(channel * 255, np.uint8), self.threshold)
        min_size = max(1, int(binary.size * (1 / binary.size * 100)))
        mask = remove_small_components(
            torch.from_numpy(binary).to(self.device)[None], min_size)
        return mask[0].cpu().numpy()

    def to_polygons(self, net_output_post: np.ndarray) -> List[list]:
        contours = trace_contours(net_output_post)
        exteriors = [c[0] for c in contours]
        return [remove_every_nth_point(list(c), n=2, min_num_points=20,
                                       iterations=1) for c in exteriors]

    def run_on_probability_map(self, prob_map: np.ndarray) -> List[list]:
        return self.to_polygons(self.post_process(prob_map))


# ---------------------------------------------------------------- XY-cut

def get_separators(image: np.ndarray, mode: str = "horizontal",
                   threshold: float = 0.1) -> List[Tuple[int, float]]:
    """White-run indices of the projection profile
    (textblock_net_post_processor_old.py:74-102): rows (or columns) whose
    relative white-pixel count exceeds ``threshold``."""
    axis = 1 if mode == "horizontal" else 0
    white = (image > 0).mean(axis=axis)
    return [(int(i), float(v)) for i, v in enumerate(white) if v >= threshold]


def xy_cut(text_block_image: np.ndarray, max_recursion_depth: int = 6,
           mode: str = "horizontal", threshold: float = 0.9,
           min_separator_distance_factor: float = 0.01) -> List[Rectangle]:
    """Recursive XY-cut over projection profiles
    (textblock_net_post_processor_old.py:124-196): alternate horizontal and
    vertical splits at whitespace runs until the recursion depth is
    exhausted; returns the leaf region rectangles."""
    img_h, img_w = text_block_image.shape
    min_dist = max(1, int(img_h * min_separator_distance_factor))
    leaves: List[Rectangle] = []

    def recurse(rect: Rectangle, depth: int, mode: str, threshold: float):
        if depth == 0:
            leaves.append(rect)
            return
        crop = text_block_image[rect.y:rect.y + rect.height,
                                rect.x:rect.x + rect.width]
        if crop.size == 0:
            return
        profile = get_separators(255 - crop, mode, threshold)
        separators = [i for i, _ in profile]
        if not separators:
            leaves.append(rect)
            return

        ranges = []
        if separators[0] > min_dist:
            ranges.append((0, separators[0]))
        for a, b in zip(separators[:-1], separators[1:]):
            if b - a > min_dist:
                ranges.append((a + 1, b))
        extent = crop.shape[0] if mode == "horizontal" else crop.shape[1]
        if (extent - 1) - separators[-1] > min_dist:
            ranges.append((separators[-1], extent - 1))

        if not ranges:
            leaves.append(rect)
            return

        next_mode = "vertical" if mode == "horizontal" else "horizontal"
        for lo, hi in ranges:
            if mode == "horizontal":
                sub = Rectangle(rect.x, rect.y + lo, rect.width, hi - lo)
            else:
                sub = Rectangle(rect.x + lo, rect.y, hi - lo, rect.height)
            recurse(sub, depth - 1, next_mode, max(0.9 * threshold, 0.65))

    recurse(Rectangle(0, 0, img_w, img_h), max_recursion_depth, mode, threshold)
    return leaves
