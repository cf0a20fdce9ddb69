"""Separator region page writer: text-line splitting at vertical separators.

Port of ``citlab_as_tpu/stages/separator_writer.py``. Polygon booleans come
from :mod:`citlab_as_tpu_torch.geometry.booleans` (exact predicates +
pixel-space region booleans); the image's size is read from its header
(``utils.io.image_size``).

Behavior:
- remove existing SeparatorRegions;
- for every VERTICAL separator polygon, split intersecting text lines: the
  line polygon is cut into the parts outside the separator, words are
  reassigned to the split with maximal overlap, the baseline is clipped and
  each piece attached to the split it intersects; splits without a baseline
  piece are dropped; lines fully inside the separator are deleted;
- write all separator polygons as SeparatorRegions with an orientation
  custom tag, splitting polygons with large holes into hole-free parts.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import numpy as np

from citlab_as_tpu_torch.geometry.booleans import (
    convert_polygon_with_holes, polygon_contains, polygon_difference,
    polygon_intersection_area, polygons_intersect, polyline_intersects_polygon,
    ring_area, split_polyline_outside,
)
from citlab_as_tpu_torch.ops.resize import get_scaling_factor
from citlab_as_tpu_torch.pagexml import Page, SeparatorRegion, TextLine
from citlab_as_tpu_torch.pagexml.constants import SEPARATORREGION
from citlab_as_tpu_torch.utils.io import image_size
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


class RegionToPageWriter:
    """Load-or-create the Page object and save it (region_to_page_writer.py:13-63)."""

    def __init__(self, path_to_page, path_to_image=None, fixed_height=None,
                 scaling_factor=None):
        self.scaling_factor = None
        if path_to_image is not None:
            image_width, image_height = image_size(path_to_image)
            self.scaling_factor = get_scaling_factor(
                image_height, image_width, scaling_factor, fixed_height)
        self.path_to_page = path_to_page
        self.page_object = self._load_page_object(path_to_page, path_to_image)

    def _load_page_object(self, path_to_page, path_to_image) -> Page:
        if not os.path.exists(path_to_page):
            image_width, image_height = image_size(path_to_image)
            return Page(img_filename=path_to_image,
                        img_w=int(self.scaling_factor * image_width),
                        img_h=int(self.scaling_factor * image_height))
        return Page(path_to_page)

    def save_page_xml(self, save_path) -> None:
        self.page_object.write_page_xml(save_path)


def _copy_text_line(tl: TextLine, new_id: str) -> TextLine:
    return TextLine(
        new_id,
        custom=copy.deepcopy(tl.custom),
        text=tl.text,
        baseline=list(tl.baseline.points_list) if tl.baseline else None,
        surr_p=list(tl.surr_p.points_list) if tl.surr_p else None,
        words=list(tl.words),
    )


def _round_pts(points) -> list:
    return [(int(round(x)), int(round(y))) for x, y in points]


class SeparatorRegionToPageWriter(RegionToPageWriter):
    def __init__(self, path_to_page, path_to_image=None, fixed_height=None,
                 scaling_factor=None, region_dict: Optional[Dict[str, list]] = None):
        super().__init__(path_to_page, path_to_image, fixed_height, scaling_factor)
        self.region_dict = region_dict or {}
        self._lines_changed = False

    def remove_separator_regions_from_page(self) -> None:
        self.page_object.remove_regions(SEPARATORREGION)

    # ------------------------------------------------------------------
    def _split_text_lines(self, text_lines_dict, sep_rings) -> dict:
        """Split the lines in ``text_lines_dict`` ({orig_id: [lines]}) at one
        vertical separator polygon (writer:154-222)."""
        # bbox prefilter: a line whose bbox is disjoint from the separator's
        # cannot be contained, intersect, or split — skips every polygon
        # test for the (overwhelmingly common) non-overlapping pairs
        sep_ext = np.asarray(sep_rings[0], np.float64)
        sx0, sy0 = sep_ext.min(axis=0)
        sx1, sy1 = sep_ext.max(axis=0)
        for tl_id, text_lines in text_lines_dict.items():
            for text_line in list(text_lines):
                if text_line.surr_p is None:
                    continue
                pts = text_line.surr_p.points_list
                if (min(p[0] for p in pts) > sx1
                        or max(p[0] for p in pts) < sx0
                        or min(p[1] for p in pts) > sy1
                        or max(p[1] for p in pts) < sy0):
                    continue
                line_poly = [list(pts)]
                if polygon_contains(sep_rings, line_poly):
                    text_lines.remove(text_line)
                    self._lines_changed = True
                    continue
                if not polygons_intersect(line_poly, sep_rings):
                    continue
                self._lines_changed = True

                splits = polygon_difference(line_poly, sep_rings)
                split_exteriors = [s[0] for s in splits]
                if not split_exteriors:
                    text_lines.remove(text_line)
                    continue

                new_lines = []
                for j, ext in enumerate(split_exteriors):
                    new_id = (text_line.id if len(split_exteriors) == 1
                              else f"{text_line.id}_{j + 1}")
                    nl = _copy_text_line(text_line, new_id)
                    nl.set_points(_round_pts(ext))
                    nl.set_baseline(None)
                    if len(split_exteriors) != 1:
                        nl.words = []
                    new_lines.append(nl)

                if len(new_lines) != 1 and text_line.words:
                    for word in text_line.words:
                        if word.surr_p is None:
                            continue
                        word_poly = [list(word.surr_p.points_list)]
                        areas = [polygon_intersection_area(word_poly, [ext])
                                 for ext in split_exteriors]
                        new_lines[int(np.argmax(areas))].words.append(word)
                    for nl in new_lines:
                        nl.text = " ".join(w.text for w in nl.words)

                # baseline pieces outside the separator -> parent split
                if text_line.baseline is not None:
                    bl_pts = text_line.baseline.points_list
                    if polyline_intersects_polygon(bl_pts, sep_rings):
                        pieces = split_polyline_outside(bl_pts, sep_rings)
                    else:
                        pieces = [bl_pts]
                else:
                    pieces = []

                used = []
                for piece in pieces:
                    if len(piece) < 2:
                        continue
                    for idx, ext in enumerate(split_exteriors):
                        if polyline_intersects_polygon(piece, [ext]):
                            new_lines[idx].set_baseline(_round_pts(piece))
                            if idx not in used:
                                used.append(idx)
                            break

                # drop splits without a baseline piece (writer:215-218)
                kept = [new_lines[idx] for idx in used]
                text_lines.extend(kept)
                text_lines.remove(text_line)
        return text_lines_dict

    # ------------------------------------------------------------------
    def _add_separator_regions_to_page(self, separator_polygons, separator_type,
                                       remove_holes: bool) -> None:
        orientation = None
        if separator_type != SEPARATORREGION:
            orientation = separator_type[len(SEPARATORREGION) + 1:]

        existing_ids = set(self.page_object.get_ids())
        next_i = [1]

        def add_one(ring):
            # same ids as per-call get_unique_id, without a full-tree id
            # scan per separator region
            while f"{SEPARATORREGION}_{next_i[0]}" in existing_ids:
                next_i[0] += 1
            separator_id = f"{SEPARATORREGION}_{next_i[0]}"
            existing_ids.add(separator_id)
            custom = ({"structure": {"orientation": orientation}}
                      if orientation else None)
            region = SeparatorRegion(separator_id, points=_round_pts(ring), custom=custom)
            self.page_object.add_region(region)

        for rings in separator_polygons:
            if remove_holes and len(rings) > 1:
                for part in convert_polygon_with_holes(rings, min_hole_area=1000):
                    if ring_area(part) > 0:
                        add_one(part)
            else:
                add_one(rings[0])

    # ------------------------------------------------------------------
    def merge_regions(self, remove_holes: bool = True) -> None:
        """Split text lines at vertical separators, then write all separator
        regions (writer:107-387)."""
        text_regions = self.page_object.get_text_regions()

        for separator_type in (SEPARATORREGION,
                               f"{SEPARATORREGION}_horizontal",
                               f"{SEPARATORREGION}_vertical"):
            separator_polygons = self.region_dict.get(separator_type)
            if separator_polygons is None:
                continue

            if separator_type == f"{SEPARATORREGION}_vertical":
                self._lines_changed = False
                for text_region in text_regions:
                    text_lines_dict = {tl.id: [tl] for tl in text_region.text_lines}
                    for sep_rings in separator_polygons:
                        text_lines_dict = self._split_text_lines(
                            text_lines_dict, sep_rings)
                    text_region.text_lines = [
                        tl for tls in text_lines_dict.values() for tl in tls]
                if self._lines_changed:
                    # rebuilding every region's DOM subtree is the bulk of
                    # the write tail; skip it when no line was split/removed
                    self.page_object.set_text_regions(text_regions,
                                                      overwrite=True)

            self._add_separator_regions_to_page(
                separator_polygons, separator_type, remove_holes)
