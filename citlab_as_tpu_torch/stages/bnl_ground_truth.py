"""BNL dataset GT generator specializations (port of
``citlab_as_tpu/stages/bnl_ground_truth.py``).

Reference: image_segmentation/ground_truth_generators/
{bnl_ground_truth_generator.py, bnl_ground_truth_generator_headers.py} —
Luxembourg newspaper specializations ("Luxemburger Wort",
"L'independance Luxembourgeoise") that split the region GT into finer
channel sets (titles by structure subtype, headings, adverts, tables,
captions).
"""
from __future__ import annotations

from typing import Sequence

from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.pagexml.constants import TextRegionTypes
from citlab_as_tpu_torch.stages.ground_truth import (
    RegionGroundTruthGenerator, plot_polys_binary,
)


class BNLGroundTruthGenerator(RegionGroundTruthGenerator):
    """Channel layout: text, adverts+tables, titles (headline subtype),
    titles (subheadline/motto), other titles, separators (+ 'other'
    complement appended by the base)."""

    def __init__(self, path_to_img_lst, max_resolution=(0, 0),
                 scaling_factor=1.0, use_bounding_box=False,
                 use_min_area_rect=False, issue_name: str = "luxwort"):
        super().__init__(path_to_img_lst, max_resolution, scaling_factor,
                         use_bounding_box, use_min_area_rect,
                         region_types=["TextRegion"])
        self.issue_name = issue_name
        self.gt_channel_names = [
            "text", "advert_table", "title_headline", "title_subheadline",
            "title_other", "separator"]

    # -------- region selectors (region_ground_truth_generator.py:264-363)
    @staticmethod
    def _structure_type(region) -> str:
        return region.custom.get("structure", {}).get("type", "")

    @staticmethod
    def _structure_subtype(region) -> str:
        return region.custom.get("structure", {}).get("subtype", "")

    def get_title_regions(self, page: Page, subtypes: Sequence[str]) -> list:
        out = []
        for tr in page.get_text_regions():
            if self._structure_type(tr) == "title" and \
                    self._structure_subtype(tr) in subtypes:
                out.append(tr)
        return out

    def get_classic_heading_regions(self, page: Page, subtypes: Sequence[str]) -> list:
        out = []
        for tr in page.get_text_regions():
            if tr.region_type == TextRegionTypes.HEADING and \
                    self._structure_subtype(tr) in subtypes:
                out.append(tr)
        return out

    def get_caption_regions(self, page: Page) -> list:
        return [tr for tr in page.get_text_regions()
                if tr.region_type == TextRegionTypes.CAPTION]

    def _plain_text_regions(self, page: Page) -> list:
        special = {r.id for r in (
            self.get_title_regions(page, ["headline", "subheadline", "motto",
                                          "other", "publishing_stmt"])
            + self.get_classic_heading_regions(
                page, ["", "title", "subheadline", "overline", "author", "other"]))}
        return [tr for tr in page.get_text_regions() if tr.id not in special]

    # -------- channels
    def create_ground_truth_images(self) -> None:
        self.gt_imgs_lst = []
        for page, (h, w), sc in zip(self.page_object_lst, self.img_res_lst,
                                    self.scaling_factors):
            out_w, out_h = int(w * sc), int(h * sc)
            regions_all = page.get_regions()

            def render(region_list):
                polys = [[(x * sc, y * sc) for x, y in r.points.points_list]
                         for r in region_list]
                return plot_polys_binary(polys, out_w, out_h, fill_polygons=True)

            channels = [
                render(self._plain_text_regions(page)),
                render(regions_all.get("AdvertRegion", [])
                       + regions_all.get("TableRegion", [])),
                render(self.get_title_regions(page, ["headline"])
                       + self.get_classic_heading_regions(page, ["", "title"])),
                render(self.get_title_regions(page, ["subheadline", "motto"])
                       + self.get_classic_heading_regions(
                           page, ["subheadline", "overline"])),
                render(self.get_title_regions(page, ["other", "publishing_stmt"])
                       + self.get_classic_heading_regions(page, ["author", "other"])),
                render(regions_all.get("SeparatorRegion", [])),
            ]
            self.gt_imgs_lst.append(channels)
        self.make_disjoint_all()
        self.add_other_channel()


class BNLHeaderGroundTruthGenerator(BNLGroundTruthGenerator):
    """Header-only variant (bnl_ground_truth_generator_headers.py): one
    channel for all title/heading regions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gt_channel_names = ["header"]

    def create_ground_truth_images(self) -> None:
        self.gt_imgs_lst = []
        for page, (h, w), sc in zip(self.page_object_lst, self.img_res_lst,
                                    self.scaling_factors):
            out_w, out_h = int(w * sc), int(h * sc)
            headers = (
                self.get_title_regions(page, ["headline", "subheadline",
                                              "motto", "other", "publishing_stmt"])
                + self.get_classic_heading_regions(
                    page, ["", "title", "subheadline", "overline", "author",
                           "other"]))
            polys = [[(x * sc, y * sc) for x, y in r.points.points_list]
                     for r in headers]
            self.gt_imgs_lst.append(
                [plot_polys_binary(polys, out_w, out_h, fill_polygons=True)])
        self.add_other_channel()
