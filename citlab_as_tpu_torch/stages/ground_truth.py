"""Ground-truth image generation for segmentation training (port of
``citlab_as_tpu/stages/ground_truth.py``).

Reference: article_separation/image_segmentation/ground_truth_generators/
{ground_truth_generator_base.py:18-326, region_ground_truth_generator.py:
23-404, run_as_gt_generation.py:104-368, article_text_files_generation.py:
9-84}. Produces the multi-channel GT images (per-class masks + trailing
'other' complement channel) that the ARU-Net trainers consume, an info file
listing the channel semantics, grayscale image copies, and the AS
article-rectangle GT variant.

The JAX package draws with PIL; the port draws with ``utils/draw.py``,
resizes with ``utils/io.py::resize_bilinear`` and writes the grey copy with
``utils/io.py::save_jpeg``, all equal bit for bit to PIL 12.1. The
region generators are host code, as in the reference (drawing in host C++,
channel composition in numpy). The AS variant's device work, the article
rectangles' Otsu pass and ``apply_dilation``, runs on ``device``, which
defaults to the card and raises without one.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.geometry.util import bounding_box, convex_hull
from citlab_as_tpu_torch.ops.morphology import dilate
from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.pagexml import constants as C
from citlab_as_tpu_torch.pagexml.constants import TextRegionTypes
from citlab_as_tpu_torch.utils import draw
from citlab_as_tpu_torch.utils.io import (
    get_img_from_page_path, get_page_path, load_image, load_list_file,
    resize_bilinear, save_jpeg, save_png,
)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------- drawing

def plot_polys_binary(polygon_list, img_width: int, img_height: int,
                      closed: bool = True, fill_polygons: bool = False,
                      line_width: int = 7) -> np.ndarray:
    """Rasterize polygons into a 0/255 uint8 image (the reference renders
    through a matplotlib canvas, base:231-268; the JAX package draws the same
    masks with PIL, and ``utils/draw.py`` equals PIL's drawing)."""
    img = draw.new_canvas(img_width, img_height)
    for poly in polygon_list:
        pts = [(float(x), float(y)) for x, y in poly]
        if len(pts) < 2:
            continue
        if fill_polygons and len(pts) >= 3:
            draw.polygon(img, pts, 255)
        else:
            if closed and pts[0] != pts[-1]:
                pts.append(pts[0])
            draw.line(img, pts, 255, width=line_width)
    return img


def min_area_rect(points) -> List[Tuple[float, float]]:
    """Minimum-area enclosing rectangle via rotating calipers over the convex
    hull (region_ground_truth_generator.py:174-189 uses cv2.minAreaRect)."""
    hull = convex_hull([(float(x), float(y)) for x, y in points])
    if len(hull) < 3:
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        return [(min(xs), min(ys)), (max(xs), min(ys)),
                (max(xs), max(ys)), (min(xs), max(ys))]
    hull_arr = np.asarray(hull, np.float64)
    n = len(hull_arr)
    best = None
    for i in range(n):
        edge = hull_arr[(i + 1) % n] - hull_arr[i]
        norm = np.linalg.norm(edge)
        if norm == 0:
            continue
        ux = edge / norm
        uy = np.array([-ux[1], ux[0]])
        proj_x = hull_arr @ ux
        proj_y = hull_arr @ uy
        w = proj_x.max() - proj_x.min()
        h = proj_y.max() - proj_y.min()
        area = w * h
        if best is None or area < best[0]:
            best = (area, ux, uy, proj_x.min(), proj_x.max(),
                    proj_y.min(), proj_y.max())
    _, ux, uy, x0, x1, y0, y1 = best
    corners = [x0 * ux + y0 * uy, x1 * ux + y0 * uy,
               x1 * ux + y1 * uy, x0 * ux + y1 * uy]
    return [(float(c[0]), float(c[1])) for c in corners]


def make_disjoint(gt_img_compare: np.ndarray, gt_img_to_change: np.ndarray) -> np.ndarray:
    """Remove overlap of the second GT channel with the first (base:271-279)."""
    return np.where(gt_img_compare > 0, 0, gt_img_to_change).astype(np.uint8)


def create_other_ground_truth_image(*channel_images) -> np.ndarray:
    """Complement channel: white where no other channel fires (base:137-152)."""
    stacked = np.stack(channel_images, axis=0)
    return np.where(stacked.max(axis=0) > 0, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- base

class GroundTruthGenerator:
    """Base GT generator: pages + grayscale copies + channel images
    (ground_truth_generator_base.py:18-326)."""

    def __init__(self, path_to_img_lst, max_resolution=(0, 0), scaling_factor=1.0):
        if isinstance(path_to_img_lst, str):
            self.img_path_lst = load_list_file(path_to_img_lst)
        else:
            self.img_path_lst = list(path_to_img_lst)
        self.page_path_lst = [get_page_path(p) for p in self.img_path_lst]
        self.page_object_lst = [Page(p) for p in self.page_path_lst]
        self.img_res_lst = [p.get_image_resolution()[::-1]
                            for p in self.page_object_lst]  # (h, w)
        self.max_resolution = max_resolution
        if max_resolution != (0, 0):
            self.scaling_factors = self.calculate_scaling_factors_from_max_resolution()
        else:
            self.scaling_factors = [scaling_factor] * len(self.img_path_lst)
        self.gt_imgs_lst: List[List[np.ndarray]] = []
        self.gt_channel_names: List[str] = []

    def calculate_scaling_factors_from_max_resolution(self) -> List[float]:
        max_h, max_w = self.max_resolution
        out = []
        for h, w in self.img_res_lst:
            sc = 1.0
            if max_h and h * sc > max_h:
                sc = max_h / h
            if max_w and w * sc > max_w:
                sc = min(sc, max_w / w)
            out.append(sc)
        return out

    # subclasses fill self.gt_imgs_lst (per page: list of channel images)
    def create_ground_truth_images(self) -> None:
        raise NotImplementedError

    def make_disjoint_all(self) -> None:
        """Left-to-right channel priority (base:282-297)."""
        for channels in self.gt_imgs_lst:
            for i in range(1, len(channels)):
                for j in range(i):
                    channels[i] = make_disjoint(channels[j], channels[i])

    def add_other_channel(self) -> None:
        """The 'other' complement channel (base:137-152)."""
        for channels in self.gt_imgs_lst:
            channels.append(create_other_ground_truth_image(*channels))
        if self.gt_channel_names and self.gt_channel_names[-1] != "other":
            self.gt_channel_names.append("other")

    # ---------------- saving ----------------
    @staticmethod
    def gt_savefile_name(img_name, index, save_dir, gt_folder_name="C3",
                         gt_file_ext=".png"):
        base = os.path.splitext(os.path.basename(img_name))[0]
        return os.path.join(save_dir, gt_folder_name, f"{base}_GT{index}{gt_file_ext}")

    @staticmethod
    def grey_savefile_name(img_name, save_dir, ext=".jpg"):
        base = os.path.splitext(os.path.basename(img_name))[0]
        return os.path.join(save_dir, f"{base}{ext}")

    def save_ground_truth(self, save_dir: str) -> List[str]:
        written = []
        os.makedirs(os.path.join(save_dir, "C3"), exist_ok=True)
        for img_path, channels, sc in zip(self.img_path_lst, self.gt_imgs_lst,
                                          self.scaling_factors):
            # grayscale (possibly downscaled) image copy
            grey = load_image(img_path, mode="L")
            if sc != 1.0:
                h, w = channels[0].shape
                grey = resize_bilinear(grey, w, h)
            grey_path = self.grey_savefile_name(img_path, save_dir)
            save_jpeg(grey_path, grey)
            written.append(grey_path)
            for idx, channel in enumerate(channels):
                path = self.gt_savefile_name(img_path, idx, save_dir)
                save_png(path, channel)
                written.append(path)
        return written

    def create_and_write_info_file(self, path_to_info_file: str) -> None:
        with open(path_to_info_file, "w") as f:
            for i, name in enumerate(self.gt_channel_names):
                f.write(f"GT{i}: {name}\n")

    def run_ground_truth_generation(self, save_dir: str,
                                    create_info_file: bool = True) -> List[str]:
        self.create_ground_truth_images()
        written = self.save_ground_truth(save_dir)
        if create_info_file:
            self.create_and_write_info_file(os.path.join(save_dir, "info.txt"))
        return written


# ---------------------------------------------------------------- regions

class RegionGroundTruthGenerator(GroundTruthGenerator):
    """Per-region-type GT masks (region_ground_truth_generator.py:23-404)."""

    def __init__(self, path_to_img_lst, max_resolution=(0, 0), scaling_factor=1.0,
                 use_bounding_box=False, use_min_area_rect=False,
                 region_types: Sequence[str] = ("TextRegion", "SeparatorRegion")):
        super().__init__(path_to_img_lst, max_resolution, scaling_factor)
        self.use_bounding_box = use_bounding_box
        self.use_min_area_rect = use_min_area_rect
        self.region_types = list(region_types)
        self.gt_channel_names = list(self.region_types)

    def _region_polys(self, page: Page, region_type: str) -> List[list]:
        regions = page.get_regions().get(region_type, [])
        polys = []
        for region in regions:
            pts = region.points.points_list
            if self.use_min_area_rect:
                pts = min_area_rect(pts)
            elif self.use_bounding_box:
                pts = bounding_box(pts)
            polys.append(pts)
        return polys

    def create_ground_truth_images(self) -> None:
        self.gt_imgs_lst = []
        for page, (h, w), sc in zip(self.page_object_lst, self.img_res_lst,
                                    self.scaling_factors):
            out_w, out_h = int(w * sc), int(h * sc)
            channels = []
            for region_type in self.region_types:
                polys = self._region_polys(page, region_type)
                if sc != 1.0:
                    polys = [[(x * sc, y * sc) for x, y in p] for p in polys]
                channels.append(plot_polys_binary(
                    polys, out_w, out_h, fill_polygons=True))
            self.gt_imgs_lst.append(channels)
        self.make_disjoint_all()
        self.add_other_channel()

    def get_heading_regions_for_page(self, page: Page) -> list:
        """TextRegions typed heading or with heading-tagged lines (the
        heading-stage output shape; cf. region_ground_truth_generator.py:
        311-363 which selects via region @type + custom structure)."""
        out = []
        for tr in page.get_text_regions():
            if tr.region_type == TextRegionTypes.HEADING:
                out.append(tr)
                continue
            if any(tl.get_semantic_type() == TextRegionTypes.HEADING
                   for tl in tr.text_lines):
                out.append(tr)
        return out

    # ---- reference-parity region getters (one entry per page) ----

    def get_regions_list(self, region_types: Sequence[str]) -> List[list]:
        """All regions of the given PAGE element names, one list per page
        (region_ground_truth_generator.py:296-311)."""
        out = []
        for page in self.page_object_lst:
            page_regions = page.get_regions()
            regions = []
            for region_type in region_types:
                regions += page_regions.get(region_type, [])
            out.append(regions)
        return out

    def get_image_regions_list(self) -> List[list]:
        """Graphic + Image regions (region_ground_truth_generator.py:283-288)."""
        return self.get_regions_list([C.GRAPHICREGION, C.IMAGEREGION])

    def get_separator_regions_list(self) -> List[list]:
        return self.get_regions_list([C.SEPARATORREGION])

    def get_table_regions_list(self) -> List[list]:
        return self.get_regions_list([C.TABLEREGION])

    def get_advert_regions_list(self) -> List[list]:
        return self.get_regions_list([C.ADVERTREGION])

    def get_valid_text_regions(self, intersection_thresh: int = 20,
                               region_types: Optional[Sequence[str]] = None
                               ) -> List[list]:
        """TextRegions of the given @type values, dropping any whose bounding
        box is contained in, or overlaps by more than ``intersection_thresh``
        pixels in BOTH dimensions with, an image region's bounding box
        (region_ground_truth_generator.py:219-263). ``intersection_thresh < 0``
        disables the image-intersection check entirely."""
        if region_types is None:
            region_types = [TextRegionTypes.PARAGRAPH]
        text_regions_list = [
            [tr for tr in page.get_text_regions()
             if tr.region_type in region_types]
            for page in self.page_object_lst]
        if intersection_thresh < 0:
            return text_regions_list

        image_regions_list = self.get_image_regions_list()
        valid_list = []
        for text_regions, image_regions in zip(text_regions_list,
                                               image_regions_list):
            if not image_regions:
                valid_list.append(text_regions)
                continue
            image_bbs = [ir.points.to_polygon().get_bounding_box()
                         for ir in image_regions]
            valid = []
            for tr in text_regions:
                tr_bb = tr.points.to_polygon().get_bounding_box()
                for image_bb in image_bbs:
                    if image_bb.contains_rectangle(tr_bb):
                        break
                    inter = tr_bb.intersection(image_bb)
                    if (inter.height > intersection_thresh
                            and inter.width > intersection_thresh):
                        break
                else:
                    valid.append(tr)
            valid_list.append(valid)
        return valid_list

    def get_heading_regions_list(self, custom_structure_type: str,
                                 custom_structure_subtypes: Sequence[str]
                                 ) -> List[list]:
        """Heading-typed TextRegions whose custom structure {type, subtype}
        matches; subtype '' selects regions WITHOUT a subtype entry
        (region_ground_truth_generator.py:341-367)."""
        valid_text_regions = self.get_valid_text_regions(
            region_types=[TextRegionTypes.HEADING])
        out = []
        for page_text_regions in valid_text_regions:
            regions = []
            for tr in page_text_regions:
                struct = tr.custom.get("structure", {})
                for subtype in custom_structure_subtypes:
                    if (subtype == "" and struct.get("type") ==
                            custom_structure_type and "subtype" not in struct):
                        regions.append(tr)
                    elif (struct.get("type") == custom_structure_type
                          and struct.get("subtype") == subtype):
                        regions.append(tr)
            out.append(regions)
        return out

    def get_title_regions_list(self, title_region_types: Sequence[str]
                               ) -> List[list]:
        """Title regions; valid subtypes are ['headline', 'subheadline',
        'publishing_stmt', 'motto', 'other']
        (region_ground_truth_generator.py:316-327)."""
        return self.get_heading_regions_list("title", title_region_types)

    def get_classic_heading_regions_list(self, heading_region_types:
                                         Sequence[str]) -> List[list]:
        """'Classic' heading regions; valid subtypes are ['overline', '',
        'subheadline', 'author', 'other'] with '' the untagged title
        (region_ground_truth_generator.py:329-339)."""
        return self.get_heading_regions_list("heading", heading_region_types)

    def get_caption_text_regions(self) -> List[list]:
        """Caption regions through the image-intersection filter
        (region_ground_truth_generator.py:335-341)."""
        return self.get_valid_text_regions(
            region_types=[TextRegionTypes.CAPTION])

    def create_ground_truth_json(self, save_folder: str) -> str:
        """Region polygons per page as JSON (region_ground_truth_generator.py:
        62-139)."""
        os.makedirs(save_folder, exist_ok=True)
        out_path = os.path.join(save_folder, "regions_gt.json")
        data = {}
        for img_path, page in zip(self.img_path_lst, self.page_object_lst):
            page_entry = {}
            for region_type, regions in page.get_regions().items():
                page_entry[region_type] = [
                    {"id": r.id, "points": r.points.points_list}
                    for r in regions]
            data[os.path.basename(img_path)] = page_entry
        with open(out_path, "w") as f:
            json.dump(data, f)
        return out_path


# ---------------------------------------------------------------- AS GT

def create_baseline_gt_img(article_dict, sc_factor, img_width, img_height,
                           line_width: int = 7) -> np.ndarray:
    """Baseline GT channel (run_as_gt_generation.py:163-176)."""
    polys = []
    for textlines in article_dict.values():
        for tl in textlines:
            if tl.baseline is None:
                continue
            polys.append([(x * sc_factor, y * sc_factor)
                          for x, y in tl.baseline.points_list])
    return plot_polys_binary(polys, img_width, img_height, closed=False,
                             line_width=line_width)


def create_article_polygon_gt_img(surr_polys_dict, sc_factor, img_width,
                                  img_height, fill_articles: bool = False) -> np.ndarray:
    """Article-boundary GT channel (run_as_gt_generation.py:179-199)."""
    polys = []
    for article_polys in surr_polys_dict.values():
        for poly in article_polys:
            pts = poly.as_list() if hasattr(poly, "as_list") else list(poly)
            polys.append([(x * sc_factor, y * sc_factor) for x, y in pts])
    return plot_polys_binary(polys, img_width, img_height, closed=True,
                             fill_polygons=fill_articles)


def apply_dilation(img: np.ndarray, kernel=(3, 3),
                   device: DeviceLike = "cuda") -> np.ndarray:
    """Thicken GT strokes on ``device`` (run_as_gt_generation.py:140-160)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.asarray(img, np.float32)).to(dev)
    return dilate(x, kernel[0], kernel[1]).to(torch.uint8).cpu().numpy()


def generate_as_ground_truth(page_path: str, image_path: Optional[str] = None,
                             save_folder: Optional[str] = None,
                             scaling_factor: float = 1.0,
                             fill_articles: bool = False,
                             with_baseline_gt: bool = True,
                             dilation_kernel=(3, 3),
                             device: DeviceLike = "cuda") -> Dict[str, np.ndarray]:
    """AS GT for one page (run_as_gt_generation.py main flow): article
    surrounding polygons from the rectangle machinery -> article GT channel
    (+ optional baseline channel) + 'other' complement, dilated on
    ``device``. Saves <name>_GT{i}_<channel>.png under save_folder if given;
    returns the channels."""
    from citlab_as_tpu_torch.stages.article_rectangles import (
        get_article_rectangles_from_baselines, merge_article_rectangles_vertically,
    )

    page = Page(page_path)
    if image_path is None:
        image_path = get_img_from_page_path(page_path)
    img_w, img_h = page.get_image_resolution()
    out_w, out_h = int(img_w * scaling_factor), int(img_h * scaling_factor)

    dev = resolve_device(device)
    ar_dict = get_article_rectangles_from_baselines(page, image_path, device=dev)
    surr_polys_dict = merge_article_rectangles_vertically(ar_dict)

    channels: Dict[str, np.ndarray] = {}
    article_img = create_article_polygon_gt_img(
        surr_polys_dict, scaling_factor, out_w, out_h, fill_articles)
    channels["article"] = apply_dilation(article_img, dilation_kernel, dev)
    if with_baseline_gt:
        baseline_img = create_baseline_gt_img(
            page.get_article_dict(), scaling_factor, out_w, out_h)
        channels["baseline"] = apply_dilation(baseline_img, dilation_kernel, dev)
    channels["other"] = create_other_ground_truth_image(
        *[channels[k] for k in channels])

    if save_folder:
        os.makedirs(save_folder, exist_ok=True)
        base = os.path.splitext(os.path.basename(image_path))[0]
        for i, (name, img) in enumerate(channels.items()):
            save_png(os.path.join(save_folder, f"{base}_GT{i}_{name}.png"), img)
    return channels


# ---------------------------------------------------------------- text export

def create_text_file_from_page(page, path_to_save_file: Optional[str] = None
                               ) -> Dict[str, str]:
    """Concatenate each article's text (article_text_files_generation.py:9-27);
    writes <save>/<article_id>.txt files when a folder is given."""
    if not isinstance(page, Page):
        page = Page(page)
    article_texts = {}
    for article_id, textlines in page.get_article_dict().items():
        text = "\n".join(tl.text for tl in textlines if tl.text)
        article_texts[str(article_id)] = text
    if path_to_save_file:
        os.makedirs(path_to_save_file, exist_ok=True)
        for article_id, text in article_texts.items():
            with open(os.path.join(path_to_save_file, f"{article_id}.txt"), "w") as f:
                f.write(text)
    return article_texts


def create_text_files_from_page_list(page_list, path_to_save_folder=None):
    out = {}
    for page_path in page_list:
        folder = None
        if path_to_save_folder:
            folder = os.path.join(
                path_to_save_folder,
                os.path.splitext(os.path.basename(page_path))[0])
        out[page_path] = create_text_file_from_page(page_path, folder)
    return out
