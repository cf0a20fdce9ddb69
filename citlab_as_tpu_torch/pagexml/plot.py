"""PAGE-XML visualisation (port of ``citlab_as_tpu/pagexml/plot.py``;
reference: python_util/parser/xml/page/plot.py).

The JAX module draws with matplotlib; the port draws on its own raster
(``utils/draw.py``, PIL's rasteriser bit for bit) and writes PNG files with
``utils/io.py::save_png``. The API and the semantics are the JAX module's:
baselines coloured per article (``article_color_map``), region outlines per
region type (``REGION_COLORS``), optionally filled with alpha, the page
image behind them, ``use_page_image_resolution``, HYP and GT side by side
(``plot_list``) and a folder's pages (``plot_folder``).

Where the JAX functions take and return a matplotlib ``Axes``, these take
and return a :class:`Canvas`: the list of :class:`PlotItem` s drawn on it
(each polygon's points, RGBA colour with its alpha, closed flag, line width
and fill flag, as matplotlib's ``PolyCollection`` holds them), with the
background, the size and the legend beside. :meth:`Canvas.render` composes
the RGB raster: every item is rasterised as a mask (outline ``round(linewidth)``
pixels wide, at least 1, plus the interior when filled) and blended over
what is below it with its alpha.

The port has no font rasteriser, so a legend is not drawn into the image:
``save`` writes it beside the PNG as ``<name>_legend.json`` (article id ->
colour name), and a side-by-side plot's as ``{"HYP": {...}, "GT": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.pagexml.page import Page
from citlab_as_tpu_torch.utils import draw
from citlab_as_tpu_torch.utils.colors import COLORS, DEFAULT_COLOR, to_rgba
from citlab_as_tpu_torch.utils.io import get_page_path, load_image, save_png

REGION_COLORS = {
    "TextRegion": "tab:blue",
    "SeparatorRegion": "tab:red",
    "ImageRegion": "tab:green",
    "GraphicRegion": "tab:olive",
    "TableRegion": "tab:purple",
    "AdvertRegion": "tab:orange",
    "NoiseRegion": "tab:gray",
    "UnknownRegion": "tab:brown",
}


class PlotItem(NamedTuple):
    """One drawn polygon: [(x, y), ...] float points, the RGBA colour of
    its edge (and face, when filled) with the alpha applied, whether the
    outline closes, its width in pixels-as-points and whether it is
    filled."""
    points: List[Tuple[float, float]]
    rgba: Tuple[float, float, float, float]
    closed: bool
    linewidth: float
    filled: bool


class Canvas(list):
    """A page plot: the list of :class:`PlotItem` s drawn, in order, on a
    ``background`` (a grey [H, W] uint8 page image, or white when None) of
    ``size`` = (width, height), with an optional ``title`` and ``legend``
    (label -> colour name)."""

    def __init__(self):
        super().__init__()
        self.background: Optional[np.ndarray] = None
        self.size: Optional[Tuple[int, int]] = None
        self.title: Optional[str] = None
        self.legend: Optional[Dict[str, str]] = None

    def extent(self) -> Tuple[int, int]:
        """(width, height) of the raster: ``size``, else the background's,
        else the bounding box of the items from the origin."""
        if self.size is not None:
            return self.size
        if self.background is not None:
            return self.background.shape[1], self.background.shape[0]
        pts = [p for item in self for p in item.points]
        if not pts:
            return 1, 1
        return (int(max(x for x, _ in pts)) + 1, int(max(y for _, y in pts)) + 1)

    def render(self) -> np.ndarray:
        """The RGB uint8 [H, W, 3] raster of the plot."""
        w, h = self.extent()
        out = np.full((h, w, 3), 255.0, np.float32)
        if self.background is not None:
            bh, bw = self.background.shape[:2]
            ch, cw = min(h, bh), min(w, bw)
            out[:ch, :cw] = self.background[:ch, :cw, None]
        for item in self:
            mask = draw.new_canvas(w, h)
            if item.filled and len(item.points) >= 2:
                draw.polygon(mask, item.points, 255)
            pts = list(item.points) + ([item.points[0]] if item.closed else [])
            draw.line(mask, pts, 255, width=max(1, int(round(item.linewidth))))
            r, g, b, a = item.rgba
            on = mask > 0
            out[on] = out[on] * (1.0 - a) + a * 255.0 * np.asarray((r, g, b), np.float32)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)

    def save(self, path: str) -> str:
        """Write the raster as a PNG at ``path`` and, with a legend, the
        legend as ``<path without extension>_legend.json``."""
        save_png(path, self.render())
        if self.legend:
            _write_legend(path, self.legend)
        return path


def _write_legend(png_path: str, legend) -> None:
    with open(os.path.splitext(png_path)[0] + "_legend.json", "w") as f:
        json.dump(legend, f, indent=1)


def compare_article_ids(a: Optional[str], b: Optional[str]) -> int:
    """Sort key comparator for article ids ('a1' < 'a2' < ... < None)."""
    if a == b:
        return 0
    if a is None:
        return 1
    if b is None:
        return -1
    na = re.sub(r"\D", "", a)
    nb = re.sub(r"\D", "", b)
    if na and nb and na != nb:
        return -1 if int(na) < int(nb) else 1
    return -1 if a < b else 1


def article_color_map(article_ids: Sequence[Optional[str]]) -> Dict[Optional[str], str]:
    """Stable article-id -> colour assignment (None = default colour)."""
    unique = sorted({a for a in article_ids},
                    key=functools.cmp_to_key(compare_article_ids))
    colors = {}
    idx = 0
    for a in unique:
        if a is None:
            colors[a] = DEFAULT_COLOR
        else:
            colors[a] = COLORS[idx % len(COLORS)]
            idx += 1
    return colors


def add_image(axes: Canvas, path: str) -> np.ndarray:
    """Use the page image (grey) as the plot's background (plot.py:68-85)."""
    img = load_image(path, mode="L")
    axes.background = np.asarray(img, np.uint8)
    return img


def add_polygons(axes: Canvas, poly_list, color=DEFAULT_COLOR, closed=False,
                 linewidth=1.2, alpha=1.0, filled=False) -> Optional[List[PlotItem]]:
    """Add a list of [(x, y), ...] polygons to the canvas (plot.py:88-104);
    polygons of fewer than 2 points are skipped. Returns the items added,
    None when there are none (the JAX function's collection)."""
    rgba = to_rgba(color, alpha)
    items = [PlotItem([(float(x), float(y)) for x, y in p], rgba, bool(closed),
                      float(linewidth), bool(filled))
             for p in poly_list if len(p) >= 2]
    if not items:
        return None
    axes.extend(items)
    return items


def plot_ax(ax: Optional[Canvas] = None, img_path: str = "", baselines_list=None,
            surr_polys=None, bcolors=None, region_dict_poly=None,
            fill_regions: bool = False, plot_legend: bool = False,
            legend_map=None) -> Canvas:
    """Compose one page plot from pre-extracted geometry (plot.py:224-313)."""
    if ax is None:
        ax = Canvas()
    if img_path:
        add_image(ax, img_path)
    if baselines_list:
        bcolors = bcolors or [DEFAULT_COLOR] * len(baselines_list)
        for baseline, color in zip(baselines_list, bcolors):
            add_polygons(ax, [baseline], color=color, linewidth=1.8)
    if surr_polys:
        bcolors = bcolors or [DEFAULT_COLOR] * len(surr_polys)
        for poly, color in zip(surr_polys, bcolors):
            add_polygons(ax, [poly], color=color, closed=True, alpha=0.7)
    if region_dict_poly:
        for region_name, polys in region_dict_poly.items():
            color = REGION_COLORS.get(region_name, "tab:cyan")
            add_polygons(ax, polys, color=color, closed=True,
                         alpha=0.3 if fill_regions else 0.9, filled=fill_regions)
    if plot_legend and legend_map:
        ax.legend = {str(a): c for a, c in legend_map.items()}
    return ax


def plot_pagexml(page, path_to_img: str = "", ax: Optional[Canvas] = None,
                 plot_article: bool = True, plot_legend: bool = False,
                 fill_regions: bool = False, use_page_image_resolution: bool = False,
                 save_path: Optional[str] = None) -> Canvas:
    """Plot a PAGE-XML file or Page object (plot.py:316-404): baselines
    coloured per article, region outlines, optional legend. Without a page
    image or with ``use_page_image_resolution`` the raster has the page's
    resolution (the JAX plot's axis limits)."""
    if not isinstance(page, Page):
        page = Page(page)

    baselines, article_ids = [], []
    for tl in page.get_textlines():
        if tl.baseline is None:
            continue
        baselines.append(tl.baseline.points_list)
        article_ids.append(tl.get_article_id() if plot_article else None)

    color_map = article_color_map(article_ids)
    bcolors = [color_map[a] for a in article_ids]
    region_dict_poly = {
        name: [r.points.points_list for r in regions]
        for name, regions in page.get_regions().items()}

    ax = plot_ax(ax=ax, img_path=path_to_img, baselines_list=baselines,
                 bcolors=bcolors, region_dict_poly=region_dict_poly,
                 fill_regions=fill_regions, plot_legend=plot_legend,
                 legend_map=color_map if plot_article else None)
    if use_page_image_resolution or (not path_to_img and ax.background is None):
        ax.size = tuple(page.get_image_resolution())
    if save_path:
        ax.save(save_path)
    return ax


def _side_by_side(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    h = max(left.shape[0], right.shape[0])
    out = np.full((h, left.shape[1] + right.shape[1], 3), 255, np.uint8)
    out[:left.shape[0], :left.shape[1]] = left
    out[:right.shape[0], left.shape[1]:] = right
    return out


def plot_list(img_lst: Sequence[str], hyp_lst: Sequence[str],
              gt_lst: Optional[Sequence[str]] = None, plot_article=True,
              plot_legend=False, out_dir: Optional[str] = None) -> List[str]:
    """Plot hypothesis (and, with ``gt_lst``, GT on its right) pages for a
    list of images (plot.py:407-531); returns the written PNG paths
    (``<out_dir>/<image name>.png``) when ``out_dir`` is given."""
    saved = []
    for i, (img_path, hyp_path) in enumerate(zip(img_lst, hyp_lst)):
        hyp = plot_pagexml(hyp_path, img_path, plot_article=plot_article,
                           plot_legend=plot_legend)
        hyp.title = "HYP"
        gt = None
        if gt_lst is not None:
            gt = plot_pagexml(gt_lst[i], img_path, plot_article=plot_article,
                              plot_legend=plot_legend)
            gt.title = "GT"
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.splitext(os.path.basename(img_path))[0] + ".png"
            path = os.path.join(out_dir, name)
            if gt is None:
                hyp.save(path)
            else:
                save_png(path, _side_by_side(hyp.render(), gt.render()))
                if hyp.legend or gt.legend:
                    _write_legend(path, {"HYP": hyp.legend or {}, "GT": gt.legend or {}})
            saved.append(path)
    return saved


def plot_folder(path_to_folder: str, plot_article=True, plot_legend=False,
                out_dir: Optional[str] = None) -> List[str]:
    """Plot every image with its page/<name>.xml in a folder (plot.py:534+)."""
    imgs = sorted(
        os.path.join(path_to_folder, f) for f in os.listdir(path_to_folder)
        if f.lower().endswith((".png", ".jpg", ".tif", ".jpeg")))
    hyps = [get_page_path(i) for i in imgs]
    pairs = [(i, h) for i, h in zip(imgs, hyps) if os.path.exists(h)]
    if not pairs:
        return []
    imgs, hyps = zip(*pairs)
    return plot_list(list(imgs), list(hyps), plot_article=plot_article,
                     plot_legend=plot_legend, out_dir=out_dir)
