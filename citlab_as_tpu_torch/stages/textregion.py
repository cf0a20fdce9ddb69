"""Text region generation stage (pipeline stage 2b; port of
``citlab_as_tpu/stages/textregion.py``).

Reference: article_separation/textregion_generation/textregion_generation.py:
17-228. Per article (text lines sharing an article id): union of the normed
baselines plus copies shifted up by 0.95 * interline distance forms a point
cloud whose alpha-shape (alpha=75) boundary becomes the TextRegion polygon;
reading order of lines by baseline y-center; lines lacking a surrounding
polygon get a synthetic one from the shifted baseline. The normalization,
the interline distances and the alpha shapes run in the port's host C++
library (``geometry/native.py``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import xml.etree.ElementTree as etree

from citlab_as_tpu_torch.geometry import native
from citlab_as_tpu_torch.geometry.polygon import Polygon
from citlab_as_tpu_torch.geometry.util import alpha_shape
from citlab_as_tpu_torch.pagexml import Page, Points, TextRegion
from citlab_as_tpu_torch.pagexml import constants as C
from citlab_as_tpu_torch.pagexml.objects import (
    _append_text_equiv, _pc, format_custom_attr)
from citlab_as_tpu_torch.stages.baseline_clustering import get_list_of_interline_distances
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


def _shifted_cloud(normed_polygon: Polygon, interline_dist: float) -> Tuple[list, list]:
    """Baseline points + copies shifted (+1, -max(0.95*d, 1)) — the text-body
    band above the baseline (textregion_generation.py:59-73, 149-156)."""
    x_shifted = [x + 1 for x in normed_polygon.x_points]
    y_shift = max(int(0.95 * interline_dist), 1)
    y_shifted = [y - y_shift for y in normed_polygon.y_points]
    return x_shifted, y_shifted


def get_data_from_pagexml(path_to_pagexml: str, des_dist: int = 50,
                          max_d: int = 500) -> Tuple[dict, dict]:
    """Returns ({article_id: [text lines]}, {line_id: (normed_poly, dist)});
    synthesizes surrounding polygons for lines lacking one
    (textregion_generation.py:17-79)."""
    page_file = Page(path_to_pagexml)
    art_txtlines_dict = page_file.get_article_dict()

    lst_of_polygons = []
    lst_of_txtlines = []
    for txtline in page_file.textlines:   # snapshot: shared across stages
        if txtline.baseline is None:
            continue
        baseline = txtline.baseline.to_polygon()
        if baseline.n_points > 1:
            lst_of_polygons.append(baseline)
            lst_of_txtlines.append(txtline)

    lst_of_normed = native.norm_poly_dists(lst_of_polygons, des_dist)
    lst_of_dists = get_list_of_interline_distances(lst_of_polygons, max_d=max_d)

    txtline_dict = {}
    for i, txtline in enumerate(lst_of_txtlines):
        if txtline.surr_p is None:
            normed = lst_of_normed[i]
            x_shifted, y_shifted = _shifted_cloud(normed, lst_of_dists[i])
            sp_points = list(zip(normed.x_points + x_shifted[::-1],
                                 normed.y_points + y_shifted[::-1]))
            for article in art_txtlines_dict:
                for ref_txtline in art_txtlines_dict[article]:
                    if ref_txtline.id == txtline.id:
                        ref_txtline.surr_p = Points(sp_points)
                        ref_txtline._surr_p_synth = True
        txtline_dict[txtline.id] = (lst_of_normed[i], lst_of_dists[i])

    return art_txtlines_dict, txtline_dict


def txtlines_set_reading_order(lst_of_txtlines) -> None:
    """Reading order by baseline y-center (textregion_generation.py:82-99)."""
    centers = []
    for txtline in lst_of_txtlines:
        poly = txtline.baseline.to_polygon()
        centers.append((sum(poly.y_points) / len(poly.y_points), txtline))
    centers.sort(key=lambda c: c[0])
    for reading_order, (_, txtline) in enumerate(centers):
        txtline.custom["readingOrder"] = {"index": reading_order}


def create_text_regions(art_txtlines_dict: dict, txtline_dict: dict,
                        alpha: float = 75) -> Dict[str, tuple]:
    """{region_id: (boundary points, text lines, reading order)} via
    alpha-shape over the article's baseline cloud
    (textregion_generation.py:131-193). None-article lines become singleton
    regions."""
    out: Dict[str, tuple] = {}
    counter = 0

    def boundary_of(points: List[tuple]) -> List[list]:
        boundary = alpha_shape(np.array(points), alpha=alpha)
        return [[int(c) for c in p] for p in boundary]

    for article_id, txtlines in art_txtlines_dict.items():
        if article_id is None:
            for txtline in txtlines:
                if txtline.id not in txtline_dict:
                    continue
                normed, dist = txtline_dict[txtline.id]
                x_shifted, y_shifted = _shifted_cloud(normed, dist)
                pts = list(zip(normed.x_points + x_shifted,
                               normed.y_points + y_shifted))
                out[f"tr_{counter}"] = (boundary_of(pts), [txtline], counter)
                counter += 1
        else:
            pts: List[tuple] = []
            lst = []
            for txtline in txtlines:
                if txtline.id not in txtline_dict:
                    continue
                lst.append(txtline)
                normed, dist = txtline_dict[txtline.id]
                x_shifted, y_shifted = _shifted_cloud(normed, dist)
                pts += list(zip(normed.x_points + x_shifted,
                                normed.y_points + y_shifted))
            if not pts:
                continue
            out[f"tr_{counter}"] = (boundary_of(pts), lst, counter)
            counter += 1
    return out


def save_results_in_pagexml(path_to_pagexml: str, text_region_txtline_dict: dict,
                            reuse_line_nodes: bool = True) -> None:
    """Overwrite the page's TextRegions (textregion_generation.py:102-128).

    ``reuse_line_nodes``: the stage only mutates line CUSTOM attrs
    (readingOrder) — geometry/text/words are untouched — so the existing
    TextLine DOM nodes can be MOVED into the rebuilt region elements
    instead of re-serialized from the objects (the written bytes are the
    same, tested). Lines whose nodes are absent (or whose surr_p was
    synthesized this stage) fall back to object serialization per line.
    """
    page_file = Page(path_to_pagexml)
    regions = []
    for region_id, (boundary, txtlines, reading_order) in text_region_txtline_dict.items():
        txtlines_set_reading_order(txtlines)
        regions.append(TextRegion(
            _id=region_id, region_type="paragraph",
            custom={"readingOrder": {"index": reading_order}},
            points=boundary, text_lines=txtlines))
    if reuse_line_nodes:
        _rebuild_regions_moving_line_nodes(page_file, regions)
    else:
        page_file.set_text_regions(regions, overwrite=True)
    # the region tree was rebuilt from these same TextLine objects, so the
    # textlines snapshot can be refreshed without a DOM re-walk (saves the
    # next stage a full re-derivation). Serialization skips lines without a
    # surrounding polygon (TextLine.to_page_xml_node), mirrored here; the id
    # sequence check guards the exotic case of textlines living outside the
    # rebuilt TextRegions (e.g. table cells), where the refresh would lie.
    snap = [tl for _, (_, txtlines, _) in text_region_txtline_dict.items()
            for tl in txtlines if tl.surr_p]
    dom_ids = [nd.get("id") for nd in page_file.get_child_by_name(
        page_file.page_doc, "TextLine")]
    if dom_ids == [tl.id for tl in snap]:
        page_file.textlines = snap
    page_file.write_page_xml(path_to_pagexml)


def _rebuild_regions_moving_line_nodes(page_file, regions) -> None:
    """set_text_regions(regions, overwrite=True) twin that MOVES the
    existing TextLine DOM nodes into the new region elements instead of
    re-serializing them from the objects. Valid because this stage only
    changes line custom attrs (rewritten on the moved node); geometry,
    text and words are byte-identical to what object serialization would
    produce. A line falls back to object serialization when its node is
    missing, lacks a Coords child (surr_p then came from the Baseline
    fallback), or its surr_p was synthesized this stage.

    ElementTree has no parent pointers and ``append`` does not detach: a
    reused node is first removed from its old parent (the page's
    child-to-parent map), so that no node is ever in the tree twice, and
    the old regions go after the new ones are built."""
    id2nd = {nd.get("id"): nd
             for nd in page_file.get_child_by_name(page_file.page_doc,
                                                   C.TEXTLINE)}
    old_region_nds = page_file.get_child_by_name(page_file.page_doc,
                                                 C.TEXTREGION)
    page_nd = page_file.get_child_by_name(page_file.page_doc, "Page")[0]
    new_nds = []
    for tr in regions:
        # attribute/children order mirrors TextRegion.to_page_xml_node:
        # id, custom, type; Coords, lines, region TextEquiv
        nd = etree.Element(_pc(C.TEXTREGION))
        nd.set("id", str(tr.id))
        if tr.custom:
            nd.set(C.CUSTOM_ATTR, format_custom_attr(tr.custom))
        nd.set("type", tr.region_type)
        coords_nd = etree.SubElement(nd, _pc(C.COORDS))
        coords_nd.set(C.POINTS_ATTR, tr.points.to_string())
        texts = []
        for tl in tr.text_lines:
            if not tl.surr_p:
                continue
            ln = id2nd.get(tl.id)
            if (ln is None or getattr(tl, "_surr_p_synth", False)
                    or ln.find(_pc(C.COORDS)) is None):
                ln = tl.to_page_xml_node()
                if ln is None:
                    continue
            else:
                if tl.custom:
                    ln.set(C.CUSTOM_ATTR, format_custom_attr(tl.custom))
                else:
                    ln.attrib.pop(C.CUSTOM_ATTR, None)
                if ln.find(_pc(C.TEXTEQUIV)) is None:
                    _append_text_equiv(ln, tl.text)
                parent = page_file._parent_of(ln)
                if parent is not None:
                    parent.remove(ln)     # ElementTree's append does not detach
            nd.append(ln)
            texts.append(tl.text)
        region_text = "\n".join(t for t in texts if t)
        if region_text:
            _append_text_equiv(nd, region_text)
        new_nds.append(nd)
    for nd in old_region_nds:    # line nodes were moved out above
        parent = page_file._parent_of(nd)
        if parent is not None:
            parent.remove(nd)
    for nd in new_nds:
        page_nd.append(nd)
    page_file.mark_dom_mutated()


def _create_regions_fast(path_to_pagexml: str, des_dist: int, max_d: int,
                         alpha: float):
    """Packed-array twin of get_data_from_pagexml + create_text_regions:
    the normalized baselines stay (coords, offsets) arrays straight from the
    native kernel (no per-line Polygon objects), the shifted clouds are two
    numpy ops, and the interline distances come from ONE C call on the raw
    polygons. Point order is identical to the list path (normed points then
    shifted copies, lines in article order), so the alpha-shape boundaries —
    hence the written XML — are bit-identical. Returns the region dict."""
    page_file = Page(path_to_pagexml)
    art_dict = page_file.get_article_dict()

    polys, txtlines = [], []
    for txtline in page_file.textlines:   # snapshot: same objects as art_dict
        if txtline.baseline is None:
            continue
        baseline = txtline.baseline.to_polygon()
        if baseline.n_points > 1:
            polys.append(baseline)
            txtlines.append(txtline)

    clouds = {}
    if polys:
        dists = native.interline_distances_raw(polys, 5, max_d)
        nc, noff = native.norm_poly_dists_packed(polys, des_dist)
        for i, txtline in enumerate(txtlines):
            nci = nc[noff[i]:noff[i + 1]].astype(np.int64)
            y_shift = max(int(0.95 * dists[i]), 1)
            shifted = nci + np.asarray([1, -y_shift])
            clouds[txtline.id] = np.concatenate([nci, shifted])
            if txtline.surr_p is None:
                sp = np.concatenate([nci, shifted[::-1]])
                txtline.surr_p = Points([(int(x), int(y)) for x, y in sp])
                txtline._surr_p_synth = True

    out: Dict[str, tuple] = {}
    counter = 0

    def boundary_of(points: np.ndarray) -> List[list]:
        boundary = alpha_shape(points, alpha=alpha)
        return [[int(c) for c in p] for p in boundary]

    for article_id, arts in art_dict.items():
        if article_id is None:
            for txtline in arts:
                cloud = clouds.get(txtline.id)
                if cloud is None:
                    continue
                out[f"tr_{counter}"] = (boundary_of(cloud), [txtline], counter)
                counter += 1
        else:
            arrs, lst = [], []
            for txtline in arts:
                cloud = clouds.get(txtline.id)
                if cloud is None:
                    continue
                lst.append(txtline)
                arrs.append(cloud)
            if not arrs:
                continue
            out[f"tr_{counter}"] = (boundary_of(np.concatenate(arrs)),
                                    lst, counter)
            counter += 1
    return out


def generate_text_regions_for_page(path_to_pagexml: str, des_dist: int = 50,
                                   max_d: int = 100, alpha: float = 75) -> dict:
    """Full per-page flow (the run_textregion_generation per-file unit)."""
    region_dict = _create_regions_fast(path_to_pagexml, des_dist=des_dist,
                                       max_d=max_d, alpha=alpha)
    save_results_in_pagexml(path_to_pagexml, region_dict)
    return region_dict
