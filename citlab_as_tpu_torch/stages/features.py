"""GNN feature generation stage (pipeline stage 4a; port of
``citlab_as_tpu/stages/features.py``).

Reference: gnn/input/feature_generation.py:18-911. Per page builds the graph
input JSON: nodes = TextRegions with a 15-d handcrafted feature vector
(region size/center 4-d, top+bottom baseline size/center 8-d, stroke width
1-d, text height 1-d — both page-max-normalized SWT features — heading flag
1-d); edges = Delaunay triangulation over 50-px-rounded region centers
(fully-connected for < 4 nodes); edge features = 2-d binary h/v separator
crossings ('bb' bounding-box rules or 'line' segment-intersection variant),
optionally the word-vector text-block similarity
(``stages/textblock_similarity.py``) and external (e.g. BERT) JSON features; GT
relations from per-region majority article ids. The output JSON schema and
default directory naming (json{n}{i}{e}{v}{sep}) match the reference so
downstream tooling interoperates.
"""
from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial import Delaunay
from scipy.spatial import QhullError

from citlab_as_tpu_torch.geometry.booleans import _any_segment_crossing
from citlab_as_tpu_torch.geometry.util import convex_hull, bounding_box
from citlab_as_tpu_torch.models.gnn.graph import fully_connected_edges
from citlab_as_tpu_torch.ops.swt import StrokeWidthDistanceTransform
from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.utils.io import get_img_from_page_path, load_image
from citlab_as_tpu_torch.utils.mathutil import round_by_base

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------- helpers

def get_bounding_box(points):
    """(min_x, max_x, min_y, max_y) over [N, 2] points — an array or a list
    of (x, y) pairs. Plain min/max: the point lists here are tiny (a few to
    a few dozen pairs) and numpy's asarray+reduction overhead dominated this
    helper (called for every region pair of the edge-feature rules)."""
    if isinstance(points, np.ndarray):
        points = points.tolist()
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return (min(xs), max(xs), min(ys), max(ys))


def line_poly_intersection(p1, p2, polygon) -> bool:
    """True if segment (p1, p2) intersects any edge of ``polygon``
    (feature_generation.py:296-308)."""
    poly = list(polygon)
    if poly[0] != poly[-1]:
        poly.append(poly[0])
    seg_a = np.array([[p1[0], p1[1], p2[0], p2[1]]], np.float64)
    segs_b = np.array(
        [[poly[i][0], poly[i][1], poly[i + 1][0], poly[i + 1][1]]
         for i in range(len(poly) - 1)], np.float64)
    return _any_segment_crossing(seg_a, segs_b)


def line_in_bounding_box(p1, p2, min_x, max_x, min_y, max_y) -> bool:
    x1, x2 = min(p1[0], p2[0]), max(p1[0], p2[0])
    y1, y2 = min(p1[1], p2[1]), max(p1[1], p2[1])
    return x1 > min_x and x2 < max_x and y1 > min_y and y2 < max_y


def _separator_orientation(separator_region, bb_sep) -> str:
    orientation = separator_region.get_orientation()
    if orientation is None:
        width = max(bb_sep[1] - bb_sep[0], 1)
        height = max(bb_sep[3] - bb_sep[2], 1)
        orientation = "horizontal" if float(height) / float(width) < 5 else "vertical"
    return orientation


# ---------------------------------------------------------------- node feats

def get_text_region_geometric_features(text_region, norm_x, norm_y) -> List[float]:
    """4-d: bbox size (w, h) + center (x, y), image-normalized
    (feature_generation.py:18-44)."""
    min_x, max_x, min_y, max_y = get_bounding_box(
        text_region.points.points_list)
    return [(float(max_x) - float(min_x)) / norm_x,
            (float(max_y) - float(min_y)) / norm_y,
            (min_x + max_x) / (2 * norm_x),
            (min_y + max_y) / (2 * norm_y)]


def get_text_region_baseline_features(text_region, norm_x, norm_y) -> List[float]:
    """8-d: size+center of the top and bottom baseline
    (feature_generation.py:47-81)."""
    feature = []
    top = text_region.text_lines[0].baseline
    bottom = text_region.text_lines[-1].baseline
    for baseline in (top, bottom):
        min_x, max_x, min_y, max_y = get_bounding_box(baseline.points_list)
        feature.extend([
            (float(max_x) - float(min_x)) / norm_x,
            (float(max_y) - float(min_y)) / norm_y,
            (min_x + max_x) / (2 * norm_x),
            (min_y + max_y) / (2 * norm_y)])
    return feature


def get_textline_stroke_widths_heights(page_path, text_lines,
                                       img_path: Optional[str] = None,
                                       image: Optional[np.ndarray] = None,
                                       precomputed: Optional[dict] = None):
    """SWT stroke width / text height per text line
    (feature_generation.py:105-159).

    ``precomputed``: {line_id: ((x, y, w, h), sw, th)} saved by the heading
    stage (same quantities for the same lines) — when every line matches by
    id AND bbox, they are reused and no image is read. Otherwise (a line
    without saved features, a changed bbox, or no heading stage run) the
    page's Otsu binarization and distance transform run on the host
    (``ops/swt.py``), as the JAX package's feature stage runs them: it builds
    its SWT with ``on_device=False``, which takes the host branch."""
    if precomputed is not None:
        stroke_widths, heights = {}, {}
        for text_line in text_lines:
            entry = precomputed.get(text_line.id)
            if entry is None:
                break
            min_x, max_x, min_y, max_y = get_bounding_box(
                text_line.surr_p.points_list)
            # the heading stage keys its saved features by the Rectangle
            # bbox (w = max - min + 1); its SWT crop is thus one row/col
            # larger than this stage's own max - min convention (the
            # reference's two stages differ the same way:
            # heading_net_post_processor.py:219 vs
            # feature_generation.py:105-159). Reusing the heading values
            # trades that one-pixel crop difference for skipping a full
            # host distance transform per page (DEVIATIONS #9).
            if tuple(entry[0]) != (min_x, min_y, max_x - min_x + 1,
                                   max_y - min_y + 1):
                break   # line geometry changed since heading: recompute
            stroke_widths[text_line.id] = entry[1]
            heights[text_line.id] = entry[2]
        else:
            return stroke_widths, heights

    swt = StrokeWidthDistanceTransform(dark_on_bright=True)
    if image is None:
        if img_path is None:
            img_path = get_img_from_page_path(page_path)
        image = load_image(img_path, mode="L")
    swt_img = swt.distance_transform(image, cache_key=img_path)
    stroke_widths, heights = {}, {}
    for text_line in text_lines:
        min_x, max_x, min_y, max_y = get_bounding_box(
            text_line.surr_p.points_list)
        sw, th = swt.textline_features(
            swt_img, (min_x, min_y, max_x - min_x, max_y - min_y))
        stroke_widths[text_line.id] = sw
        heights[text_line.id] = th
    return stroke_widths, heights


def get_text_region_stroke_width_feature(text_region, textline_stroke_widths,
                                         norm: float = 1.0) -> List[float]:
    """1-d: max line stroke width / page max (feature_generation.py:162-184)."""
    if all(not line.text for line in text_region.text_lines):
        return [0.0]
    vals = [textline_stroke_widths[line.id]
            for line in text_region.text_lines if line.text]
    return [float(np.max(vals)) / norm]


def get_text_region_text_height_feature(text_region, textline_heights,
                                        norm: float = 1.0) -> List[float]:
    if all(not line.text for line in text_region.text_lines):
        return [0.0]
    vals = [textline_heights[line.id]
            for line in text_region.text_lines if line.text]
    return [float(np.max(vals)) / norm]


def get_text_region_heading_feature(text_region) -> List[float]:
    return [float(text_region.region_type.lower() == "heading")]


# ---------------------------------------------------------------- edge feats

def get_edge_separator_feature_bb(text_region_a, text_region_b,
                                  separator_regions) -> List[float]:
    """2-d binary (horizontal, vertical) separation via bbox rules
    (feature_generation.py:319-398)."""
    bb_a = get_bounding_box(text_region_a.points.points_list)
    bb_b = get_bounding_box(text_region_b.points.points_list)
    horizontally, vertically = False, False
    for sep in separator_regions:
        bb_sep = get_bounding_box(sep.points.points_list)
        orientation = _separator_orientation(sep, bb_sep)
        if orientation == "vertical":
            if is_vertically_separated(*bb_a, *bb_b, *bb_sep):
                vertically = True
        else:
            if is_horizontally_separated(*bb_a, *bb_b, *bb_sep):
                horizontally = True
        if horizontally and vertically:
            break
    return [float(horizontally), float(vertically)]


def get_edge_separator_feature_line(text_region_a, text_region_b,
                                    separator_regions) -> List[float]:
    """2-d binary separation via center-segment intersection
    (feature_generation.py:221-286). Note: the reference's vertical branch
    compares the region OBJECT to the string 'vertical' (always False),
    pushing vertical separators into the ratio fallback; we implement the
    evidently-intended orientation check."""
    bb_a = get_bounding_box(text_region_a.points.points_list)
    bb_b = get_bounding_box(text_region_b.points.points_list)
    center_a = ((bb_a[0] + bb_a[1]) / 2, (bb_a[2] + bb_a[3]) / 2)
    center_b = ((bb_b[0] + bb_b[1]) / 2, (bb_b[2] + bb_b[3]) / 2)
    horizontally, vertically = False, False
    for sep in separator_regions:
        pts = sep.points.points_list
        bb_sep = get_bounding_box(pts)
        min_x_s, max_x_s, min_y_s, max_y_s = bb_sep
        corner_poly = [(min_x_s, min_y_s), (max_x_s, min_y_s),
                       (min_x_s, max_y_s), (max_x_s, max_y_s)]
        if (line_poly_intersection(center_a, center_b, corner_poly)
                or line_in_bounding_box(center_a, center_b, *bb_sep)):
            if line_poly_intersection(center_a, center_b, list(pts)):
                orientation = _separator_orientation(sep, bb_sep)
                if orientation == "horizontal":
                    horizontally = True
                else:
                    vertically = True
                if horizontally and vertically:
                    break
    return [float(horizontally), float(vertically)]


def is_vertically_separated(min_x_a, max_x_a, min_y_a, max_y_a,
                            min_x_b, max_x_b, min_y_b, max_y_b,
                            min_x_sep, max_x_sep, min_y_sep, max_y_sep) -> bool:
    """bbox rule (feature_generation.py:376-388)."""
    mean_x_sep = (min_x_sep + max_x_sep) / 2
    if not ((max_x_a <= mean_x_sep <= min_x_b) or (max_x_b <= mean_x_sep <= min_x_a)):
        return False
    if not ((max_y_a >= min_y_sep and min_y_a <= max_y_sep)
            or (max_y_b >= min_y_sep and min_y_b <= max_y_sep)):
        return False
    return True


def is_horizontally_separated(min_x_a, max_x_a, min_y_a, max_y_a,
                              min_x_b, max_x_b, min_y_b, max_y_b,
                              min_x_sep, max_x_sep, min_y_sep, max_y_sep) -> bool:
    """bbox rule (feature_generation.py:391-405)."""
    mean_y_sep = (min_y_sep + max_y_sep) / 2
    if not ((min_y_a <= mean_y_sep <= max_y_b) or (min_y_b <= mean_y_sep <= max_y_a)):
        return False
    if ((max_x_a <= min_x_sep and max_x_b <= min_x_sep)
            or (min_x_a >= max_x_sep and min_x_b >= max_x_sep)):
        return False
    return True


def is_aligned_horizontally_separated(text_region_a, text_region_b,
                                      separator_regions) -> bool:
    """Horizontal separation under vertical alignment
    (feature_generation.py:401-438); used for confidence masking."""
    bb_a = get_bounding_box(text_region_a.points.points_list)
    bb_b = get_bounding_box(text_region_b.points.points_list)
    min_x_a, max_x_a, min_y_a, max_y_a = bb_a
    min_x_b, max_x_b, min_y_b, max_y_b = bb_b
    for sep in separator_regions:
        bb_s = get_bounding_box(sep.points.points_list)
        if _separator_orientation(sep, bb_s) == "vertical":
            continue
        min_x_s, max_x_s, min_y_s, max_y_s = bb_s
        mean_y_sep = (min_y_s + max_y_s) / 2
        if not ((min_y_a <= mean_y_sep <= max_y_b) or (min_y_b <= mean_y_sep <= max_y_a)):
            continue
        if not ((max_x_a >= min_x_s and max_x_b >= min_x_s)
                and (min_x_a <= max_x_s and min_x_b <= max_x_s)):
            continue
        return True
    return False


def is_aligned_heading_separated(text_region_a, text_region_b) -> bool:
    """Heading-below rule for confidence masking (feature_generation.py:441-471)."""
    heading_a = text_region_a.region_type.lower() == "heading"
    heading_b = text_region_b.region_type.lower() == "heading"
    if heading_a == heading_b:
        return False
    bb_a = get_bounding_box(text_region_a.points.points_list)
    bb_b = get_bounding_box(text_region_b.points.points_list)
    min_x_a, max_x_a, min_y_a, max_y_a = bb_a
    min_x_b, max_x_b, min_y_b, max_y_b = bb_b
    if not (min_x_a <= max_x_b and min_x_b <= max_x_a):
        return False
    if heading_a and not (min_y_a >= max_y_b):
        return False
    if heading_b and not (min_y_b >= max_y_a):
        return False
    return True


# ---------------------------------------------------------------- edges

def delaunay_edges(num_nodes: int, node_positions: np.ndarray) -> np.ndarray:
    """Delaunay neighbors over 50-px-rounded centers
    (feature_generation.py:512-535)."""
    smoothed = round_by_base(node_positions, base=50)
    try:
        delaunay = Delaunay(smoothed)
    except QhullError:
        logger.warning("Delaunay degenerate on smoothed positions; using raw.")
        delaunay = Delaunay(node_positions)
    indptr, indices = delaunay.vertex_neighbor_vertices
    out = []
    for v in range(num_nodes):
        neighbors = indices[indptr[v]:indptr[v + 1]]
        out.append(np.stack(np.broadcast_arrays(v, neighbors), axis=1))
    return np.concatenate(out, axis=0).astype(np.int32)


# ---------------------------------------------------------------- visual

def get_node_visual_region(text_region):
    return bounding_box(text_region.points.points_list)


def get_edge_visual_region(text_region_a, text_region_b):
    return convex_hull(list(text_region_a.points.points_list)
                       + list(text_region_b.points.points_list))


# ---------------------------------------------------------------- page level

def discard_text_regions_and_lines(text_regions, text_lines=None):
    """Drop regions without lines or with tiny bboxes, and their lines
    (feature_generation.py:566-592)."""
    discard = 0
    lines_to_remove = []
    for tr in list(text_regions):
        if not tr.text_lines:
            text_regions.remove(tr)
            discard += 1
            continue
        bb = tr.points.to_polygon().get_bounding_box()
        if bb.width < 10 or bb.height < 10:
            text_regions.remove(tr)
            if text_lines:
                lines_to_remove.extend(tl.id for tl in tr.text_lines)
            discard += 1
    if lines_to_remove:
        text_lines = [l for l in text_lines if l.id not in lines_to_remove]
    if discard:
        logger.warning("Discarded %d degenerate text region(s).", discard)
    return text_regions, text_lines


def build_input_and_target(page_path: str,
                           interaction: str = "delaunay",
                           visual_regions: bool = False,
                           external_data: Optional[list] = None,
                           sim_feat_extractor=None,
                           separators: str = "bb",
                           image: Optional[np.ndarray] = None,
                           img_path: Optional[str] = None,
                           precomputed_swt: Optional[dict] = None) -> Optional[dict]:
    """Graph input + GT for one page (feature_generation.py:594-813).
    Returns a dict with the reference's JSON schema keys, or None when the
    page has < 2 usable regions."""
    assert interaction in ("fully", "delaunay")

    page_file = Page(page_path)
    regions = page_file.get_regions()
    text_lines = page_file.textlines   # snapshot: shared across stages
    norm_x, norm_y = (float(v) for v in page_file.get_image_resolution())

    text_regions = regions.get("TextRegion")
    if not text_regions:
        logger.warning("No TextRegions found in %s.", page_path)
        return None
    text_regions, text_lines = discard_text_regions_and_lines(text_regions, text_lines)

    num_nodes = len(text_regions)
    if num_nodes <= 1:
        logger.warning("Less than two nodes found in %s.", page_path)
        return None

    stroke_widths, heights = get_textline_stroke_widths_heights(
        page_path, text_lines, img_path=img_path, image=image,
        precomputed=precomputed_swt)
    sw_max = max(stroke_widths.values()) if stroke_widths else 1.0
    th_max = max(heights.values()) if heights else 1.0
    sw_max = sw_max or 1.0
    th_max = th_max or 1.0

    page_basename = os.path.basename(page_path)

    node_features = []
    for tr in text_regions:
        feat = []
        feat.extend(get_text_region_geometric_features(tr, norm_x, norm_y))
        feat.extend(get_text_region_baseline_features(tr, norm_x, norm_y))
        feat.extend(get_text_region_stroke_width_feature(tr, stroke_widths, norm=sw_max))
        feat.extend(get_text_region_text_height_feature(tr, heights, norm=th_max))
        feat.extend(get_text_region_heading_feature(tr))
        if external_data:
            for ext in external_data:
                ext_page = ext.get(page_basename)
                if ext_page is None:
                    continue
                if "node_features" in ext_page:
                    nf = ext_page["node_features"]
                    feat.extend(nf.get(tr.id, [nf.get("default", 0.0)]))
        node_features.append(feat)

    if interaction == "fully" or num_nodes < 4:
        interacting_nodes = fully_connected_edges(num_nodes)
    else:
        centers = np.array(node_features, np.float32)[:, 2:4] * [norm_x, norm_y]
        interacting_nodes = delaunay_edges(num_nodes, centers)
    num_interacting_nodes = interacting_nodes.shape[0]

    tb_sim_dict = None
    if sim_feat_extractor is not None:
        tb_dict = {tr.id: "\n".join(tl.text for tl in tr.text_lines)
                   for tr in text_regions}
        sim_feat_extractor.set_tb_dict(tb_dict)
        sim_feat_extractor.run()
        tb_sim_dict = sim_feat_extractor.feature_dict

    separator_regions = regions.get("SeparatorRegion")

    edge_features = []
    for i in range(num_interacting_nodes):
        feat = []
        a, b = interacting_nodes[i]
        tr_a, tr_b = text_regions[a], text_regions[b]
        if separator_regions:
            if separators == "line":
                feat.extend(get_edge_separator_feature_line(tr_a, tr_b, separator_regions))
            else:
                feat.extend(get_edge_separator_feature_bb(tr_a, tr_b, separator_regions))
        else:
            feat.extend([0.0, 0.0])
        if tb_sim_dict:
            ef = tb_sim_dict["edge_features"]
            try:
                feat.extend(ef[tr_a.id][tr_b.id])
            except KeyError:
                feat.extend(ef.get("default", [0.5]))
        if external_data:
            for ext in external_data:
                ext_page = ext.get(page_basename)
                if ext_page is None or "edge_features" not in ext_page:
                    continue
                ef = ext_page["edge_features"]
                try:
                    feat.extend(ef[tr_a.id][tr_b.id])
                except (KeyError, TypeError):
                    feat.extend(ef.get("default", [0.5]))
        edge_features.append(feat)

    out: Dict[str, object] = {
        "num_nodes": int(num_nodes),
        "interacting_nodes": interacting_nodes.tolist(),
        "num_interacting_nodes": int(num_interacting_nodes),
        "node_features": [[float(v) for v in f] for f in node_features],
        "edge_features": [[float(v) for v in f] for f in edge_features],
    }

    if visual_regions:
        vr_nodes = [get_node_visual_region(tr) for tr in text_regions]
        out["visual_regions_nodes"] = np.transpose(
            np.asarray(vr_nodes, np.float32), (0, 2, 1)).tolist()
        out["num_points_visual_regions_nodes"] = [len(v) for v in vr_nodes]

        vr_edges = []
        for i in range(num_interacting_nodes):
            a, b = interacting_nodes[i]
            vr_edges.append(get_edge_visual_region(text_regions[a], text_regions[b]))
        n_pts = [len(v) for v in vr_edges]
        arr = np.zeros((num_interacting_nodes, max(n_pts), 2), np.float32)
        for i, v in enumerate(vr_edges):
            arr[i, :len(v)] = v
        out["visual_regions_edges"] = np.transpose(arr, (0, 2, 1)).tolist()
        out["num_points_visual_regions_edges"] = n_pts

    # GT: majority article id per region -> same-article pairs
    tr_article_ids = []
    for tr in text_regions:
        ids = [tl.get_article_id() for tl in tr.text_lines]
        unique = list(set(ids))
        counts = [ids.count(u) for u in unique]
        tr_article_ids.append(unique[int(np.argmax(counts))])
    gt_relations = [[1, i, j]
                    for i, a in enumerate(tr_article_ids)
                    for j, b in enumerate(tr_article_ids) if a == b]
    out["gt_relations"] = gt_relations
    out["gt_num_relations"] = len(gt_relations)
    return out


def generate_feature_jsons(page_paths: Sequence[str],
                           out_path: Optional[str] = None,
                           interaction: str = "delaunay",
                           visual_regions: bool = True,
                           json_list: Optional[Sequence[str]] = None,
                           tb_similarity_setup=(None, None),
                           separators: str = "line",
                           image_paths: Optional[Sequence[str]] = None,
                           line_features: Optional[dict] = None) -> List[str]:
    """Write one graph-feature JSON per page (feature_generation.py:816-911).
    Returns the list of written paths. ``line_features``:
    {page_path: {line_id: (bbox, stroke_width, text_height)}} from the
    heading stage's device path — reused instead of recomputing the host
    distance transform (the two stages need the same per-line quantities,
    heading_net_post_processor.py:211-245 vs feature_generation.py:105-159)."""
    external = []
    if json_list:
        for json_path in json_list:
            with open(json_path) as f:
                external.append(json.load(f))

    sim_feat_extractor = None
    if tb_similarity_setup[0] and tb_similarity_setup[1]:
        from citlab_as_tpu_torch.stages.textblock_similarity import TextblockSimilarity
        sim_feat_extractor = TextblockSimilarity(
            language=tb_similarity_setup[0], wv_path=tb_similarity_setup[1])

    create_default_dir = out_path is None
    written, skipped = [], []
    start = time.time()
    for idx, page_path in enumerate(page_paths):
        logger.info("Processing... %s", page_path)
        # img_path only: get_textline_stroke_widths_heights loads the image
        # lazily iff the heading stage's precomputed per-line features miss
        # (id/bbox mismatch) — on the hit path the page image is never read
        img_path = image_paths[idx] if image_paths is not None else None
        out = build_input_and_target(
            page_path, interaction=interaction, visual_regions=visual_regions,
            external_data=external, sim_feat_extractor=sim_feat_extractor,
            separators=separators, img_path=img_path,
            precomputed_swt=(line_features or {}).get(page_path))
        if out is None:
            skipped.append(page_path)
            continue
        if create_default_dir:
            n_dim = len(out["node_features"][0])
            e_dim = len(out["edge_features"][0])
            visual = "v" if visual_regions else ""
            out_path = re.sub(
                r"page$", f"json{n_dim}{interaction[0]}{e_dim}{visual}{separators}",
                os.path.dirname(page_path))
        os.makedirs(out_path, exist_ok=True)
        file_name = os.path.splitext(os.path.basename(page_path))[0] + ".json"
        target = os.path.join(out_path, file_name)
        with open(target, "w") as f:
            # dumps() hits the C-accelerated encoder; dump() streams through
            # the pure-Python iterencode
            f.write(json.dumps(out))
        written.append(target)
    logger.info("Feature generation: %.2fs, wrote %d/%d files.",
                time.time() - start, len(written), len(page_paths))
    return written
