"""Article-rectangle GT machinery (port of
``citlab_as_tpu/stages/article_rectangles.py``).

Reference: article_separation/article_rectangle.py:14-306 and
article_separation/util/util.py:15-475. Produces per-article rectangle
covers of a page (greedy non-overlapping growth from baselines, or quad-tree
subdivision until article-pure), their orthogonal outlines and smoothed
surrounding polygons — the geometry behind AS ground-truth image generation.
The interline distances come from the port's host C++ geometry library;
the binarization of ``stretch`` runs its Otsu pass on ``device``.
"""
from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Set

from citlab_as_tpu_torch.device import DeviceLike
from citlab_as_tpu_torch.geometry.pairwise import calc_interline_distances
from citlab_as_tpu_torch.geometry.polygon import Polygon, norm_poly_dists
from citlab_as_tpu_torch.geometry.rectangle import Rectangle, merge_rectangles
from citlab_as_tpu_torch.geometry.util import (
    bounding_box, check_intersection, convex_hull, ortho_connect, polygon_clip,
    smooth_surrounding_polygon,
)
from citlab_as_tpu_torch.ops.image_utils import get_binarization, is_whitespace
from citlab_as_tpu_torch.pagexml import Page, Points


class ArticleRectangle(Rectangle):
    """Rectangle carrying its text lines + article-id set
    (article_rectangle.py:14-156)."""

    def __init__(self, x=0, y=0, width=0, height=0, textlines=None, article_ids=None):
        super().__init__(x, y, width, height)
        self.textlines = textlines
        if article_ids is None and textlines is not None:
            self.a_ids: Set = {tl.get_article_id() for tl in textlines}
        else:
            self.a_ids = article_ids if article_ids is not None else set()

    def contains_polygon(self, polygon: Polygon, x, y, width, height) -> bool:
        """True if any segment of ``polygon`` lies in / crosses the rect
        (article_rectangle.py:37-75)."""
        for i in range(polygon.n_points - 1):
            seg = [polygon.x_points[i:i + 2], polygon.y_points[i:i + 2]]
            if (max(seg[0]) <= x or min(seg[0]) >= x + width
                    or max(seg[1]) <= y or min(seg[1]) >= y + height):
                continue
            if (min(seg[0]) >= x and max(seg[0]) <= x + width
                    and min(seg[1]) >= y and max(seg[1]) <= y + height):
                return True
            for rect_seg in ([[x, x], [y, y + height]],
                             [[x + width, x + width], [y, y + height]],
                             [[x, x + width], [y, y]],
                             [[x, x + width], [y + height, y + height]]):
                if check_intersection(seg, rect_seg) is not None:
                    return True
        return False

    # ------------------------------------------------------------------
    def create_subregions_from_surrounding_polygon(self, ar_list=None,
                                                   des_dist=5, max_d=50,
                                                   max_rect_size=0) -> List["ArticleRectangle"]:
        """Recursive 4-way subdivision until each rectangle is article-pure
        (or below max_rect_size), article_rectangle.py:79-156."""
        if ar_list is None:
            ar_list = []
        width1 = self.width // 2
        width2 = self.width - width1
        height1 = self.height // 2
        height2 = self.height - height1

        quads = [
            Rectangle(self.x, self.y, width1, height1),
            Rectangle(self.x + width1, self.y, width2, height1),
            Rectangle(self.x, self.y + height1, width1, height2),
            Rectangle(self.x + width1, self.y + height1, width2, height2),
        ]
        tl_sets = [[] for _ in quads]
        id_sets = [set() for _ in quads]

        tl_list = self.initialize_gt_generation(des_dist, max_d)
        for tl, tl_bound, tl_id in tl_list:
            for q, quad in enumerate(quads):
                inter = tl_bound.intersection(quad)
                if inter.width > 0 and inter.height > 0:
                    tl_sets[q].append(tl)
                    id_sets[q].add(tl_id)

        for quad, tls, ids in zip(quads, tl_sets, id_sets):
            a_rect = ArticleRectangle(quad.x, quad.y, quad.width, quad.height,
                                      tls, ids)
            if len(a_rect.a_ids) > 1:
                a_rect.create_subregions_from_surrounding_polygon(
                    ar_list, max_rect_size=max_rect_size)
            elif 0 < max_rect_size < a_rect.height:
                a_rect.create_subregions_from_surrounding_polygon(
                    ar_list, max_rect_size=max_rect_size)
            else:
                ar_list.append(a_rect)
        return ar_list

    def initialize_gt_generation(self, des_dist=5, max_d=50):
        """Non-overlapping (textline, bbox, article_id) tuples: baseline
        bboxes expanded by the interline distance, then iteratively shrunk
        until no cross-article overlaps remain
        (article_rectangle.py:158-278)."""
        tl_list = []
        for tl in self.textlines:
            if tl.baseline is None:
                continue
            tl_bl = tl.baseline.to_polygon()
            tl_bl.calculate_bounds()
            tl_surr = None
            if tl.surr_p is not None:
                tl_surr = tl.surr_p.to_polygon().get_bounding_box()
            tl_list.append([tl, tl_surr, tl_bl, tl.get_article_id()])

        if not tl_list:
            return []

        normed = norm_poly_dists([t[2] for t in tl_list], des_dist=des_dist)
        interline = calc_interline_distances(normed, des_dist=des_dist, max_d=max_d)

        tl_list = copy.deepcopy(tl_list)
        for (tl, surr, bl, aid), dist in zip(tl_list, interline):
            shift = int(dist)
            bl.bounds.translate(0, -shift)
            bl.bounds.height += int(1.1 * shift)

        def shrink_until_disjoint(bl1, bl2):
            inter = bl1.bounds.intersection(bl2.bounds)
            while inter.width >= 0 and inter.height >= 0:
                if inter.height in (bl1.bounds.height, bl2.bounds.height):
                    # horizontal overlap: trim one column from each side
                    if (bl1.bounds.x + bl1.bounds.width
                            > bl2.bounds.x + bl2.bounds.width):
                        bl1.bounds.width -= 1
                        bl1.bounds.x += 1
                        bl2.bounds.width -= 1
                    else:
                        bl1.bounds.width -= 1
                        bl2.bounds.x += 1
                        bl2.bounds.width -= 1
                elif (bl1.bounds.y + bl1.bounds.height
                        > bl2.bounds.y + bl2.bounds.height):
                    shift = max(1, int(0.05 * bl1.bounds.height))
                    bl1.bounds.height -= shift
                    bl1.bounds.y += shift
                else:
                    shift = max(1, int(0.05 * bl2.bounds.height))
                    bl2.bounds.height -= shift
                    bl2.bounds.y += shift
                inter = bl1.bounds.intersection(bl2.bounds)
            return bl1

        final = []
        has_intersect_surr = [False] * len(tl_list)
        for i in range(len(tl_list)):
            tl1, surr1, bl1, aid1 = tl_list[i]
            for j in range(i + 1, len(tl_list)):
                tl2, surr2, bl2, aid2 = tl_list[j]
                if surr1 is not None and not has_intersect_surr[i]:
                    if surr2 is not None and not has_intersect_surr[j]:
                        inter = surr1.intersection(surr2)
                        has_intersect_surr[j] = (
                            inter.width >= 0 and inter.height >= 0)
                    else:
                        inter = surr1.intersection(bl2.bounds)
                    if not (inter.width >= 0 and inter.height >= 0 and aid1 != aid2):
                        if j == len(tl_list) - 1:
                            final.append((tl1, surr1, aid1))
                        continue
                    has_intersect_surr[i] = True
                else:
                    if surr2 is not None:
                        inter = bl1.bounds.intersection(surr2)
                        has_intersect_surr[j] = (
                            inter.width >= 0 and inter.height >= 0)
                    else:
                        inter = bl1.bounds.intersection(bl2.bounds)

                if inter.width >= 0 and inter.height >= 0 and aid1 != aid2:
                    bl = shrink_until_disjoint(bl1, bl2)
                    if j == len(tl_list) - 1:
                        final.append((tl1, bl.bounds, aid1))
                elif j == len(tl_list) - 1:
                    final.append((tl1, bl1.bounds, aid1))

        if has_intersect_surr:
            last = tl_list[-1]
            if has_intersect_surr[-1] or last[1] is None:
                final.append((last[0], last[2].bounds, last[3]))
            else:
                final.append((last[0], last[1], last[3]))
        return final


# ------------------------------------------------------------------ util.py

def get_article_surrounding_polygons(ar_dict: Dict[str, List[Rectangle]]
                                     ) -> Dict[str, List[Polygon]]:
    """{article_id: ortho-connect outlines over its rectangles}
    (util.py:15-26)."""
    return {aid: ortho_connect(rects) for aid, rects in ar_dict.items()}


def smooth_article_surrounding_polygons(asp_dict, poly_norm_dist=10,
                                        orientation_dims=(600, 300, 600, 300),
                                        offset=0):
    """Smooth each article's outlines (util.py:29-72)."""
    return {
        aid: [smooth_surrounding_polygon(p, poly_norm_dist, orientation_dims, offset)
              for p in polys]
        for aid, polys in asp_dict.items()}


def convert_blank_article_rects_by_rects(ars_dict, method="bb"):
    """Reassign blank rectangles intersecting exactly one article's bbox/hull
    (util.py:73-104)."""
    assert method in ("bb", "ch")
    poly_dict = {}
    for key, ars in ars_dict.items():
        if key in ("blank", None):
            continue
        points = [v for ar in ars for v in ar.get_vertices()]
        poly_dict[key] = bounding_box(points) if method == "bb" else convex_hull(points)

    out = dict(ars_dict)
    to_remove = []
    for ar in ars_dict.get("blank", []):
        hits = [key for key, poly in poly_dict.items()
                if polygon_clip(ar.get_vertices(), poly)]
        if len(hits) == 1:
            out[hits[0]].append(ar)
            to_remove.append(ar)
    out["blank"] = [ar for ar in ars_dict.get("blank", []) if ar not in to_remove]
    return out


def convert_blank_article_rects_by_polys(ars_dict, asp_dict, method="bb"):
    """Same, against each article's outline polygons (util.py:106-138)."""
    assert method in ("bb", "ch")
    poly_dict = {}
    for key, polys in asp_dict.items():
        if key in ("blank", None):
            continue
        poly_dict[key] = [
            bounding_box(p.as_list()) if method == "bb" else convex_hull(p.as_list())
            for p in polys]

    out = dict(ars_dict)
    to_remove = []
    for ar in ars_dict.get("blank", []):
        hits = []
        for key, polys in poly_dict.items():
            for poly in polys:
                if polygon_clip(ar.get_vertices(), poly):
                    hits.append(key)
        if len(set(hits)) == 1:
            out[hits[0]].append(ar)
            to_remove.append(ar)
    out["blank"] = [ar for ar in ars_dict.get("blank", []) if ar not in to_remove]
    return out


def sort_textlines_by_y(textlines):
    return sorted(textlines,
                  key=lambda tl: min(p[1] for p in tl.baseline.points_list))


def stretch_rectangle_until_whitespace(binarized_image, rectangle,
                                       whitespace_height=1, stretch_limit=250):
    """Grow a rectangle upward until a whitespace band is found
    (util.py:163-188)."""
    new_rectangle = copy.deepcopy(rectangle)
    ws = Rectangle(rectangle.x + rectangle.width // 5,
                   rectangle.y - whitespace_height,
                   3 * rectangle.width // 5, whitespace_height)
    if ws.y < 0 or ws.y + ws.height > binarized_image.shape[1]:
        return new_rectangle
    for i in range(stretch_limit):
        if is_whitespace(binarized_image, ws, threshold=0.04) or ws.y == 0:
            new_rectangle.set_bounds(rectangle.x, ws.y, rectangle.width,
                                     rectangle.height + i + 1)
            break
        ws.translate(0, -1)
    return new_rectangle


def get_article_rectangles_from_baselines(page, image_path=None, stretch=False,
                                          use_surr_polygons=True,
                                          device: DeviceLike = "cuda"):
    """Greedy per-article growth of non-overlapping rectangles from baselines
    (util.py:190-351). With ``stretch`` the page is binarized on
    ``device``."""
    from citlab_as_tpu_torch.geometry.polygon import are_vertical_aligned as is_vertical_aligned

    if isinstance(page, str):
        page = Page(page)
    article_dict = page.get_article_dict()
    out: Dict = defaultdict(list)

    binarized_image = get_binarization(image_path, device=device) if stretch else None

    for article_id, textlines in article_dict.items():
        textlines = [tl for tl in textlines if tl.baseline is not None]
        used: List[str] = []
        sorted_tls = sort_textlines_by_y(textlines)
        for i, textline in enumerate(sorted_tls):
            if textline.id in used:
                continue
            baseline = textline.baseline.points_list
            bl_poly = textline.baseline.to_polygon()
            if use_surr_polygons and textline.surr_p is not None:
                bb = textline.surr_p.to_polygon().get_bounding_box()
            else:
                bb = bl_poly.get_bounding_box()

            # shrink against rectangles of other articles
            for aid, ars in out.items():
                if aid == article_id:
                    continue
                for ar in ars:
                    inter = ar.intersection(bb)
                    for _ in range(20):
                        if inter.width > 0 and inter.height > 0:
                            bb.translate(0, 1)
                            bb.height -= 1
                            inter = ar.intersection(bb)
                        else:
                            break

            rect = ArticleRectangle(bb.x, bb.y, bb.width, bb.height,
                                    [textline], None)
            used.append(textline.id)

            for j, tl_cmp in enumerate(sorted_tls[i + 1:]):
                if tl_cmp.id in used:
                    continue
                bl_cmp = tl_cmp.baseline.points_list
                top_edge = rect.get_vertices()[:2]
                skip = False
                if not is_vertical_aligned(top_edge, bl_cmp):
                    rest = sorted_tls[i + j + 2:]
                    if rest:
                        for tl in rest:
                            if tl.id in used:
                                continue
                            if (is_vertical_aligned(baseline, tl.baseline.points_list)
                                    and is_vertical_aligned(bl_cmp, tl.baseline.points_list, margin=50)):
                                skip = False
                                break
                            skip = True
                    else:
                        skip = True
                if skip:
                    continue

                if use_surr_polygons and tl_cmp.surr_p is not None:
                    bb_cmp = tl_cmp.surr_p.to_polygon().get_bounding_box()
                else:
                    bb_cmp = tl_cmp.baseline.to_polygon().get_bounding_box()

                merged = merge_rectangles([rect, bb_cmp])

                # reject merges that overlap existing rectangles
                skip = any(
                    ar.intersection(merged).width > 0
                    and ar.intersection(merged).height > 0
                    for ars in out.values() for ar in ars)
                if skip:
                    continue

                merged_ar = ArticleRectangle(merged.x, merged.y, merged.width,
                                             merged.height)
                # reject merges swallowing other articles' baselines
                other_tls = [tl for aid, tls in article_dict.items()
                             if aid != article_id for tl in tls
                             if tl.baseline is not None]
                skip = False
                for other in other_tls:
                    poly = other.baseline.to_polygon()
                    if merged_ar.contains_polygon(poly, merged_ar.x, merged_ar.y,
                                                  merged_ar.width, merged_ar.height):
                        skip = True
                        shrunk = copy.deepcopy(merged_ar)
                        for _ in range(50):
                            shrunk.translate(0, 1)
                            shrunk.height -= 1
                            if not shrunk.contains_polygon(
                                    poly, shrunk.x, shrunk.y, shrunk.width, shrunk.height):
                                skip = False
                            merged_ar = shrunk
                            break
                    if skip:
                        break
                if skip:
                    continue

                rect.textlines.append(tl_cmp)
                rect.set_bounds(merged_ar.x, merged_ar.y, merged_ar.width,
                                merged_ar.height)
                used.append(tl_cmp.id)

            if len(rect.textlines) == 1 and not rect.textlines[0].surr_p:
                rect.translate(0, -10)
                rect.height = 10

            if stretch:
                img_height = len(binarized_image)
                rect = stretch_rectangle_until_whitespace(
                    binarized_image, rect,
                    whitespace_height=max(1, img_height // 1000),
                    stretch_limit=img_height // 10)
            out[article_id].append(rect)
    return out


def merge_article_rectangles_vertically(article_rectangles_dict,
                                        min_width_intersect=20,
                                        max_vertical_distance=50,
                                        use_convex_hull=False):
    """Merge same-article rectangles across small vertical gaps into outline
    polygons (util.py:354-419)."""
    surr_polygon_dict = defaultdict(list)
    for aid, ars in article_rectangles_dict.items():
        redundant = []
        merged_list: List[List[Rectangle]] = []
        for i, ar in enumerate(ars):
            if ar in redundant:
                continue
            merged = [ar]
            for group in merged_list:
                if ar in group:
                    merged_list.remove(group)
                    merged = group
                    break
            if i + 1 == len(ars):
                merged_list.append(merged)
                break
            for ar_cmp in ars[i + 1:]:
                if ar_cmp in redundant:
                    continue
                if ar.contains_rectangle(ar_cmp):
                    redundant.append(ar_cmp)
                    continue
                inter = ar.intersection(ar_cmp)
                if inter.width > min_width_intersect and inter.height > 0:
                    merged.append(ar_cmp)
                    merged.append(inter)
                if inter.width > min_width_intersect and inter.height < 0:
                    if abs(inter.height) < max_vertical_distance:
                        gap = ar.get_gap_to(ar_cmp)
                        blocked = any(
                            gap.intersection(other).height > 0
                            and gap.intersection(other).width > 0
                            for others in article_rectangles_dict.values()
                            for other in others if other is not ar)
                        if blocked:
                            continue
                        merged.append(ar_cmp)
                        merged.append(gap)
            merged_list.append(merged)

        for group in merged_list:
            if use_convex_hull:
                hull = convex_hull(
                    [v for r in group for v in r.get_vertices()])
                surr_polygon_dict[aid].append(Polygon.from_points(hull))
            else:
                for poly in ortho_connect(group):
                    surr_polygon_dict[aid].append(poly)
    return surr_polygon_dict


def get_article_rectangles_from_surr_polygons(page, use_max_rect_size=True,
                                              max_d=0, max_rect_size_scale=1 / 50,
                                              max_d_scale=1 / 20):
    """Quad-tree article subregions over the print space (util.py:422-458).
    Returns (rect list, image height, image width)."""
    if isinstance(page, str):
        page = Page(page)
    ps_coords = page.get_print_space_coords()
    ps_rect = Points(ps_coords).to_polygon().get_bounding_box()
    root = ArticleRectangle(ps_rect.x, ps_rect.y, ps_rect.width, ps_rect.height,
                            page.get_textlines())
    max_rect_size = int(max_rect_size_scale * root.height) if use_max_rect_size else 0
    if not max_d:
        max_d = int(max_d_scale * root.height)
    ars = root.create_subregions_from_surrounding_polygon(
        max_d=max_d, max_rect_size=max_rect_size)
    img_width, img_height = page.get_image_resolution()
    return ars, img_height, img_width
