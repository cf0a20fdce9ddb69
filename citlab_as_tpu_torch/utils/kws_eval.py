"""Keyword-spotting (KWS) JSON evaluation helpers — NewsEye side tool (port
of ``citlab_as_tpu/utils/kws_eval.py``).

Reference: python_util/external/kws/evaluate_json.py:15-453. Evaluates KWS
result JSONs ({'keywords': [{'kw', 'pos': [{'image', 'bl', 'line',
'conf'}]}]}) against query lists with AND-combination over images,
hyphenation handling via prefix/suffix result files, and the
``are_vertically_close`` consecutive-line matching rule.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from citlab_as_tpu_torch.geometry.polygon import string_to_poly


def are_vertically_close(poly1: str, poly2: str, min_dist_x: int = 200,
                         max_dist_x: int = 1750, max_dist_y: int = 100) -> bool:
    """Two baseline strings belong to consecutive line parts of one
    hyphenated word (evaluate_json.py:15-30)."""
    p1 = string_to_poly(poly1)
    p2 = string_to_poly(poly2)
    p1_avg_y = sum(p1.y_points) / len(p1.y_points)
    p2_avg_y = sum(p2.y_points) / len(p2.y_points)
    p1_avg_x = sum(p1.x_points) / len(p1.x_points)
    p2_avg_x = sum(p2.x_points) / len(p2.x_points)
    return (abs(p1_avg_y - p2_avg_y) < max_dist_y
            and min_dist_x < abs(p1_avg_x - p2_avg_x) < max_dist_x
            and p1_avg_y < p2_avg_y
            and not max(p1.x_points) < min(p2.y_points))


def list_img_intersect_with_textline_cond(l1, l2):
    """Pairs of (suffix, prefix) matches on the same image whose baselines
    are vertically close (evaluate_json.py:33-40)."""
    return [(v1, v2) for v1 in l1 for v2 in l2
            if v1[0] == v2[0] and are_vertically_close(
                v1[1].replace(" ", ";"), v2[1].replace(" ", ";"))]


def list_img_intersect(l1, l2):
    """AND-combination: keep entries whose image appears in both lists
    (evaluate_json.py:43-53)."""
    img1 = {v[0] for v in l1}
    img2 = {v[0] for v in l2}
    common = img1 & img2
    return [v for v in l1 if v[0] in common] + [v for v in l2 if v[0] in common]


def get_kws_from_query(js: Dict, query: str) -> List[str]:
    """Keywords whose pattern matches the (uppercased) query
    (evaluate_json.py:56-61)."""
    return [kw for kw in js if re.match(kw, query.upper())]


def get_img_filename(path: str) -> str:
    name = os.path.basename(path)
    if not name.endswith((".jpg", ".png", ".tif")):
        raise ValueError(f"Expected an image with a valid extension, got '{name}'.")
    return name


def get_imgs_from_kw(js: Dict, kw: str) -> List[Tuple[str, str, str, float]]:
    """(image, baseline, line_id, conf) tuples for a keyword
    (evaluate_json.py:64-75)."""
    out = []
    for pos in js[kw]:
        image = re.sub(r"/storage", "", pos["image"])
        image = re.sub(r"/container.bin", "", image)
        out.append((get_img_filename(image), pos["bl"], pos["line"],
                    float(pos["conf"])))
    return out


def get_corresponding_page_path(img_path: str) -> str:
    name = os.path.splitext(os.path.basename(img_path))[0]
    return os.path.join(os.path.dirname(img_path), "page", name + ".xml")


def get_textline_by_id(textlines, line_id):
    for textline in textlines:
        if textline.id == line_id:
            return textline
    return None


def load_kws_results(path: str) -> Dict[str, list]:
    """{'keywords': [{'kw', 'pos'}]} -> {kw: pos_list}."""
    with open(path) as f:
        js = json.load(f)
    return {kw["kw"]: kw["pos"] for kw in js["keywords"]}


def get_hyphenation_results(hyph_dict: Dict, keyword: str,
                            suffix_kws_result: Dict, prefix_kws_result: Dict):
    """Matches of a hyphenated keyword: suffix part at line end + prefix
    part at the following line start, joined by vertical closeness
    (evaluate_json.py:100-128)."""
    hyph_list = hyph_dict.get(keyword, [])
    for hyph_tuple in hyph_list:
        suffix_results = suffix_kws_result.get(hyph_tuple[0].upper())
        if not suffix_results:
            continue
        prefix_results = None
        if hyph_tuple[1]:
            prefix_results = prefix_kws_result.get(hyph_tuple[1].upper())
            if not prefix_results:
                continue
        suffix_matches = get_imgs_from_kw(suffix_kws_result, hyph_tuple[0].upper())
        if prefix_results:
            prefix_matches = get_imgs_from_kw(prefix_kws_result, hyph_tuple[1].upper())
            return list_img_intersect_with_textline_cond(
                suffix_matches, prefix_matches)
        return suffix_matches
    return []


def evaluate_queries(kws_results: Dict[str, list], queries: Sequence[str],
                     hyph_dict: Optional[Dict] = None,
                     prefix_kws_result: Optional[Dict] = None,
                     suffix_kws_result: Optional[Dict] = None) -> Dict[str, list]:
    """Per query: matched (image, bl, line, conf) tuples; multi-word queries
    AND-combine over images; hyphenation results are added when the side
    files are given (evaluate_json.py __main__ flow)."""
    out = {}
    for query in queries:
        parts = [p for p in query.split() if p.upper() != "AND"]
        per_part = []
        for part in parts:
            matches = []
            for kw in get_kws_from_query(kws_results, part):
                matches.extend(get_imgs_from_kw(kws_results, kw))
            if hyph_dict is not None and suffix_kws_result is not None:
                hyph = get_hyphenation_results(
                    hyph_dict, part, suffix_kws_result, prefix_kws_result or {})
                for entry in hyph:
                    if isinstance(entry, tuple) and len(entry) == 2:
                        matches.extend(entry)
                    else:
                        matches.append(entry)
            per_part.append(matches)
        result = per_part[0] if per_part else []
        for other in per_part[1:]:
            result = list_img_intersect(result, other)
        out[query] = result
    return out
