"""Baseline + article-separation (AS) measure (port of
``citlab_as_tpu/eval/measure.py``).

Reference: article_separation_measure/{baseline_measure.py:6-141,
eval_measure.py:12-258, run_measure.py:14-382}; the measure follows
arXiv:1705.03311 / the ICPR-2020 AS competition:

- per (reco, truth) baseline pair, soft hit counts: per point the minimal
  L1 distance to the other polygon, full hit within tol, linear falloff to
  3*tol; precision via greedy maximal alignment, recall against the union of
  all reco polygons;
- tolerances fixed (min_tol..max_tol ticks) or dynamic per GT line
  (calc_tols, the geometry kernel that replaced java_util);
- the per-page precision / recall runs in the port's host C++ library
  (``gk_calc_metric``); :meth:`BaselineMeasureEval.calc_precision` /
  :meth:`~BaselineMeasureEval.calc_recall` are its plain numpy version
  (``use_native=False``), and stay to hold the library to them.
- AS measure: per GT x HYP article the P/R of their baselines, rows/columns
  weighted by line counts, greedy assignment sum -> R/P/F.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from citlab_as_tpu_torch.geometry.pairwise import calc_tols
from citlab_as_tpu_torch.geometry.polygon import Polygon, norm_poly_dists
from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.utils.mathutil import f_measure


class BaselineMeasureResult:
    def __init__(self):
        self.page_wise_per_dist_tol_tick_per_line_recall = []
        self.page_wise_per_dist_tol_tick_recall = []
        self.page_wise_recall = []
        self.recall = 0.0
        self.page_wise_per_dist_tol_tick_per_line_precision = []
        self.page_wise_per_dist_tol_tick_precision = []
        self.page_wise_precision = []
        self.precision = 0.0


class BaselineMeasure:
    """Accumulator over pages (baseline_measure.py:19-141)."""

    def __init__(self):
        self.result = BaselineMeasureResult()

    def add_per_dist_tol_tick_per_line_recall(self, per_tol_per_line: np.ndarray):
        r = self.result
        r.page_wise_per_dist_tol_tick_per_line_recall.append(per_tol_per_line)
        per_tol = per_tol_per_line.sum(axis=1) / per_tol_per_line.shape[1]
        r.page_wise_per_dist_tol_tick_recall.append(per_tol)
        r.page_wise_recall.append(per_tol.sum() / per_tol.shape[0])
        r.recall = float(np.mean(r.page_wise_recall))

    def add_per_dist_tol_tick_per_line_precision(self, per_tol_per_line: np.ndarray):
        r = self.result
        r.page_wise_per_dist_tol_tick_per_line_precision.append(per_tol_per_line)
        per_tol = per_tol_per_line.sum(axis=1) / per_tol_per_line.shape[1]
        r.page_wise_per_dist_tol_tick_precision.append(per_tol)
        r.page_wise_precision.append(per_tol.sum() / per_tol.shape[0])
        r.precision = float(np.mean(r.page_wise_precision))


class BaselineMeasureEval:
    """Per-page P/R over baseline polygons (eval_measure.py:12-258)."""

    def __init__(self, min_tol: int = 10, max_tol: int = 30,
                 rel_tol: float = 0.25, poly_tick_dist: int = 5):
        assert min_tol <= max_tol, "min_tol can't exceed max_tol"
        assert 0.0 < rel_tol <= 1.0, "rel_tol has to be in (0, 1]"
        self.max_tols = np.arange(min_tol, max_tol + 1)
        self.rel_tol = rel_tol
        self.poly_tick_dist = poly_tick_dist
        self.truth_line_tols: Optional[np.ndarray] = None
        self.measure = BaselineMeasure()

    def calc_measure_for_page_baseline_polys(self, polys_truth: List[Polygon],
                                             polys_reco: List[Polygon],
                                             use_native: bool = True) -> None:
        if use_native and polys_truth and polys_reco:
            from citlab_as_tpu_torch.geometry.native import calc_metric_native
            precision, recall = calc_metric_native(
                polys_truth, polys_reco, self.max_tols.astype(float),
                self.poly_tick_dist, self.rel_tol)
            self.measure.add_per_dist_tol_tick_per_line_precision(precision)
            self.measure.add_per_dist_tol_tick_per_line_recall(recall)
            return

        polys_truth_norm = norm_poly_dists(polys_truth, self.poly_tick_dist)
        polys_reco_norm = norm_poly_dists(polys_reco, self.poly_tick_dist)

        if self.max_tols[0] < 0:
            tols = calc_tols(polys_truth_norm, self.poly_tick_dist, 250, self.rel_tol)
            self.truth_line_tols = np.expand_dims(np.asarray(tols), axis=1)
        else:
            self.truth_line_tols = np.tile(
                self.max_tols, [len(polys_truth_norm), 1]).astype(float)

        precision = self.calc_precision(polys_truth_norm, polys_reco_norm)
        recall = self.calc_recall(polys_truth_norm, polys_reco_norm)

        self.measure.add_per_dist_tol_tick_per_line_precision(precision)
        self.measure.add_per_dist_tol_tick_per_line_recall(recall)
        self.truth_line_tols = None

    # ------------------------------------------------------------------
    @staticmethod
    def _min_l1_dists(poly_a: Polygon, poly_b: Polygon) -> np.ndarray:
        """Per point of ``poly_a``: min over ``poly_b`` points of L1 dist."""
        ax = np.asarray(poly_a.x_points)
        ay = np.asarray(poly_a.y_points)
        bx = np.asarray(poly_b.x_points)[:, None]
        by = np.asarray(poly_b.y_points)[:, None]
        return np.amin(np.abs(ax - bx) + np.abs(ay - by), axis=0)

    @staticmethod
    def _rel_hits_from_dists(min_dist: np.ndarray, tols: np.ndarray,
                             n_points: int) -> np.ndarray:
        """Soft hit count: 1 within tol, linear falloff to 3*tol
        (eval_measure.py:157-175)."""
        tols_t = np.expand_dims(tols, axis=1)
        mask1 = (min_dist <= tols_t).astype(float)
        mask2 = (min_dist <= 3.0 * tols_t).astype(float) - mask1
        with np.errstate(invalid="ignore"):
            rel = mask1 + mask2 * ((3.0 * tols_t - min_dist) / (2.0 * tols_t))
        rel = np.nan_to_num(rel)
        return rel.sum(axis=1) / n_points

    def count_rel_hits(self, poly_to_count: Polygon, poly_ref: Polygon,
                       tols: np.ndarray) -> np.ndarray:
        inter = poly_to_count.get_bounding_box().intersection(
            poly_ref.get_bounding_box())
        if min(inter.width, inter.height) < -3.0 * tols[-1]:
            return np.zeros_like(tols)
        min_dist = self._min_l1_dists(poly_to_count, poly_ref)
        return self._rel_hits_from_dists(min_dist, tols, poly_to_count.n_points)

    def count_rel_hits_list(self, poly_to_count: Polygon,
                            polys_ref: List[Polygon], tols: np.ndarray) -> np.ndarray:
        bb = poly_to_count.get_bounding_box()
        min_dist = np.full((poly_to_count.n_points,), np.inf)
        any_hit = False
        for poly_ref in polys_ref:
            inter = bb.intersection(poly_ref.get_bounding_box())
            if min(inter.width, inter.height) < -3.0 * tols[-1]:
                continue
            d = self._min_l1_dists(poly_to_count, poly_ref)
            min_dist = d if not any_hit else np.minimum(min_dist, d)
            any_hit = True
        if not any_hit:
            return np.zeros_like(tols)
        return self._rel_hits_from_dists(min_dist, tols, poly_to_count.n_points)

    def calc_precision(self, polys_truth, polys_reco) -> np.ndarray:
        """Greedy maximal alignment of reco->truth hit counts
        (eval_measure.py:104-124)."""
        n_tols = self.max_tols.shape[0]
        rel_hits = np.zeros([n_tols, len(polys_reco), len(polys_truth)])
        for i, poly_reco in enumerate(polys_reco):
            for j, poly_truth in enumerate(polys_truth):
                rel_hits[:, i, j] = self.count_rel_hits(
                    poly_reco, poly_truth, self.truth_line_tols[j])

        precision = np.zeros([n_tols, len(polys_reco)])
        for i in range(n_tols):
            hits = rel_hits[i].copy()
            while True:
                x, y = np.unravel_index(np.argmax(hits), hits.shape)
                if hits[x, y] < 0:
                    break
                precision[i, x] = hits[x, y]
                hits[x, :] = -1.0
                hits[:, y] = -1.0
        return precision

    def calc_recall(self, polys_truth, polys_reco) -> np.ndarray:
        recall = np.zeros([self.max_tols.shape[0], len(polys_truth)])
        for i, poly_truth in enumerate(polys_truth):
            recall[:, i] = self.count_rel_hits_list(
                poly_truth, polys_reco, self.truth_line_tols[i])
        return recall


# ------------------------------------------------------------------ AS level

def get_data_from_pagexml(path_to_pagexml: str) -> Dict[Optional[str], List[Polygon]]:
    """{article_id: [baseline polygons]} (run_measure.py:14-48)."""
    art_polygons_dict: Dict[Optional[str], List[Polygon]] = {}
    page_file = Page(path_to_pagexml)
    for article_id, txtlines in page_file.get_article_dict().items():
        for txtline in txtlines:
            if txtline.baseline is None:
                continue
            polygon = txtline.baseline.to_polygon()
            if polygon.n_points > 1:
                art_polygons_dict.setdefault(article_id, []).append(polygon)
    return art_polygons_dict


def get_greedy_sum(array: np.ndarray) -> float:
    """Greedy maximal assignment sum (run_measure.py:115-137)."""
    matrix = np.copy(array)
    s = 0.0
    while True:
        x, y = np.unravel_index(np.argmax(matrix), matrix.shape)
        if matrix[x, y] < 0:
            break
        s += matrix[x, y]
        matrix[x, :] = -1.0
        matrix[:, y] = -1.0
    return s


def compute_baseline_detection_measure(polygon_dict_gt, polygon_dict_hy,
                                       min_tol=10, max_tol=30, rel_tol=0.25,
                                       poly_tick_dist=5):
    """Plain baseline-detection P/R over all lines and over article lines
    only (run_measure.py:50-112)."""
    gt_all, gt_art, hy_all, hy_art = [], [], [], []
    for aid, polys in polygon_dict_gt.items():
        gt_all += polys
        if aid is not None:
            gt_art += polys
    for aid, polys in polygon_dict_hy.items():
        hy_all += polys
        if aid is not None:
            hy_art += polys

    ev = BaselineMeasureEval(min_tol, max_tol, rel_tol, poly_tick_dist)

    def pr(gt, hy):
        if len(gt) == 0:
            return None, None
        if len(hy) == 0:
            return 0, 0
        ev.calc_measure_for_page_baseline_polys(gt, hy)
        return (ev.measure.result.page_wise_recall[-1],
                ev.measure.result.page_wise_precision[-1])

    r_all, p_all = pr(gt_all, hy_all)
    r_art, p_art = pr(gt_art, hy_art)
    return r_all, p_all, r_art, p_art


def run_eval(gt_file: str, hy_file: str, min_tol=10, max_tol=30,
             rel_tol=0.25, poly_tick_dist=5):
    """One page pair -> (bd, bd_without_none, as) R/P/F tuples
    (run_measure.py:141-258)."""
    if not gt_file.endswith(".xml") or not hy_file.endswith(".xml"):
        return None, None, None

    gt_dict = get_data_from_pagexml(gt_file)
    hy_dict = get_data_from_pagexml(hy_file)

    bd_r, bd_p, bd_r_art, bd_p_art = compute_baseline_detection_measure(
        gt_dict, hy_dict, min_tol, max_tol, rel_tol, poly_tick_dist)

    if bd_r is None:
        return None, None, None
    bd_tuple = (bd_r, bd_p, f_measure(bd_p, bd_r))
    if bd_r_art is None:
        return bd_tuple, None, None
    bd_art_tuple = (bd_r_art, bd_p_art, f_measure(bd_p_art, bd_r_art))

    gt_dict.pop(None, None)
    hy_dict.pop(None, None)
    n_gt, n_hy = len(gt_dict), len(hy_dict)
    if n_hy == 0:
        return bd_tuple, bd_art_tuple, (0, 0, 0)

    r_matrix = np.zeros((n_gt, n_hy))
    p_matrix = np.zeros((n_gt, n_hy))
    ev = BaselineMeasureEval(min_tol, max_tol, rel_tol, poly_tick_dist)
    gt_weights, hy_weights = [], []
    for gi, (gt_id, gt_polys) in enumerate(gt_dict.items()):
        gt_weights.append(float(len(gt_polys)))
        for hi, (hy_id, hy_polys) in enumerate(hy_dict.items()):
            if gi == 0:
                hy_weights.append(float(len(hy_polys)))
            ev.calc_measure_for_page_baseline_polys(gt_polys, hy_polys)
            r_matrix[gi, hi] = ev.measure.result.page_wise_recall[-1]
            p_matrix[gi, hi] = ev.measure.result.page_wise_precision[-1]

    gt_w = np.asarray(gt_weights) / sum(gt_weights)
    hy_w = np.asarray(hy_weights) / sum(hy_weights)
    r_matrix = r_matrix * gt_w[:, None]
    p_matrix = p_matrix * hy_w

    as_r = get_greedy_sum(r_matrix)
    as_p = get_greedy_sum(p_matrix)
    return bd_tuple, bd_art_tuple, (as_r, as_p, f_measure(as_p, as_r))


def run_measure(gt_files: List[str], hy_files: List[str], min_tol=-1,
                max_tol=-1, rel_tol=0.25, poly_tick_dist=5,
                verbose: bool = True) -> Dict[str, Optional[tuple]]:
    """Dataset averages over page pairs (run_measure.py:262-349). Returns
    {'bd': (r, p, f) | None, 'bd_without_none': ..., 'as': ...,
    'counts': (bd_n, bd_wn_n, as_n, total)}."""
    assert len(gt_files) == len(hy_files), \
        f"GT list ({len(gt_files)}) must match HY list ({len(hy_files)})"

    sums = {"bd": [0.0, 0.0, 0.0], "bd_without_none": [0.0, 0.0, 0.0],
            "as": [0.0, 0.0, 0.0]}
    counts = {"bd": 0, "bd_without_none": 0, "as": 0}

    for gt_file, hy_file in zip(gt_files, hy_files):
        bd, bd_wn, as_t = run_eval(gt_file, hy_file, min_tol, max_tol,
                                   rel_tol, poly_tick_dist)
        for key, t in (("bd", bd), ("bd_without_none", bd_wn), ("as", as_t)):
            if t is not None:
                sums[key] = [s + v for s, v in zip(sums[key], t)]
                counts[key] += 1
        if verbose:
            print(f"{gt_file} vs {hy_file}: bd={bd} bd_wn={bd_wn} as={as_t}")

    out: Dict[str, Optional[tuple]] = {}
    for key in ("bd", "bd_without_none", "as"):
        if counts[key] > 0:
            out[key] = tuple(v / counts[key] for v in sums[key])
        else:
            out[key] = None
    out["counts"] = (counts["bd"], counts["bd_without_none"], counts["as"],
                     len(gt_files))
    if verbose:
        print("AVERAGES:", {k: out[k] for k in ("bd", "bd_without_none", "as")})
    return out
