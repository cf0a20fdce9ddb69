"""Heading detection evaluation + hyperparameter grid search (port of
``citlab_as_tpu/eval/heading_eval.py``).

Reference: image_segmentation/net_post_processing/
{heading_evaluation.py:20-243, heading_evaluation_grid_search.py:11-86}.
Per page: binary/micro/macro/weighted precision, recall and F1 of region
heading typing vs GT; dataset averages. The grid search sweeps the heading
post-processor's weight/threshold hyperparameters in-process (the reference
forks a subprocess per setting).

The scores are :func:`precision_recall_f1`, a numpy copy of sklearn 1.9's
``precision_score`` / ``recall_score`` / ``f1_score`` with
``zero_division=0`` (the JAX package calls sklearn). Every grid point runs
the port's ``HeadingNetPostProcessor.run``, whose net forward runs on the
predictor's device, and which writes ``page/<name>.xml.xml`` as the JAX
package's does (the last grid point's pages stay on disk).
"""
from __future__ import annotations

import itertools
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.pagexml.constants import TextRegionTypes

logger = logging.getLogger(__name__)

AVERAGES = ("binary", "micro", "macro", "weighted")


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (sklearn's ``_prf_divide`` with
    ``zero_division=0``)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def precision_recall_f1(y_true: Sequence, y_pred: Sequence,
                        average: str) -> Tuple[float, float, float]:
    """sklearn 1.9's precision, recall and F1 of one label vector pair with
    ``zero_division=0``. ``average``: ``binary`` (class 1 alone, sklearn's
    default ``pos_label``), ``micro`` (counts summed over the classes),
    ``macro`` (mean of the per-class scores) or ``weighted`` (their mean
    weighted by each class's true count). The classes are the sorted union
    of ``y_true`` and ``y_pred``; F1 per class is 2 tp / (true + predicted).
    Empty vectors raise, as in sklearn."""
    if average not in AVERAGES:
        raise ValueError(f"average must be one of {AVERAGES}, got {average!r}")
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.shape != y_pred.shape or y_true.ndim != 1:
        raise ValueError("y_true and y_pred must be 1-D and of equal length")
    if y_true.size == 0:
        raise ValueError("empty label vectors")
    present = np.unique(np.concatenate([y_true, y_pred]))
    if average == "binary":
        if len(present) > 2:
            raise ValueError("binary average needs at most two classes")
        if len(present) == 2 and 1 not in present:
            raise ValueError("pos_label=1 is not a valid label")
        labels = np.asarray([1])
    else:
        labels = present
    hit = y_true == y_pred
    tp = np.asarray([np.sum(hit & (y_true == lab)) for lab in labels], np.int64)
    pred = np.asarray([np.sum(y_pred == lab) for lab in labels], np.int64)
    true = np.asarray([np.sum(y_true == lab) for lab in labels], np.int64)
    if average == "micro":
        tp, pred, true = (np.asarray([a.sum()]) for a in (tp, pred, true))
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2.0 * tp, 1.0 * true + pred)
    weights = true if average == "weighted" else None
    return tuple(float(np.average(v, weights=weights)) for v in (precision, recall, f1))


def get_heading_regions(page_object: Page) -> list:
    """TextRegions typed heading (heading_evaluation.py:20-29)."""
    return [tr for tr in page_object.get_text_regions()
            if tr.region_type == TextRegionTypes.HEADING]


def get_heading_text_lines(heading_regions) -> list:
    return [tl for region in heading_regions for tl in region.text_lines]


def get_heading_text_line_by_custom_type(heading_regions) -> list:
    """Only lines additionally tagged structure{semantic_type:heading}
    (heading_evaluation.py:46-67)."""
    out = []
    for region in heading_regions:
        for tl in region.text_lines:
            if tl.custom.get("structure", {}).get("semantic_type") == TextRegionTypes.HEADING:
                out.append(tl)
    return out


def evaluate_heading_pages(gt_pages: Sequence, hyp_pages: Sequence
                           ) -> Dict[str, float]:
    """Average P/R/F1 per averaging mode over page pairs
    (heading_evaluation.py:156-243)."""
    scores: Dict[str, List[float]] = {
        f"{m}_{avg}": [] for m in ("recall", "precision", "f1")
        for avg in AVERAGES}

    for gt, hyp in zip(gt_pages, hyp_pages):
        gt_page = gt if isinstance(gt, Page) else Page(gt)
        hyp_page = hyp if isinstance(hyp, Page) else Page(hyp)
        is_heading_gt = [tr.region_type == TextRegionTypes.HEADING
                         for tr in gt_page.get_text_regions()]
        is_heading_hyp = [tr.region_type == TextRegionTypes.HEADING
                          for tr in hyp_page.get_text_regions()]
        n = min(len(is_heading_gt), len(is_heading_hyp))
        if n == 0:
            continue
        gt_v, hyp_v = is_heading_gt[:n], is_heading_hyp[:n]
        for avg in AVERAGES:
            precision, recall, f1 = precision_recall_f1(gt_v, hyp_v, avg)
            scores[f"recall_{avg}"].append(recall)
            scores[f"precision_{avg}"].append(precision)
            scores[f"f1_{avg}"].append(f1)

    return {k: float(np.mean(v)) if v else 0.0 for k, v in scores.items()}


def run_heading_evaluation(image_paths: Sequence[str], predict_fn,
                           fixed_height: Optional[int] = 900,
                           weight_dict=None, threshold: float = 0.4,
                           thresh_dict=None, text_line_percentage: float = 0.8
                           ) -> Dict[str, float]:
    """Run the heading post-processor with the given hyperparameters and
    score against the (pre-run) GT region types. ``predict_fn``: an
    ``inference.SegmentationPredictor`` (its device runs the forward) or
    any ``predict_fn(image_grey[H, W]) -> probabilities[H, W, C]``."""
    from citlab_as_tpu_torch.stages.heading import HeadingNetPostProcessor
    from citlab_as_tpu_torch.utils.io import get_page_path

    gt_pages = [Page(get_page_path(p)) for p in image_paths]
    proc = HeadingNetPostProcessor(
        list(image_paths), predict_fn, fixed_height=fixed_height,
        scaling_factor=1.0, weight_dict=weight_dict, threshold=threshold,
        thresh_dict=thresh_dict, text_line_percentage=text_line_percentage)
    hyp_pages = proc.run()
    return evaluate_heading_pages(gt_pages, hyp_pages)


def run_grid_search(image_paths: Sequence[str], predict_fn,
                    fixed_heights: Sequence[int] = (900,),
                    thresholds: Sequence[float] = (0.4,),
                    net_weights: Sequence[float] = (0.8,),
                    net_threshs: Sequence[float] = (1.0,),
                    stroke_width_threshs: Sequence[float] = (1.0,),
                    text_height_threshs: Sequence[float] = (0.9,),
                    text_line_percentages: Sequence[float] = (0.8,),
                    metric: str = "f1_binary") -> List[dict]:
    """In-process hyperparameter sweep (grid_search.py:11-86): for each net
    weight the remaining weight mass is split between stroke width and text
    height; results sorted by ``metric`` descending."""
    results = []
    for fh, thr, nw, nt, swt, tht, tlp in itertools.product(
            fixed_heights, thresholds, net_weights, net_threshs,
            stroke_width_threshs, text_height_threshs, text_line_percentages):
        remaining = round(1.0 - nw, 6)
        for sw_weight_steps in range(0, int(remaining * 10) + 1):
            sw_w = sw_weight_steps / 10
            th_w = round(remaining - sw_w, 6)
            setting = {
                "fixed_height": fh, "threshold": thr,
                "weight_dict": {"net": nw, "stroke_width": sw_w,
                                "text_height": th_w},
                "thresh_dict": {"net_thresh": nt, "stroke_width_thresh": swt,
                                "text_height_thresh": tht,
                                "sw_th_thresh": min(swt, tht) - 0.1},
                "text_line_percentage": tlp,
            }
            metrics = run_heading_evaluation(
                image_paths, predict_fn, fixed_height=fh,
                weight_dict=setting["weight_dict"], threshold=thr,
                thresh_dict=setting["thresh_dict"], text_line_percentage=tlp)
            results.append({"setting": setting, "metrics": metrics})
            logger.info("grid point %s -> %s=%.4f", setting["weight_dict"],
                        metric, metrics.get(metric, 0.0))
    results.sort(key=lambda r: r["metrics"].get(metric, 0.0), reverse=True)
    return results
