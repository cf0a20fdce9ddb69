"""Relation loss + metrics (port of ``citlab_as_tpu/models/gnn/loss.py``;
reference: gnn/model/model_relation.py:18-256).

Masked softmax cross-entropy over sampled relations, optional L2 weight
decay over the non-bias parameters; threshold metrics (accuracy,
precision, recall, F1), AUC-PR and AUC-ROC and the PR / ROC curve points
are computed on the host from confidences.

The JAX package takes the two AUCs from sklearn when it is installed; the
card's machine has no sklearn, so :func:`average_precision_score` and
:func:`roc_auc_score` are numpy functions of the port's own with sklearn's
binary semantics: scores sorted descending, tied scores one threshold,
the step integral of the PR curve, and the trapezoids of the ROC curve
after sklearn's ``drop_intermediate``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from citlab_as_tpu_torch.ops.losses import softmax_cross_entropy


def relation_mask(num_relations: torch.Tensor, width: int) -> torch.Tensor:
    """[B, width] float32: 1 at each row's first ``num_relations`` slots
    (the valid relations), 0 at the padding."""
    return (torch.arange(width, device=num_relations.device)[None, :]
            < num_relations[:, None]).to(torch.float32)


def relation_loss(logits: torch.Tensor, targets: torch.Tensor,
                  num_relations: torch.Tensor,
                  params: Optional[Dict[str, torch.Tensor]] = None,
                  weight_decay: float = 0.0,
                  total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked CE (+ L2 over non-bias weights when weight_decay > 0;
    ``params`` named by flat flax path or state-dict name, either way a
    bias has 'bias' in its name). ``total``: the count of valid relations
    to divide by, default ``max(count, 1)`` of this batch (a data shard's
    step passes the whole batch's)."""
    ce = softmax_cross_entropy(logits, targets)
    mask = relation_mask(num_relations, logits.shape[1])
    if total is None:
        total = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(ce * mask) / total
    if weight_decay > 0.0 and params is not None:
        l2 = 0.0
        for name, leaf in params.items():
            if "bias" not in name:
                l2 = l2 + 0.5 * torch.sum(leaf.to(torch.float32) ** 2)
        loss = loss + weight_decay * l2
    return loss


def _curve_counts(gt: np.ndarray, conf: np.ndarray):
    """(fps, tps) at each distinct score, scores descending (sklearn's
    ``confusion_matrix_at_thresholds`` without weights)."""
    y = (np.asarray(gt).ravel() == 1).astype(np.float64)
    score = np.asarray(conf).ravel()
    order = np.argsort(score, kind="stable")[::-1]
    score, y = score[order], y[order]
    thresholds = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    return fps, tps


def average_precision_score(gt: np.ndarray, conf: np.ndarray) -> float:
    """sklearn's binary ``average_precision_score`` (positive label 1)."""
    fps, tps = _curve_counts(gt, conf)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_auc_score(gt: np.ndarray, conf: np.ndarray) -> float:
    """sklearn's binary ``roc_auc_score`` (both classes present)."""
    fps, tps = _curve_counts(gt, conf)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                              True])[0]
        fps, tps = fps[keep], tps[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def relation_metrics(confidences: np.ndarray, targets: np.ndarray,
                     num_relations: np.ndarray, threshold: float = 0.5
                     ) -> Dict[str, float]:
    """Host-side ACC/P/R/F1 + AUC-PR/ROC over the valid relations (the AUCs
    when both classes are present)."""
    mask = np.arange(confidences.shape[1])[None, :] < np.asarray(num_relations)[:, None]
    conf = np.asarray(confidences)[mask]
    gt = np.asarray(targets)[mask]
    pred = (conf >= threshold).astype(np.int32)

    tp = float(np.sum((pred == 1) & (gt == 1)))
    fp = float(np.sum((pred == 1) & (gt == 0)))
    fn = float(np.sum((pred == 0) & (gt == 1)))
    tn = float(np.sum((pred == 0) & (gt == 0)))
    acc = (tp + tn) / max(tp + tn + fp + fn, 1.0)
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    out = {"accuracy": acc, "precision": precision, "recall": recall, "f1": f1}
    if len(set(gt.tolist())) > 1:
        out["auc_pr"] = average_precision_score(gt, conf)
        out["auc_roc"] = roc_auc_score(gt, conf)
    return out


def relation_curves(confidences: np.ndarray, targets: np.ndarray,
                    num_relations: np.ndarray, num_thresholds: int = 201
                    ) -> Dict[str, list]:
    """Streaming PR + ROC curve points over the valid relations
    (misc.py:550-638 semantics: tp/fp/tn/fn accumulated per evenly spaced
    threshold bucket; here one histogram pass + cumulative sums).

    Returns {thresholds, precision, recall, fpr, tpr} lists suitable for a
    JSON dump per eval epoch."""
    mask = np.arange(confidences.shape[1])[None, :] < \
        np.asarray(num_relations)[:, None]
    conf = np.clip(np.asarray(confidences)[mask], 0.0, 1.0)
    gt = np.asarray(targets)[mask]

    edges = np.linspace(0.0, 1.0, num_thresholds)
    pos_hist, _ = np.histogram(conf[gt == 1], bins=num_thresholds - 1,
                               range=(0.0, 1.0))
    neg_hist, _ = np.histogram(conf[gt == 0], bins=num_thresholds - 1,
                               range=(0.0, 1.0))
    total_pos = float(pos_hist.sum())
    total_neg = float(neg_hist.sum())
    # tp(threshold t) = #positives with conf >= t  (suffix sums)
    tp = np.concatenate([np.cumsum(pos_hist[::-1])[::-1], [0.0]])
    fp = np.concatenate([np.cumsum(neg_hist[::-1])[::-1], [0.0]])
    fn = total_pos - tp
    tn = total_neg - fp
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / np.maximum(tp + fn, 1e-12)
    fpr = fp / np.maximum(fp + tn, 1e-12)
    tpr = recall
    return {"thresholds": edges.tolist(),
            "precision": precision.tolist(),
            "recall": recall.tolist(),
            "fpr": fpr.tolist(),
            "tpr": tpr.tolist(),
            "num_positive": total_pos,
            "num_negative": total_neg}
