"""LAV — load-and-validate a relation model (port of
``citlab_as_tpu/train/lav.py``; reference: gnn/trainer/lav_rel.py:64+).

Run the model over an eval list and report a precision/recall curve over
``num_p_r_thresholds`` equidistant thresholds plus ROC-AUC, AUC-PR (the
port's numpy versions of sklearn's, ``models/gnn/loss.py``) and accuracy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from citlab_as_tpu_torch.models.gnn.loss import average_precision_score, roc_auc_score
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.train.input_pipeline import InputGNN, torch_batch


def lav_relation(model: GraphRelation, eval_list: Sequence[str],
                 input_params: Optional[dict] = None,
                 num_p_r_thresholds: int = 20) -> Dict[str, object]:
    """The model with its own parameters (the JAX function takes them as
    ``variables``). Returns {'thresholds', 'precisions', 'recalls', 'f1s',
    'accuracy', 'auc_roc', 'auc_pr', 'best_f1', 'best_threshold'}."""
    input_fn = InputGNN(input_params)
    device = next(model.parameters()).device

    confs: List[np.ndarray] = []
    gts: List[np.ndarray] = []
    with torch.no_grad():
        for batch_np, _, _ in input_fn.eval_batches(eval_list):
            batch = torch_batch(batch_np, device)
            conf = torch.softmax(model(batch), dim=-1)[..., 1].cpu().numpy()[0]
            num = int(batch_np["num_relations_to_consider"][0])
            confs.append(conf[:num])
            gts.append(batch_np["relations_to_consider_gt"][0][:num])
    if not confs:
        return {}
    conf = np.concatenate(confs)
    gt = np.concatenate(gts)

    thresholds = np.linspace(0.0, 1.0, num_p_r_thresholds + 1, endpoint=False)[1:]
    precisions, recalls, f1s = [], [], []
    for t in thresholds:
        pred = conf >= t
        tp = float(np.sum(pred & (gt == 1)))
        fp = float(np.sum(pred & (gt == 0)))
        fn = float(np.sum(~pred & (gt == 1)))
        p = tp / max(tp + fp, 1.0)
        r = tp / max(tp + fn, 1.0)
        precisions.append(p)
        recalls.append(r)
        f1s.append(2 * p * r / max(p + r, 1e-12))

    out: Dict[str, object] = {
        "thresholds": thresholds.tolist(),
        "precisions": precisions,
        "recalls": recalls,
        "f1s": f1s,
        "accuracy": float(np.mean((conf >= 0.5) == (gt == 1))),
        "best_f1": float(np.max(f1s)),
        "best_threshold": float(thresholds[int(np.argmax(f1s))]),
    }
    if len(set(gt.tolist())) > 1:
        out["auc_roc"] = roc_auc_score(gt, conf)
        out["auc_pr"] = average_precision_score(gt, conf)
    return out
