"""Backbone dispatcher (port of ``citlab_as_tpu/models/backbones.py``;
reference: article_separation/backbones/backbones.py:9-39).

Maps backbone names to constructors. ``ARU_v1`` / ``RU_v2`` / ``U_v1``
share one implementation parameterized by graph type; ``ARU_cutted_v1`` is
the down-path-only feature extractor used as the GNN visual branch. ``dtype``
is the ARU-Net's compute dtype (float32 parameters cast at use); the cutted
extractor computes in its parameters' dtype, so there it is the parameters'
dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from citlab_as_tpu_torch.models.arunet import ARUCutted, ARUNet, DEFAULT_GRAPH_PARAMS

_BACKBONES = {
    "ARU_v1": {"graph": "ARU"},
    "RU_v2": {"graph": "RU"},
    "U_v1": {"graph": "U"},
}


def get_backbone(name: str, n_classes: int = 2,
                 graph_params: Optional[Dict[str, Any]] = None,
                 dtype: Optional[torch.dtype] = None):
    if name == "ARU_cutted_v1":
        model = ARUCutted(graph_params=dict(graph_params) if graph_params else None)
        return model.to(dtype) if dtype is not None else model
    if name not in _BACKBONES:
        raise ValueError(
            f"Unknown backbone '{name}'. Available: "
            f"{sorted(_BACKBONES) + ['ARU_cutted_v1']}")
    gp = dict(DEFAULT_GRAPH_PARAMS)
    gp.update(_BACKBONES[name])
    if graph_params:
        gp.update(graph_params)
    return ARUNet(n_classes=n_classes, graph_params=gp, compute_dtype=dtype)
