"""Port copy of ``citlab_as_tpu/train/input_pipeline.py::apply_feature_masks``
(the relation predictor masks feature columns as the training input
pipeline does). The rest of the input pipeline belongs to training, which
is not ported yet."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def apply_feature_masks(features: np.ndarray, mask: Optional[Sequence[bool]]) -> np.ndarray:
    """Keep feature columns where mask is truthy (input_dataset.py:378-383)."""
    if mask is None:
        return features
    idx = [i for i, m in enumerate(mask) if m]
    return features[..., idx]
