"""ARU-Net inference wrapper (port of ``citlab_as_tpu/inference.py::
SegmentationPredictor``: ``__init__``, ``__call__``, ``predict_batch``,
``predict_batch_device``).

Pages are zero-padded to a multiple of ``pad_multiple`` and cropped back.
The batch is the caller's: there is no device batch cap (the JAX package's
``MAX_DEVICE_BATCH`` was a TPU measurement and does not carry over).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.models.arunet import ARUNet
from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz

logger = logging.getLogger(__name__)


class SegmentationPredictor:
    """ARU-Net forward: grayscale [H, W] in [0, 1] -> probabilities [H, W, C].

    ``model_path``: a converted ``.npz`` (``scripts/convert_weights_to_torch.py``);
    None -> random init from ``seed`` (logged loudly). ``dtype`` is the
    compute dtype (bf16 by default, as the JAX predictor); parameters are
    held in it. Runs on ``device`` ("cuda" unless told "cpu")."""

    def __init__(self, model_path: Optional[str] = None, n_classes: int = 2,
                 graph_params: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16, pad_multiple: int = 64,
                 seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.pad_multiple = pad_multiple
        self.model = ARUNet(n_classes=n_classes, graph_params=graph_params)
        if model_path is not None:
            self.model.load_state_dict(
                arunet_state_dict_from_flax(load_npz(model_path)))
            logger.info("Loaded ARU-Net params from %s", model_path)
        else:
            self.model.init_random(seed)
            logger.warning("SegmentationPredictor using RANDOM params "
                           "(no model_path given).")
        self.model = self.model.to(device=self.device, dtype=dtype).eval()

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.model(x), dim=-1)

    def _pack(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        ph = -(-max(im.shape[0] for im in images) // self.pad_multiple) * self.pad_multiple
        pw = -(-max(im.shape[1] for im in images) // self.pad_multiple) * self.pad_multiple
        x = np.zeros((len(images), ph, pw, 1), np.float32)
        for i, im in enumerate(images):
            x[i, :im.shape[0], :im.shape[1], 0] = im
        return torch.from_numpy(x).to(self.device)

    def __call__(self, image_grey: np.ndarray) -> np.ndarray:
        return self.predict_batch([image_grey])[0]

    def predict_batch(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Batch same-bucket images; returns per-image HWC probabilities."""
        return self.predict_batch_device(images)()

    def predict_batch_device(self, images: Sequence[np.ndarray]
                             ) -> Callable[[], List[np.ndarray]]:
        """Enqueue the forward (CUDA work is asynchronous) and return a
        zero-arg callable that copies the per-image results to the host."""
        if not images:
            return lambda: []
        probs = self._forward(self._pack(images))
        shapes = [im.shape[:2] for im in images]

        def materialize():
            host = probs.cpu().numpy()
            return [host[i, :h, :w, :] for i, (h, w) in enumerate(shapes)]
        return materialize
