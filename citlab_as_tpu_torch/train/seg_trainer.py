"""ARU-Net segmentation trainer (port of
``citlab_as_tpu/train/seg_trainer.py``): reproduces the separator/heading
nets.

The epoch structure of the JAX trainer (``checkpoint.run_epochs``, shared
with the relation-GNN trainer): eval every n epochs, best export per
metric, early stopping, optional EMA, resume from ``current_epoch.info``
that keeps ``best_metrics`` only when a checkpoint actually restored. One device (the JAX trainer's batch sharding over a mesh
is ROADMAP item 17).

The net keeps float32 parameters and computes in ``compute_dtype`` (bf16 by
default, as the JAX trainer's ``ARUNet(dtype=jnp.bfloat16)``). Checkpoints
and best exports are the JAX trainer's orbax checkpoints
(``checkpoint.trainer_state``: the variables in flax's nesting, each tensor
placed by its flax path, ``weights.arunet_flax_from_state_dict``, and
optax's state), so the JAX trainer resumes them and the JAX exporter
freezes them.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.train import checkpoint as ckpt
from citlab_as_tpu_torch.train.optimizer import build_optimizer
from citlab_as_tpu_torch.train.input_pipeline import torch_batch
from citlab_as_tpu_torch.train.seg_input_pipeline import (
    SegmentationDataset, find_gt_examples,
)
from citlab_as_tpu_torch.train.segmentation import (
    create_model, make_eval_step, make_train_step,
)
from citlab_as_tpu_torch.weights import (
    arunet_flax_from_state_dict, arunet_state_dict_from_flax,
)

DEFAULT_SEG_FLAGS: Dict[str, Any] = {
    "epochs": 100,
    "steps_per_epoch": 256,
    "batch_size": 4,
    "crop_size": (512, 512),
    "eval_every_n": 1,
    "eval_steps": 16,
    "early_stopping_patience": 0,
    "best_export_metrics": ["accuracy"],
    "n_classes": 2,
    "ema_decay": 0.0,
    "schedule_kind": "final_decay",
}


class TrainerSegmentation:
    """``init_params``: flat flax params (``params/...`` paths, as a JAX
    init or a converted ``.npz`` gives them) to start from; None draws the
    flax initializers' distributions from ``seed``. ``compute_dtype``: bf16
    by default; float32 for exact runs."""

    def __init__(self, model_dir: str, train_gt_dir: str,
                 eval_gt_dir: Optional[str] = None,
                 flags: Optional[Dict[str, Any]] = None,
                 graph_params: Optional[dict] = None,
                 optimizer_params: Optional[dict] = None,
                 seed: int = 0, device: DeviceLike = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 init_params: Optional[Dict[str, np.ndarray]] = None):
        self.device = resolve_device(device)
        self.flags = dict(DEFAULT_SEG_FLAGS)
        if flags:
            self.flags.update(flags)
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)

        train_examples = find_gt_examples(train_gt_dir)
        if not train_examples:
            raise ValueError(f"No GT examples in {train_gt_dir}")
        self.train_ds = SegmentationDataset(
            train_examples, crop_size=tuple(self.flags["crop_size"]), seed=seed)
        self.eval_ds = None
        if eval_gt_dir:
            eval_examples = find_gt_examples(eval_gt_dir)
            if eval_examples:
                self.eval_ds = SegmentationDataset(
                    eval_examples, crop_size=tuple(self.flags["crop_size"]),
                    augment=False, seed=seed + 1)

        self.model = create_model(self.flags["n_classes"], graph_params, compute_dtype)
        if init_params is not None:
            self.model.load_state_dict(arunet_state_dict_from_flax(init_params))
        else:
            self.model.init_random(seed)
        self.model.to(self.device)
        self.optimizer = build_optimizer(
            optimizer_params, self.flags["steps_per_epoch"],
            self.flags["epochs"], self.flags["schedule_kind"])
        self.seed = seed
        #: seconds of the last ``train`` call: host batches, train steps
        #: (device-synced at each loss readback), eval, checkpoints
        self.timings: Dict[str, float] = {}

    def train(self) -> Dict[str, Any]:
        params = dict(self.model.named_parameters())
        opt_state = self.optimizer.init(params)
        ema = ckpt.ema_init(params) if self.flags["ema_decay"] > 0 else None
        train_step = make_train_step(self.model, self.optimizer)
        eval_step = make_eval_step(self.model)

        def evaluate(epoch, eval_params):
            metrics = {"loss": [], "accuracy": []}
            for batch_np in self.eval_ds.batches(self.flags["batch_size"],
                                                 self.flags["eval_steps"]):
                out = eval_step(torch_batch(batch_np, self.device), eval_params)
                for k in metrics:
                    metrics[k].append(float(out[k]))
            return {k: float(np.mean(v)) for k, v in metrics.items()}

        result = ckpt.run_epochs(
            self.model_dir, self.flags, params, opt_state, ema,
            arunet_flax_from_state_dict, arunet_state_dict_from_flax,
            lambda: self.train_ds.batches(self.flags["batch_size"],
                                          self.flags["steps_per_epoch"]),
            lambda b: train_step(params, opt_state, torch_batch(b, self.device)),
            evaluate if self.eval_ds else None, name="segmentation")
        self.timings = result.pop("timings")
        return dict(result, state={"params": params, "opt_state": opt_state, "ema": ema})
