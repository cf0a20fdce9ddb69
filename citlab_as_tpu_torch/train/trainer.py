"""Relation-GNN trainer (port of ``citlab_as_tpu/train/trainer.py``;
reference: gnn/trainer/trainer_base.py:93-264 + trainer_rel.py:13-69).

Epoch loop (``checkpoint.run_epochs``, shared with the segmentation
trainer): train steps_per_epoch batches, evaluate every
``eval_every_n`` epochs on the full relation grid, export the best state per
metric, early-stop after ``early_stopping_patience`` non-improving evals,
resume from current_epoch.info (``best_metrics`` kept only when a
checkpoint restored). Optional weight decay (L2 over non-bias parameters),
EMA shadow weights (evaluated and exported instead of the live ones) and
gradient accumulation. ``train`` runs on one device, as the JAX trainer,
which takes no mesh; ``_make_sharded_train_step`` is its step data-parallel
over a mesh, as ``jax.jit`` of the JAX trainer's step over a replicated
state and a sharded batch.

``model``: any ``GraphRelation`` the caller built, as the JAX trainer takes
one, the visual nets included (``image_input=True`` with the ``ARU_v1`` or
``ARU_cutted_v1`` backbone; with ``input_params["image_input"]`` the
batches carry the page images and region polygons, and the train step
differentiates through the backbone: under autograd the full ARU-Net's
3x3 convs run K1 forward and cuDNN backward). Without one, the plain net
is built from the first training batch's feature widths, as the JAX
trainer initializes from it; that batch is drawn from the same random
streams, so the batches after it are the JAX trainer's too. Checkpoints
and best exports are the JAX trainer's orbax checkpoints
(``checkpoint.trainer_state``, each tensor placed by its flax path,
``weights.gnn_flax_from_state_dict``); ``best/<metric>`` loads into
``RelationPredictor``, the port's and the JAX package's.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.models.gnn.loss import (
    relation_curves, relation_loss, relation_mask, relation_metrics,
)
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.parallel.mesh import (
    data_parallel_jit, reduce_gradients, sum_on_first,
)
from citlab_as_tpu_torch.train import checkpoint as ckpt
from citlab_as_tpu_torch.train.input_pipeline import InputGNN, torch_batch
from citlab_as_tpu_torch.train.optimizer import build_optimizer
from citlab_as_tpu_torch.weights import (
    gnn_flax_from_state_dict, gnn_state_dict_from_flax,
)

DEFAULT_TRAINER_FLAGS: Dict[str, Any] = {
    "epochs": 200,
    "samples_per_epoch": 8192,
    "batch_size": 16,
    "eval_every_n": 1,
    "early_stopping_patience": 0,      # 0 = disabled
    "best_export_metrics": ["f1"],
    "weight_decay": 0.0,
    "ema_decay": 0.0,                  # 0 = disabled
    "schedule_kind": "final_decay",
    "grad_accum_steps": 1,
    "num_classes": 2,
    "export_curves": False,            # dump PR/ROC curve JSONs per eval
}


def init_gnn_params(model: GraphRelation, seed: int = 0) -> GraphRelation:
    """flax ``Dense``'s initializers drawn from a seeded generator: kernels
    lecun-normal (a normal truncated at two standard deviations, scaled to
    variance 1 / fan_in), biases zero; a visual net's backbone gets its own
    flax initializers (``init_random(seed)``). The port cannot draw jax's
    PRNG numbers; a JAX init is carried across with
    ``weights.gnn_state_dict_from_flax``."""
    gen = torch.Generator().manual_seed(seed)
    if model.image_input:
        model.visual.backbone.init_random(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("visual.backbone."):
                continue
            if name.endswith("bias"):
                p.zero_()
                continue
            fan_in = p.shape[1] * (p[0, 0].numel() if p.dim() > 2 else 1)
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            t = torch.empty(p.shape)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            p.copy_(t * std)
    return model


class TrainerGNN:
    """Train a GraphRelation model over graph-feature JSON lists.

    ``model``: the net to train (a visual one too); None builds the plain
    net, which takes its widths from the data. ``init_params``: flat flax
    params to start from (``params/...`` paths, ``params/visual/...`` for a
    visual net's); None draws flax's initializers from ``seed``."""

    def __init__(self, model_dir: str, train_list: Sequence[str],
                 eval_list: Sequence[str],
                 flags: Optional[Dict[str, Any]] = None,
                 input_params: Optional[dict] = None,
                 optimizer_params: Optional[dict] = None,
                 seed: int = 0, device: DeviceLike = "cuda",
                 init_params: Optional[Dict[str, np.ndarray]] = None,
                 model: Optional[GraphRelation] = None):
        self.device = resolve_device(device)
        self.flags = dict(DEFAULT_TRAINER_FLAGS)
        if flags:
            self.flags.update(flags)
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self.train_list = list(train_list)
        self.eval_list = list(eval_list)
        self.input_fn = InputGNN(input_params,
                                 num_classes=self.flags["num_classes"],
                                 seed=seed)
        self.model: Optional[GraphRelation] = model
        self.init_params = init_params
        self.steps_per_epoch = max(
            1, self.flags["samples_per_epoch"] // self.flags["batch_size"])
        self.optimizer = build_optimizer(
            optimizer_params, self.steps_per_epoch, self.flags["epochs"],
            self.flags["schedule_kind"], self.flags["grad_accum_steps"])
        self.seed = seed
        self._dropout = torch.Generator(device=self.device).manual_seed(seed)
        self.history: List[Dict[str, float]] = []
        #: seconds of the last ``train`` call: host batches, train steps
        #: (device-synced at each loss readback), eval, checkpoints
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _build_model(self, example_batch: Dict[str, np.ndarray]) -> None:
        model = self.model or GraphRelation(
            node_feature_dim=example_batch["node_features"].shape[-1],
            edge_feature_dim=example_batch["edge_features"].shape[-1],
            num_classes=self.flags["num_classes"])
        if self.init_params is not None:
            model.load_state_dict(gnn_state_dict_from_flax(self.init_params))
        else:
            init_gnn_params(model, self.seed)
        self.model = model.to(self.device)

    def _make_train_step(self):
        weight_decay = self.flags["weight_decay"]
        model, optimizer = self.model, self.optimizer

        def train_step(params, opt_state, batch):
            for p in params.values():
                p.grad = None
            logits = model(batch, train=True, generator=self._dropout)
            loss = relation_loss(
                logits, batch["relations_to_consider_gt"],
                batch["num_relations_to_consider"],
                params=params, weight_decay=weight_decay)
            loss.backward()
            # a parameter the loss does not reach (a backbone's layers past
            # the end points it reads) has no gradient; jax.grad's is zero
            optimizer.step(params, {k: torch.zeros_like(p) if p.grad is None else p.grad
                                    for k, p in params.items()}, opt_state)
            return loss.detach()

        return train_step

    def _make_sharded_train_step(self, mesh, replicas: Sequence[GraphRelation]):
        """:meth:`_make_train_step` data-parallel over ``mesh``'s data
        shards, as the JAX trainer's jitted step over a replicated state and
        a sharded batch. ``replicas``: one net per shard
        (``parallel/mesh.py::replicate`` of the built model). Returns
        ``train_step(params, opt_states, shards, emas=None) -> loss``:
        ``params`` one ``dict(named_parameters())`` per replica,
        ``opt_states`` one ``optimizer.init`` per replica, ``shards`` the
        batch split by ``shard_batch``, ``emas`` one shadow per replica
        (``checkpoint.ema_init``) when the flags ask for EMA.

        The loss is the whole batch's: the shards' masked CE summed over the
        count of valid relations in every shard (counted before the
        backward), plus the weight decay's L2 term once, on global shard
        0's loss (the replicas' parameters are equal), not once per shard.
        The gradients are summed by ``reduce_gradients`` (a parameter no
        shard's loss reaches gets zeros, as under ``jax.grad``), every
        replica takes the same update and its own EMA update. Node-feature
        dropout draws from one generator per shard on its device, seeded
        ``seed + g`` for global shard g. The loss comes back as a 0-d tensor
        on the first data device. Over a mesh that spans processes each
        process passes its own replicas, states and pieces of the batch
        (``mesh.local_rows`` are their global shards), and every process
        gets the whole batch's loss and the same parameters."""
        weight_decay, ema_decay = self.flags["weight_decay"], self.flags["ema_decay"]
        devices = mesh.data_devices
        if len(replicas) != len(devices):
            raise ValueError(f"{len(replicas)} replicas for {len(devices)} data shards")
        generators = [torch.Generator(device=dev).manual_seed(self.seed + g)
                      for g, dev in zip(mesh.local_rows, devices)]
        decays = [weight_decay if g == 0 else 0.0 for g in mesh.local_rows]

        def shard_loss(model, params, batch, total, generator, decay):
            for p in params.values():
                p.grad = None
            logits = model(batch, train=True, generator=generator)
            loss = relation_loss(
                logits, batch["relations_to_consider_gt"],
                batch["num_relations_to_consider"],
                params=params, weight_decay=decay, total=total)
            loss.backward()
            return loss.detach(), {k: p.grad for k, p in params.items()}

        backward = data_parallel_jit(shard_loss)
        update = data_parallel_jit(self.optimizer.step)
        shadow = data_parallel_jit(ckpt.ema_update)

        def train_step(params, opt_states, shards, emas=None):
            if ema_decay > 0 and emas is None:
                raise ValueError("the flags ask for EMA: pass one shadow per replica")
            counts = [torch.sum(relation_mask(b["num_relations_to_consider"],
                                              b["relations_to_consider_gt"].shape[1]))
                      for b in shards]
            total = torch.clamp(sum_on_first(mesh, counts), min=1.0)
            losses, grads = zip(*backward(replicas, params, shards,
                                          [total.to(d) for d in devices], generators, decays))
            update(params, reduce_gradients(mesh, grads, params), opt_states)
            if ema_decay > 0:
                shadow(emas, params, [ema_decay] * len(devices))
            return sum_on_first(mesh, losses)

        return train_step

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor],
                params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """softmax(logits)[..., 1] of the model, or of the model with
        ``params`` in place of its own."""
        logits = (self.model(batch) if params is None else
                  torch.func.functional_call(self.model, params, (batch,)))
        return torch.softmax(logits, dim=-1)[..., 1]

    def evaluate(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 curves_path: Optional[str] = None) -> Dict[str, float]:
        """Full-grid evaluation over the eval list (model_relation metrics).
        With ``curves_path``, also dumps PR/ROC curve points as JSON."""
        confs_all, gts_all, nums_all = [], [], []
        for batch_np, _, _ in self.input_fn.eval_batches(self.eval_list):
            conf = self.predict(torch_batch(batch_np, self.device), params)
            confs_all.append(conf.cpu().numpy())
            gts_all.append(batch_np["relations_to_consider_gt"])
            nums_all.append(batch_np["num_relations_to_consider"])
        if not confs_all:
            return {}
        max_r = max(c.shape[1] for c in confs_all)

        def padcat(arrs):
            return np.concatenate([
                np.pad(a, ((0, 0), (0, max_r - a.shape[1]))) for a in arrs])

        conf, gt, num = (padcat(confs_all), padcat(gts_all),
                         np.concatenate(nums_all))
        if curves_path:
            os.makedirs(os.path.dirname(curves_path), exist_ok=True)
            with open(curves_path, "w") as f:
                json.dump(relation_curves(conf, gt, num), f)
        return relation_metrics(conf, gt, num)

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        self._build_model(next(iter(self.input_fn.train_batches(
            self.train_list, self.flags["batch_size"], self.steps_per_epoch))))
        params = dict(self.model.named_parameters())
        opt_state = self.optimizer.init(params)
        ema = ckpt.ema_init(params) if self.flags["ema_decay"] > 0 else None
        train_step = self._make_train_step()

        def evaluate(epoch, eval_params):
            curves_path = (os.path.join(self.model_dir, "curves", f"epoch_{epoch:04d}.json")
                           if self.flags.get("export_curves") else None)
            return self.evaluate(eval_params, curves_path=curves_path)

        result = ckpt.run_epochs(
            self.model_dir, self.flags, params, opt_state, ema,
            gnn_flax_from_state_dict, gnn_state_dict_from_flax,
            lambda: self.input_fn.train_batches(
                self.train_list, self.flags["batch_size"], self.steps_per_epoch),
            lambda b: train_step(params, opt_state, torch_batch(b, self.device)),
            evaluate if self.eval_list else None, name="relation")
        self.timings = result.pop("timings")
        self.history.extend(result["history"])
        return dict(result, history=self.history,
                    state={"params": params, "opt_state": opt_state, "ema": ema})
