"""Training step for the ARU-Net segmentation nets (port of
``citlab_as_tpu/train/segmentation.py``).

Softmax cross-entropy over per-pixel class maps with an optional validity
mask and per-class weights. The model's parameters stay float32 and the
forward computes in ``compute_dtype`` (bf16 by default, as the JAX
trainer's ``ARUNet(dtype=jnp.bfloat16)``; ``models/arunet.py``). Under
autograd K1 runs its forward and cuDNN its backward
(``ops/kernels/conv3x3.py::Conv3x3Function``). Steps are plain functions
over the module and the optimizer's tensor dicts; :func:`make_sharded_train_step`
is the step data-parallel over a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from citlab_as_tpu_torch.models.arunet import ARUNet
from citlab_as_tpu_torch.ops.losses import softmax_cross_entropy
from citlab_as_tpu_torch.parallel.mesh import (
    Mesh, data_parallel_jit, reduce_gradients, sum_on_first,
)
from citlab_as_tpu_torch.train.optimizer import Optimizer


def create_model(n_classes: int = 2, graph_params: Optional[Dict[str, Any]] = None,
                 dtype: Optional[torch.dtype] = torch.bfloat16) -> ARUNet:
    """float32 parameters computing in ``dtype``."""
    return ARUNet(n_classes=n_classes, graph_params=graph_params,
                  compute_dtype=dtype)


def init_params(model: ARUNet, seed: int = 0) -> ARUNet:
    """The flax initializers' distributions (``ARUNet.init_random``) from a
    seeded generator: the port cannot draw jax's PRNG numbers, so a JAX
    init is carried across with ``weights.arunet_state_dict_from_flax``."""
    return model.init_random(seed)


def pixel_weights(labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  class_weights=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The loss's weight of each pixel: the validity mask (ones without
    one) times the class weight of the pixel's label."""
    weights = (torch.ones(labels.shape, dtype=dtype, device=labels.device)
               if mask is None else mask)
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=dtype, device=labels.device)
        weights = weights * cw[labels.long()]
    return weights


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      class_weights=None, total: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Mean per-pixel softmax CE; optional validity mask for padded pixels
    and per-class weights (rare-class boosting, e.g. thin separators).
    ``total``: the weight to divide by, default ``max(sum of weights, 1)``
    of this batch (a data shard's step passes the whole batch's)."""
    ce = softmax_cross_entropy(logits, labels)
    weights = pixel_weights(labels, mask, class_weights, ce.dtype)
    if total is None:
        total = torch.clamp(torch.sum(weights), min=1.0)
    return torch.sum(ce * weights) / total


def make_train_step(model: ARUNet, optimizer: Optimizer, class_weights=None):
    """Returns ``train_step(params, opt_state, batch) -> loss`` (a 0-d
    tensor on the device), which updates ``params`` (the model's
    ``dict(named_parameters())``) and ``opt_state`` in place; batch =
    {'image': [B,H,W,1] float, 'label': [B,H,W] int, 'mask': [B,H,W] float
    or None}, tensors on the model's device. ``class_weights``: the loss's
    per-class weights (the separator recipe weighs class 0 by 8)."""

    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        for p in params.values():
            p.grad = None
        logits = model(batch["image"])
        loss = segmentation_loss(logits, batch["label"], batch.get("mask"),
                                 class_weights)
        loss.backward()
        optimizer.step(params, {k: p.grad for k, p in params.items()}, opt_state)
        return loss.detach()

    return train_step


def make_sharded_train_step(replicas: Sequence[ARUNet], optimizer: Optimizer, mesh: Mesh,
                            class_weights=None):
    """:func:`make_train_step` data-parallel over ``mesh``'s data shards, as
    ``jax.jit`` of the JAX package's train step over a replicated state and
    a sharded batch. ``replicas``: one model per shard
    (``parallel/mesh.py::replicate``). Returns ``train_step(params,
    opt_states, shards) -> loss``: ``params`` one ``dict(named_parameters())``
    per replica, ``opt_states`` one ``optimizer.init`` per replica,
    ``shards`` the batch split by ``shard_batch``.

    The loss is the whole batch's, ``sum(ce * w) / max(sum(w), 1)``: the
    denominator is summed over every shard before the backward (it does not
    depend on the parameters), so a shard of padded crops or of rare
    classes weighs what it weighs in the whole batch, where a mean of the
    shards' means would not. Each shard backpropagates its part of the sum
    on its device, :func:`reduce_gradients` sums the gradients, and every
    replica takes the same optimizer update, so the replicas stay equal bit
    for bit. The loss comes back as a 0-d tensor on the first data
    device. Over a mesh that spans processes (``parallel/mesh.py``) each
    process passes its own replicas and states and its pieces of the
    batch; the denominator, the gradients and the loss are summed over
    every process's shards, so every process gets the whole batch's loss
    and the same parameters."""
    devices = mesh.data_devices
    if len(replicas) != len(devices):
        raise ValueError(f"{len(replicas)} replicas for {len(devices)} data shards")

    def shard_loss(model, params, batch, total):
        for p in params.values():
            p.grad = None
        loss = segmentation_loss(model(batch["image"]), batch["label"], batch.get("mask"),
                                 class_weights, total=total)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in params.items()}

    backward = data_parallel_jit(shard_loss)
    update = data_parallel_jit(optimizer.step)

    def train_step(params: List[Dict[str, torch.Tensor]], opt_states: List[Any], shards):
        weights = [torch.sum(pixel_weights(b["label"], b.get("mask"), class_weights))
                   for b in shards]
        total = torch.clamp(sum_on_first(mesh, weights), min=1.0)
        losses, grads = zip(*backward(replicas, params, shards,
                                      [total.to(d) for d in devices]))
        update(params, reduce_gradients(mesh, grads, params), opt_states)
        return sum_on_first(mesh, losses)

    return train_step


def target_class_metrics(logits: torch.Tensor, labels: torch.Tensor,
                         target: int = 0):
    """(pixel accuracy, precision, recall of class ``target``) of the
    argmax of ``logits`` [B,H,W,C] against ``labels`` [B,H,W], as 0-d
    float32 tensors (the separator recipe's eval,
    ``scripts/train_synthetic_separator.py``)."""
    pred = torch.argmax(logits, dim=-1)
    acc = torch.mean((pred == labels).to(torch.float32))
    want = labels == target
    hit = ((pred == target) & want).sum()
    recall = hit / torch.clamp(want.sum(), min=1)
    precision = hit / torch.clamp((pred == target).sum(), min=1)
    return acc, precision.to(torch.float32), recall.to(torch.float32)


def make_eval_step(model: ARUNet):
    """``eval_step(batch, params=None)``: loss and pixel accuracy of the
    model, or of the model with ``params`` (``{name: tensor}``, e.g. the EMA
    shadow) in place of its own."""
    @torch.no_grad()
    def eval_step(batch, params: Optional[Dict[str, torch.Tensor]] = None):
        logits = (model(batch["image"]) if params is None else
                  torch.func.functional_call(model, params, (batch["image"],)))
        loss = segmentation_loss(logits, batch["label"], batch.get("mask"))
        pred = torch.argmax(logits, dim=-1)
        acc = torch.mean((pred == batch["label"]).to(torch.float32))
        return {"loss": loss, "accuracy": acc}
    return eval_step
