"""Train the ARU-Net separator (or heading) net on synthetic pages drawn on
the training device (port of ``scripts/train_synthetic_separator.py``).

Each step draws its batch with ``train/synthetic_data.py::synthetic_batch``
from a generator on the device seeded for that step, and takes one Adam
step (optax's ``adam`` over ``cosine_decay_schedule(lr, steps, alpha=0.1)``)
of the bf16 ARU-Net on the class-weighted cross-entropy (class 0, the
separator or heading pixels, weighs ``--target_class_weight``). The loss is
read back every 50 steps. The random stream is the port's own, so the loss
curve is not the JAX script's. Then accuracy, precision and recall of class
0 on a fresh batch, and an orbax checkpoint ``<model_dir>/<steps>/`` holding
``{"params": variables}`` as the JAX script saves it, which both packages'
``SegmentationPredictor`` load.

Usage: python -m citlab_as_tpu_torch.scripts.train_synthetic_separator
           --model_dir models/separator [--device cuda]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

#: the seed of the final eval batch, past any step's
EVAL_STEP = 10 ** 6


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator that draws step ``step``'s batch (jax's
    ``fold_in(PRNGKey(seed), step)`` in the JAX script)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def recipe_batch(seed: int, step: int, batch: int, crop: int, heading_mode: bool,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch of synthetic pages on ``device``."""
    from citlab_as_tpu_torch.train.synthetic_data import synthetic_batch
    image, label = synthetic_batch(step_generator(seed, step, device), batch, crop, crop,
                                   heading_mode=heading_mode, device=device)
    return {"image": image, "label": label}


def build(steps: int, lr: float, target_class_weight: float, seed: int,
          device: torch.device, dtype: torch.dtype = torch.bfloat16):
    """(model, params, opt_state, train_step): the ARU-Net with float32
    parameters computing in ``dtype``, the flax initializers drawn from
    ``seed``, and the recipe's optimizer and weighted loss."""
    from citlab_as_tpu_torch.train.optimizer import adam, cosine_decay_schedule
    from citlab_as_tpu_torch.train.segmentation import (
        create_model, init_params, make_train_step,
    )
    model = init_params(create_model(dtype=dtype), seed).to(device)
    params = dict(model.named_parameters())
    optimizer = adam(cosine_decay_schedule(lr, steps, alpha=0.1))
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, class_weights=(target_class_weight, 1.0))
    return model, params, opt_state, step


@torch.no_grad()
def evaluate(model, batch: Dict[str, torch.Tensor]):
    """(accuracy, precision, recall of class 0) as floats."""
    from citlab_as_tpu_torch.train.segmentation import target_class_metrics
    return tuple(float(v) for v in target_class_metrics(model(batch["image"]),
                                                         batch["label"]))


def save(model_dir: str, step: int, model) -> str:
    """``{"params": variables}`` as the orbax checkpoint ``<model_dir>/<step>``."""
    from citlab_as_tpu_torch.train.checkpoint import save_checkpoint, variables
    from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict
    flat = arunet_flax_from_state_dict(model.state_dict())
    return save_checkpoint(model_dir, step, {"params": variables(flat)})


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--mode", choices=["separator", "heading"],
                        default="separator")
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--crop", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--target_class_weight", type=float, default=8.0,
                        help="CE weight of the rare target class (0).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from citlab_as_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    heading_mode = args.mode == "heading"
    model, params, opt_state, train_step = build(
        args.steps, args.lr, args.target_class_weight, args.seed, device)

    t0 = time.time()
    for i in range(args.steps):
        loss = train_step(params, opt_state, recipe_batch(
            args.seed, i, args.batch, args.crop, heading_mode, device))
        if i % 50 == 0 or i == args.steps - 1:
            loss_val = float(loss)  # host sync only every 50 steps
            print(f"step {i}: loss={loss_val:.4f} ({time.time() - t0:.1f}s)",
                  flush=True)

    acc, precision, recall = evaluate(model, recipe_batch(
        args.seed, EVAL_STEP, args.batch, args.crop, heading_mode, device))
    print(f"final: acc={acc:.4f} sep_precision={precision:.4f} "
          f"sep_recall={recall:.4f}")

    path = save(args.model_dir, args.steps, model)
    print(f"saved checkpoint to {path}")
    return acc, precision, recall


if __name__ == "__main__":
    main()
