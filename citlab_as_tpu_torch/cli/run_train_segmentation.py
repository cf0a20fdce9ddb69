"""ARU-Net segmentation trainer CLI (separator / heading nets; port of
``citlab_as_tpu/cli/run_train_segmentation.py``).

The JAX CLI's flags and defaults, plus ``--device`` (default cuda). A
``--model_dir`` the JAX trainer wrote (orbax steps, ``current_epoch.info``)
resumes here, its optax state carried over (``train/checkpoint.py``); the
port writes its steps there as the JAX trainer does (orbax checkpoints,
``train/orbax.py``), so the JAX package resumes and serves them. As the
JAX CLI, it first brings up multi-process ``torch.distributed`` when a
coordinator is configured (``parallel/mesh.py::initialize_multihost``;
torchrun's variables; a no-op in one process); the trainer itself, as the
JAX one, trains on one device and shards no batch. The net trains in
bf16 compute with float32 weights, as the JAX trainer's; the best export
``<model_dir>/best/accuracy`` (the net's variables) loads into
``SegmentationPredictor`` and the workflow's ``--separator_model_dir``, and
freezes with ``run_export`` into a ``.frozen``."""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    # multi-process bring-up when torchrun's coordinator variables are set;
    # a no-op in one process (parallel/mesh.py)
    from citlab_as_tpu_torch.parallel.mesh import initialize_multihost
    initialize_multihost()
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--train_gt_dir", type=str, required=True,
                        help="GT generator output dir (grey imgs + C3/).")
    parser.add_argument("--eval_gt_dir", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--steps_per_epoch", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--crop_size", type=int, nargs=2, default=(512, 512))
    parser.add_argument("--n_classes", type=int, default=2)
    parser.add_argument("--graph", type=str, default="ARU",
                        choices=["U", "RU", "ARU"])
    parser.add_argument("--ema_decay", type=float, default=0.0)
    parser.add_argument("--early_stopping_patience", type=int, default=0)
    parser.add_argument("--optimizer_params", nargs="*", default=[],
                        metavar="KEY=VAL")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from citlab_as_tpu_torch.cli.common import clustering_params as key_value_params
    from citlab_as_tpu_torch.train.seg_trainer import TrainerSegmentation

    trainer = TrainerSegmentation(
        args.model_dir, args.train_gt_dir, args.eval_gt_dir,
        flags={"epochs": args.epochs, "steps_per_epoch": args.steps_per_epoch,
               "batch_size": args.batch_size,
               "crop_size": tuple(args.crop_size),
               "n_classes": args.n_classes, "ema_decay": args.ema_decay,
               "early_stopping_patience": args.early_stopping_patience},
        graph_params={"graph": args.graph},
        optimizer_params=key_value_params(args.optimizer_params),
        seed=args.seed, device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main()
