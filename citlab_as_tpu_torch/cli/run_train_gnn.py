"""GNN relation trainer CLI (port of ``citlab_as_tpu/cli/run_train_gnn.py``;
reference: gnn/trainer/trainer_rel.py:62-69).

The JAX CLI's flags and defaults, plus ``--device`` (default cuda). A
``--model_dir`` the JAX trainer wrote (orbax steps, ``current_epoch.info``)
resumes here, its optax state carried over (``train/checkpoint.py``); the
port writes its steps and best exports there as the JAX trainer does
(orbax checkpoints, ``train/orbax.py``), so the JAX package resumes and
serves them. As the
JAX CLI, it first brings up multi-process ``torch.distributed`` when a
coordinator is configured (``parallel/mesh.py::initialize_multihost``;
torchrun's variables; a no-op in one process); the trainer itself, as the
JAX one, trains on one device and shards no batch."""
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
    parser.add_argument("--train_list", type=str, required=True)
    parser.add_argument("--eval_list", type=str, required=True)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--samples_per_epoch", type=int, default=8192)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--eval_every_n", type=int, default=1)
    parser.add_argument("--early_stopping_patience", type=int, default=0)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--ema_decay", type=float, default=0.0)
    parser.add_argument("--sample_num_relations", type=int, default=300)
    parser.add_argument("--augmentation", type=str, nargs="*", default=[],
                        help="subset of scaling rotation translation")
    parser.add_argument("--node_input_feature_mask", type=str, default=None)
    parser.add_argument("--edge_input_feature_mask", type=str, default=None)
    parser.add_argument("--optimizer_params", nargs="*", default=[],
                        metavar="KEY=VAL")
    parser.add_argument("--schedule", type=str, default="final_decay",
                        choices=["decay", "final_decay", "warmup_final_decay"])
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    parser.add_argument("--export_curves", action="store_true", default=False,
                        help="dump PR/ROC curve JSONs per eval epoch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from citlab_as_tpu_torch.cli.common import clustering_params as key_value_params
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    from citlab_as_tpu_torch.utils.io import load_list_file

    def parse_mask(s):
        return [int(v) for v in s.strip("[]").split(",")] if s else []

    trainer = TrainerGNN(
        args.model_dir,
        load_list_file(args.train_list),
        load_list_file(args.eval_list),
        flags={
            "epochs": args.epochs,
            "samples_per_epoch": args.samples_per_epoch,
            "batch_size": args.batch_size,
            "eval_every_n": args.eval_every_n,
            "early_stopping_patience": args.early_stopping_patience,
            "weight_decay": args.weight_decay,
            "ema_decay": args.ema_decay,
            "schedule_kind": args.schedule,
            "grad_accum_steps": args.grad_accum_steps,
            "export_curves": args.export_curves,
        },
        input_params={
            "sample_num_relations_to_consider": args.sample_num_relations,
            "augmentation_config": args.augmentation,
            "node_input_feature_mask": parse_mask(args.node_input_feature_mask),
            "edge_input_feature_mask": parse_mask(args.edge_input_feature_mask),
        },
        optimizer_params=key_value_params(args.optimizer_params),
        seed=args.seed, device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main()
