"""LAV CLI: load-and-validate a relation model the port trained (port of
``citlab_as_tpu/cli/run_lav.py``; reference: gnn/trainer/lav_rel.py).

Restores ``params`` from the newest checkpoint of ``--model_dir``, an
orbax step the JAX package or the port wrote (read without orbax,
``train/orbax.py``) or an earlier port run's ``checkpoint.npz``
(``train/checkpoint.py``), as the JAX CLI restores them. ``--device`` (default cuda) picks where the net runs."""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--eval_list", type=str, required=True)
    parser.add_argument("--num_p_r_thresholds", type=int, default=20)
    parser.add_argument("--out_json", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from citlab_as_tpu_torch.device import resolve_device
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.train.checkpoint import flatten, restore_checkpoint
    from citlab_as_tpu_torch.train.input_pipeline import InputGNN
    from citlab_as_tpu_torch.train.lav import lav_relation
    from citlab_as_tpu_torch.utils.io import load_list_file
    from citlab_as_tpu_torch.weights import gnn_state_dict_from_flax

    device = resolve_device(args.device)
    eval_list = load_list_file(args.eval_list)
    batch_np, _, _ = next(iter(InputGNN().eval_batches(eval_list)))
    model = GraphRelation(node_feature_dim=batch_np["node_features"].shape[-1],
                          edge_feature_dim=batch_np["edge_features"].shape[-1],
                          num_classes=2)
    state, step = restore_checkpoint(args.model_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoint in {args.model_dir}")
    model.load_state_dict(gnn_state_dict_from_flax(flatten(state["params"])))
    result = lav_relation(model.to(device).eval(), eval_list,
                          num_p_r_thresholds=args.num_p_r_thresholds)
    print(json.dumps(result, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
