"""Convert a checkpoint of the JAX package into an ``.npz`` for the PyTorch
port.

An ARU-Net checkpoint is restored exactly as
``SegmentationPredictor(model_dir)`` restores it, a relation-GNN checkpoint
(``--kind gnn``) as ``RelationPredictor(model_dir)._ensure_params`` does
(init at the first group's widths, then ``restore_checkpoint`` or the
``best/<metric>`` export). The parameter tree is flattened to ``/``-joined
flax paths (``params/featMapG/unet_down_0/conv1/conv/kernel``,
``params/GraphLSTM1/update_fn/ingate/kernel``) and saved as float32 arrays.
The port reads the file with numpy and maps it through
``citlab_as_tpu_torch.weights.{arunet,gnn}_state_dict_from_flax``.

The conversion is optional: it needs JAX and orbax, which the card's
machine lacks, and the port reads the same orbax directories there itself
(``citlab_as_tpu_torch/train/orbax.py``: every ``--model_dir``, the
predictors, ``run_export`` and a training resume). The committed
``models_ckpt_torch/*.npz`` stay as the tests' second copy of the weights,
which the port's own reading of ``models_ckpt/`` must equal bit for bit.

    python scripts/convert_weights_to_torch.py \
        --model_dir models_ckpt/separator --out models_ckpt_torch/separator.npz
    python scripts/convert_weights_to_torch.py \
        --model_dir models_ckpt/heading --out models_ckpt_torch/heading.npz
    python scripts/convert_weights_to_torch.py --kind gnn \
        --model_dir models_ckpt/gnn/best/f1 --out models_ckpt_torch/gnn.npz
    python scripts/convert_weights_to_torch.py --kind gnn \
        --model_dir models_ckpt/gnn_pipeline/best/f1 \
        --out models_ckpt_torch/gnn_pipeline.npz
    python scripts/convert_weights_to_torch.py --kind gnn_visual \
        --model_dir models_ckpt/gnn_visual/best/f1 \
        --out models_ckpt_torch/gnn_visual.npz

Both committed ARU-Nets (separator, heading) have the same architecture; the
defaults convert the separator's. ``--kind`` defaults to ``gnn_visual`` for
a ``--model_dir`` under a ``gnn_visual`` directory, to ``gnn`` under any
other ``gnn*`` directory. The committed relation GNNs (``gnn``,
``gnn_pipeline``, ``gnn_visual``) take 15 node and 2 edge features; the
visual one is restored as ``RelationPredictor(image_input=True,
visual_backbone="ARU_cutted_v1")`` restores it, with its
``params/visual/...`` subtree (the ARU_cutted backbone and the three
compress layers).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flax_params(model_dir: str) -> Dict[str, np.ndarray]:
    """Flat {path: float32 ndarray} of the checkpoint's variables.

    The same ``restore_checkpoint(model_dir, {"params": variables})`` call
    as ``SegmentationPredictor.__init__``, with the variables' template
    taken from ``jax.eval_shape`` of the model's init (the restore fills
    every leaf from the checkpoint; an eager init only costs time)."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from citlab_as_tpu.models.arunet import ARUNet
    from citlab_as_tpu.train.checkpoint import restore_checkpoint
    model = ARUNet(n_classes=2)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 1), jnp.float32)))
    sharding = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sharding),
        shapes)
    state, step = restore_checkpoint(model_dir, {"params": template})
    if step is None:
        raise FileNotFoundError(f"No checkpoint found in {model_dir}")
    flat = traverse_util.flatten_dict(state["params"], sep="/")
    return {k: np.asarray(v, np.float32) for k, v in sorted(flat.items())}


def gnn_flax_params(model_dir: str, node_feature_dim: int = 15,
                    edge_feature_dim: int = 2, visual: bool = False
                    ) -> Dict[str, np.ndarray]:
    """Flat {path: float32 ndarray} of a relation-GNN checkpoint, restored by
    ``RelationPredictor._ensure_params`` on a small graph of the given
    feature widths (the widths fix the shapes of the init template); a
    visual net also takes one small page image and a region per node."""
    from flax import traverse_util

    from citlab_as_tpu.inference import RelationPredictor
    from citlab_as_tpu.models.gnn.graph import fully_connected_edges
    n = 4
    edges = fully_connected_edges(n)
    graph = {"num_nodes": n,
             "node_features": np.zeros((n, node_feature_dim), np.float32),
             "interacting_nodes": edges,
             "edge_features": np.zeros((len(edges), edge_feature_dim), np.float32)}
    images = None
    if visual:
        graph["visual_regions_nodes"] = [[[0, 10, 10, 0], [0, 0, 10, 10]]] * n
        graph["num_points_visual_regions_nodes"] = [4] * n
        images = [np.zeros((64, 48), np.uint8)]
        pred = RelationPredictor(model_dir, image_input=True,
                                 visual_backbone="ARU_cutted_v1",
                                 image_min_dimension=288, image_max_dimension=384)
    else:
        pred = RelationPredictor(model_dir)
    inputs, _ = pred._batch_inputs([graph], images)
    pred._ensure_params(inputs)
    flat = traverse_util.flatten_dict(pred.variables, sep="/")
    return {k: np.asarray(v, np.float32) for k, v in sorted(flat.items())}


def _kind_of(model_dir: str) -> str:
    parts = os.path.normpath(os.path.abspath(model_dir)).split(os.sep)
    if "gnn_visual" in parts:
        return "gnn_visual"
    return "gnn" if any(p.startswith("gnn") for p in parts) else "arunet"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_dir",
                        default=os.path.join(REPO, "models_ckpt", "separator"))
    parser.add_argument("--out", default=os.path.join(
        REPO, "models_ckpt_torch", "separator.npz"))
    parser.add_argument("--kind", choices=("arunet", "gnn", "gnn_visual"), default=None,
                        help="net of the checkpoint (default: gnn_visual under a "
                             "gnn_visual directory, gnn under another gnn* "
                             "directory, else arunet)")
    args = parser.parse_args(argv)
    kind = args.kind or _kind_of(args.model_dir)
    if kind == "arunet":
        params = flax_params(args.model_dir)
    else:
        params = gnn_flax_params(args.model_dir, visual=kind == "gnn_visual")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **params)
    n = sum(v.size for v in params.values())
    print(f"wrote {args.out}: {len(params)} arrays, {n} parameters")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
