"""Convert an ARU-Net checkpoint of the JAX package into an ``.npz`` for the
PyTorch port.

The checkpoint is restored exactly as ``SegmentationPredictor(model_dir)``
restores it; the parameter tree is flattened to ``/``-joined flax paths
(``params/featMapG/unet_down_0/conv1/conv/kernel``) and saved as float32
arrays. The port reads the file with numpy and maps it through
``citlab_as_tpu_torch.weights.arunet_state_dict_from_flax``.

    python scripts/convert_weights_to_torch.py \
        --model_dir models_ckpt/separator --out models_ckpt_torch/separator.npz
    python scripts/convert_weights_to_torch.py \
        --model_dir models_ckpt/heading --out models_ckpt_torch/heading.npz

Both committed ARU-Nets (separator, heading) have the same architecture; the
defaults convert the separator's.
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_dir",
                        default=os.path.join(REPO, "models_ckpt", "separator"))
    parser.add_argument("--out", default=os.path.join(
        REPO, "models_ckpt_torch", "separator.npz"))
    args = parser.parse_args(argv)
    params = flax_params(args.model_dir)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **params)
    n = sum(v.size for v in params.values())
    print(f"wrote {args.out}: {len(params)} arrays, {n} parameters")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
