"""Freeze a checkpoint into one deployable ``.frozen`` artifact (port of
``citlab_as_tpu/cli/run_export.py``). The predictors accept the result
wherever they accept a model path; the artifact is the JAX package's, so
either package serves it.

    python -m citlab_as_tpu_torch.cli.run_export \\
        --checkpoint_dir models_ckpt_torch/separator.npz --architecture arunet \\
        --model_kwargs '{"dtype": "bfloat16"}' --out separator.frozen

``--checkpoint_dir``: a trainer's model directory (its newest numbered
checkpoint), a ``best/<metric>`` export directory, each the JAX package's
orbax checkpoints (``models_ckpt/separator``, read without orbax) or the
port's, or an ``.npz`` of flat flax paths (``models_ckpt_torch/``). Host
only.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

from citlab_as_tpu_torch.config.flags import LineArgumentParser


def main(argv: Optional[Sequence[str]] = None):
    parser = LineArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_dir", required=True,
                        help="trainer checkpoint dir (newest step), a "
                             "best/<metric> export dir or an .npz")
    parser.add_argument("--out", required=True, help="output .frozen path")
    parser.add_argument("--architecture", required=True,
                        choices=["arunet", "graph_relation", "inception_v3"])
    parser.add_argument("--model_kwargs", default="{}",
                        help="JSON dict of model constructor kwargs")
    args = parser.parse_args(argv)

    from citlab_as_tpu_torch.train.export import export_checkpoint_frozen
    path = export_checkpoint_frozen(
        args.checkpoint_dir, args.out, args.architecture,
        model_kwargs=json.loads(args.model_kwargs))
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
