"""Separator / heading detection CLI (port of
``citlab_as_tpu/cli/run_net_post_processing.py``). Defaults: fixed_height
1500 (separator) / 900 (heading), threshold 0.05.

    python -m citlab_as_tpu_torch.cli.run_net_post_processing \\
        --path_to_image_list images.lst --mode separator \\
        --model models_ckpt_torch/separator.npz [--batch_size 4] [--device cpu]

Each image needs ``page/<name>.xml`` beside it; the stage writes
``page/<name>.xml.xml``. ``--batch_size N`` runs groups of N pages through
the fused device path of the stage (both modes); 0 runs page by page.
``--model`` or ``--model_dir`` may name a ``.frozen`` artifact;
``--sharded`` (multi-GPU) and an orbax ``--model_dir`` raise.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from citlab_as_tpu_torch.cli.common import refuse, model_path
from citlab_as_tpu_torch.utils.io import load_list_file


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_image_list", type=str, required=True,
                        help="List file holding the image paths.")
    parser.add_argument("--model", type=str, default=None,
                        help="converted ARU-Net (.npz) or a .frozen artifact; "
                             "none = random weights")
    parser.add_argument("--model_dir", type=str, default=None,
                        help="a .frozen artifact (an orbax checkpoint directory raises)")
    parser.add_argument("--mode", type=str, required=True,
                        choices=["heading", "separator"])
    parser.add_argument("--fixed_height", type=int, default=None)
    parser.add_argument("--scaling_factor", type=float, default=1.0)
    parser.add_argument("--threshold", type=float, default=0.05,
                        help="Binarization threshold for the net output.")
    parser.add_argument("--text_line_percentage", type=float, default=0.8)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="batch pages through the net (0 = per page)")
    parser.add_argument("--sharded", action="store_true", default=False,
                        help="multi-GPU inference: not ported")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    weights = model_path(args.model, args.model_dir)
    if args.sharded:
        refuse("--sharded", "multi-GPU inference is not ported (ROADMAP Queue 1 item 17)")

    import torch
    from citlab_as_tpu_torch.inference import SegmentationPredictor

    image_paths = load_list_file(args.path_to_image_list)
    fixed_height = args.fixed_height
    if fixed_height is None:
        fixed_height = 900 if args.mode == "heading" else 1500
    predictor = SegmentationPredictor(weights, dtype=torch.bfloat16, device=args.device)

    if args.mode == "separator":
        from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
        proc = SeparatorNetPostProcessor(
            image_paths, predictor, fixed_height=fixed_height,
            scaling_factor=args.scaling_factor, threshold=args.threshold,
            device=args.device)
        if args.batch_size > 0:
            return proc.run_batched_fused(args.batch_size)
        return proc.run()
    from citlab_as_tpu_torch.stages.heading import HeadingNetPostProcessor
    proc = HeadingNetPostProcessor(
        image_paths, predictor, fixed_height=fixed_height,
        scaling_factor=args.scaling_factor,
        threshold=0.4, text_line_percentage=args.text_line_percentage)
    if args.batch_size > 0:
        return proc.run_batched(args.batch_size)
    return proc.run()


if __name__ == "__main__":
    main()
