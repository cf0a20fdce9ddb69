"""Net output visualisation and accuracy tool (port of
``citlab_as_tpu/cli/plot_net_output.py``; reference:
article_separation/plot_net_output.py:41-344).

    python -m citlab_as_tpu_torch.cli.plot_net_output \\
        --path_to_img_lst images.lst --model_dir models_ckpt_torch/separator.npz \\
        --save_folder out [--fixed_height 1500] [--device cpu]

Each page is scaled to ``--fixed_height``, runs through the ARU-Net on the
device (``--model_dir``: the JAX package's orbax model directory, e.g.
``models_ckpt/separator``, or a ``.frozen``; ``--model``: a converted
``.npz`` or a ``.frozen``; none = random weights), and every net-output channel but the
last ('other') is blended into the page where its probability exceeds 0.5.
The composite is the array the JAX tool builds before its matplotlib
figure; it is written with ``utils/io.py::save_png`` as
``<save_folder>/<name>_net.png`` (the JAX tool saves the figure instead).
"""
from __future__ import annotations

import argparse
import colorsys
import os
import random
from typing import Optional, Sequence

import numpy as np


def random_colors(n: int, bright: bool = True, seed: int = 0):
    """n visually distinct RGB colours via HSV sampling (plot_net_output.py:41-54)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(i / n, 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    random.Random(seed).shuffle(colors)
    return colors


def apply_mask(image: np.ndarray, mask: np.ndarray, color, alpha: float = 0.5):
    """Blend a binary mask into an RGB image (plot_net_output.py:57-69)."""
    out = image.astype(np.float32).copy()
    for c in range(3):
        out[..., c] = np.where(
            mask > 0, out[..., c] * (1 - alpha) + alpha * color[c] * 255,
            out[..., c])
    return out.astype(np.uint8)


def compute_accuracy(hyp_image: np.ndarray, gt_image: np.ndarray) -> float:
    """Pixel agreement of two binary maps (plot_net_output.py:109-117)."""
    hyp = np.asarray(hyp_image) > 0
    gt = np.asarray(gt_image) > 0
    return float((hyp == gt).mean())


def plot_image_with_net_output(image: np.ndarray, net_output: np.ndarray,
                               save_path: Optional[str] = None) -> np.ndarray:
    """Overlay each net-output channel (minus 'other') onto the image;
    returns the RGB uint8 composite and writes it as a PNG at
    ``save_path``."""
    from citlab_as_tpu_torch.utils.io import save_png

    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    n_channels = net_output.shape[-1]
    colors = random_colors(max(n_channels - 1, 1))
    out = image
    for c in range(n_channels - 1):
        mask = (net_output[..., c] > 0.5).astype(np.uint8)
        out = apply_mask(out, mask, colors[c])
    if save_path:
        save_png(save_path, out)
    return out


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_img_lst", type=str, required=True)
    parser.add_argument("--model_dir", type=str, default=None,
                        help="the JAX CLI's orbax model directory, or a .frozen artifact")
    parser.add_argument("--model", type=str, default=None,
                        help="converted ARU-Net (.npz) or a .frozen artifact; "
                             "none = random weights")
    parser.add_argument("--save_folder", type=str, default="")
    parser.add_argument("--fixed_height", type=int, default=1500)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from citlab_as_tpu_torch.cli.common import model_path
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops.resize import scale_image
    from citlab_as_tpu_torch.utils.io import load_image, load_list_file

    predictor = SegmentationPredictor(model_path(args.model, args.model_dir),
                                      dtype=torch.bfloat16, device=args.device)
    os.makedirs(args.save_folder or ".", exist_ok=True)
    written = []
    for image_path in load_list_file(args.path_to_img_lst):
        image = load_image(image_path, mode="L").astype(np.float32)
        scaled, _ = scale_image(torch.from_numpy(image), args.fixed_height, 1.0)
        scaled = scaled.numpy()
        probs = predictor(scaled / 255.0)
        name = os.path.splitext(os.path.basename(image_path))[0] + "_net.png"
        written.append(os.path.join(args.save_folder or ".", name))
        plot_image_with_net_output(scaled.astype(np.uint8), probs, save_path=written[-1])
    return written


if __name__ == "__main__":
    main()
