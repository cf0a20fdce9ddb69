"""AS ground-truth generation CLI (port of
``citlab_as_tpu/cli/run_as_gt_generation.py``; reference:
ground_truth_generators/run_as_gt_generation.py). For every PAGE-XML file
of the list, the article channel (+ baseline channel) and the 'other'
complement, dilated on the device, as ``<name>_GT<i>_<channel>.png`` in
the save folder. A page that fails is logged and skipped.

    python -m citlab_as_tpu_torch.cli.run_as_gt_generation \\
        --pagexml_list pages.lst --save_folder as_gt [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from citlab_as_tpu_torch.device import resolve_device
from citlab_as_tpu_torch.stages.ground_truth import generate_as_ground_truth
from citlab_as_tpu_torch.utils.io import load_list_file
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of pages generated."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pagexml_list", type=str, required=True)
    parser.add_argument("--save_folder", type=str, required=True)
    parser.add_argument("--scaling_factor", type=float, default=1.0)
    parser.add_argument("--fill_articles", action="store_true", default=False)
    parser.add_argument("--with_baseline_gt", action="store_true", default=True)
    parser.add_argument("--no_baseline_gt", dest="with_baseline_gt",
                        action="store_false")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    page_paths = load_list_file(args.pagexml_list)
    done = 0
    for page_path in page_paths:
        try:
            generate_as_ground_truth(
                page_path, save_folder=args.save_folder,
                scaling_factor=args.scaling_factor,
                fill_articles=args.fill_articles,
                with_baseline_gt=args.with_baseline_gt, device=device)
            done += 1
        except Exception as e:
            logger.error("Skipping %s: %s", page_path, e)
    logger.info("Generated AS GT for %d/%d pages.", done, len(page_paths))
    return done


if __name__ == "__main__":
    main()
