"""AS measure CLI (port of ``citlab_as_tpu/cli/run_measure.py``): baseline
detection and article-separation R/P/F of hypothesis pages against GT
pages, averaged over the page pairs. Host only.

    python -m citlab_as_tpu_torch.cli.run_measure \\
        --path_to_gt_xml_lst gt.lst --path_to_hy_xml_lst hy.lst
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from citlab_as_tpu_torch.eval.measure import run_measure
from citlab_as_tpu_torch.utils.io import load_list_file


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_gt_xml_lst", type=str, required=True)
    parser.add_argument("--path_to_hy_xml_lst", type=str, required=True)
    parser.add_argument("--min_tol", type=int, default=-1)
    parser.add_argument("--max_tol", type=int, default=-1)
    parser.add_argument("--rel_tol", type=float, default=0.25)
    parser.add_argument("--poly_tick_dist", type=int, default=5)
    parser.add_argument("--verbose", action="store_true", default=True)
    args = parser.parse_args(argv)

    gt_files = load_list_file(args.path_to_gt_xml_lst)
    hy_files = load_list_file(args.path_to_hy_xml_lst)
    # filter hy files by gt basenames (train/val/test splits), then sort both
    gt_names = [os.path.splitext(os.path.basename(f))[0] for f in gt_files]
    hy_files = sorted(
        [f for f in hy_files if any(g in os.path.basename(f) for g in gt_names)],
        key=os.path.basename)
    gt_files = sorted(gt_files, key=os.path.basename)

    return run_measure(gt_files, hy_files, args.min_tol, args.max_tol,
                       args.rel_tol, args.poly_tick_dist, args.verbose)


if __name__ == "__main__":
    main()
