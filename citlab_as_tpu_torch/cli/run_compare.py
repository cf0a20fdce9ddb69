"""Split/merge comparison + tournament CLI (port of
``citlab_as_tpu/cli/run_compare.py``; reference: as_eval/run_compare.py:
33-112): walks GT pages against every clustering/<method>/ hypothesis
folder and writes the XLSX tournament report and the CSV of the
comparisons. Host only, as in the reference: it reads PAGE-XML and counts,
so it has no device to choose.

    python -m citlab_as_tpu_torch.cli.run_compare --gt_list gt.lst \
        --work_dir work --out_dir out [--name NAME] [--dataset DATASET]
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import List, Optional, Sequence

from citlab_as_tpu_torch.eval.compare import (
    CompDictEvaler, SepPageBlComper, SepPageCompDict,
)

logger = logging.getLogger(__name__)


def find_dirs(name: str, root: str = ".", exclude: Optional[str] = None) -> List[str]:
    results = []
    for path, dirs, _ in os.walk(root):
        if name in dirs:
            results.append(os.path.join(path, name))
    if exclude:
        for ex in exclude.split(","):
            results = [r for r in results if ex not in r]
    return results


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_list", type=str, default=None)
    parser.add_argument("--gt_dir", type=str, default=None)
    parser.add_argument("--exclude", type=str, default=None)
    parser.add_argument("--work_dir", type=str, required=True,
                        help="dir containing clustering/<method>/ folders")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--dataset", type=str, default="dataset")
    args = parser.parse_args(argv)

    if args.gt_dir and args.gt_list:
        parser.error("Only one of --gt_dir / --gt_list")
    if args.gt_dir:
        gt_path = find_dirs("page", root=args.gt_dir)[0]
        gt_files = [os.path.join(gt_path, f) for f in glob.glob1(gt_path, "*.xml")]
    elif args.gt_list:
        gt_files = [line.rstrip() for line in open(args.gt_list)]
    else:
        parser.error("Either --gt_list or --gt_dir is needed")

    clustering_paths = find_dirs("clustering", root=args.work_dir,
                                 exclude=args.exclude)

    comper = SepPageBlComper()
    spc = SepPageCompDict()
    for gt_file in gt_files:
        comper.loadGT(gt_file)
        cluster_name = os.path.splitext(os.path.basename(gt_file))[0] + "_clustering.xml"
        for clustering_path in clustering_paths:
            method_folders = [os.path.join(clustering_path, d)
                              for d in os.listdir(clustering_path)]
            if args.exclude:
                for ex in args.exclude.split(","):
                    method_folders = [m for m in method_folders if ex not in m]
            for method_path in (m for m in method_folders if os.path.isdir(m)):
                hyp_file = os.path.join(method_path, cluster_name)
                if not os.path.exists(hyp_file):
                    logger.warning("Missing hypothesis %s", hyp_file)
                    continue
                comp = comper.compareTo(hyp_file)
                spc.addItem(args.dataset, str(gt_file), str(hyp_file), comp)

    evaler = CompDictEvaler(spc)
    evaler.calcWinnerDict()
    os.makedirs(args.out_dir, exist_ok=True)
    out_name = f"{args.name}_comparison" if args.name else "comparison"
    xlsx_path = os.path.join(args.out_dir, f"{out_name}.xlsx")
    evaler.winnerStat2xlsx(xlsx_path)
    spc.expCsv(os.path.join(args.out_dir, f"{out_name}.csv"))
    logger.info("Wrote %s", xlsx_path)
    return spc, evaler


if __name__ == "__main__":
    main()
