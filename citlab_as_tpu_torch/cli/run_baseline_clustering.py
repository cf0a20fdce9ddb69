"""Baseline clustering CLI (port of
``citlab_as_tpu/cli/run_baseline_clustering.py``): DBSCAN over each page's
baselines, the article ids written into the page in place. Host only.
``--num_workers`` fans the page list over a process pool
(``utils/workers.py``)."""
from __future__ import annotations

import argparse
import functools
from typing import Optional, Sequence

from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
from citlab_as_tpu_torch.utils.io import load_list_file
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


def _build_cluster_fn(kwargs):
    return functools.partial(cluster_page, **kwargs)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_xml_file", type=str, default=None,
                        help="Single PAGE-XML to process.")
    parser.add_argument("--path_to_xml_lst", type=str, default=None,
                        help="List file of PAGE-XML paths.")
    parser.add_argument("--min_polygons_for_cluster", type=int, default=2)
    parser.add_argument("--min_polygons_for_article", type=int, default=1)
    parser.add_argument("--rectangle_interline_factor", type=float, default=1.25)
    parser.add_argument("--des_dist", type=int, default=5)
    parser.add_argument("--max_d", type=int, default=500)
    parser.add_argument("--target_avg_interline_distance", type=int, default=50)
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Fan pages over a process pool (0 = in-process).")
    args = parser.parse_args(argv)

    if args.path_to_xml_file:
        paths = [args.path_to_xml_file]
    elif args.path_to_xml_lst:
        paths = load_list_file(args.path_to_xml_lst)
    else:
        parser.error("Provide --path_to_xml_file or --path_to_xml_lst")

    from citlab_as_tpu_torch.utils.workers import run_sharded
    kwargs = dict(
        min_polygons_for_cluster=args.min_polygons_for_cluster,
        min_polygons_for_article=args.min_polygons_for_article,
        rectangle_interline_factor=args.rectangle_interline_factor,
        des_dist=args.des_dist, max_d=args.max_d,
        target_average_interline_distance=args.target_avg_interline_distance)
    _, skipped = run_sharded(functools.partial(_build_cluster_fn, kwargs),
                             paths, args.num_workers)
    logger.info("Processed %d/%d files (%d skipped).",
                len(paths) - len(skipped), len(paths), len(skipped))
    for path in skipped:
        logger.info("skipped: %s", path)
    return skipped


if __name__ == "__main__":
    main()
