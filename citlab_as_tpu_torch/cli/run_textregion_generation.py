"""Text region generation CLI (port of
``citlab_as_tpu/cli/run_textregion_generation.py``): one TextRegion per
article from the alpha shape of its lines, written into the page in
place. Host only. ``--num_workers`` fans pages over a process pool
(``utils/workers.py``)."""
from __future__ import annotations

import argparse
import functools
from typing import Optional, Sequence

from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page
from citlab_as_tpu_torch.utils.io import load_list_file
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


def _build_region_fn(kwargs):
    return functools.partial(generate_text_regions_for_page, **kwargs)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_xml_file", type=str, default=None)
    parser.add_argument("--path_to_xml_lst", type=str, default=None)
    parser.add_argument("--des_dist", type=int, default=50)
    parser.add_argument("--max_d", type=int, default=100)
    parser.add_argument("--alpha", type=float, default=75)
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
    kwargs = dict(des_dist=args.des_dist, max_d=args.max_d, alpha=args.alpha)
    _, skipped = run_sharded(functools.partial(_build_region_fn, kwargs),
                             paths, args.num_workers)
    logger.info("Processed %d/%d files.", len(paths) - len(skipped), len(paths))
    return skipped


if __name__ == "__main__":
    main()
