"""GNN graph-feature generation CLI (port of
``citlab_as_tpu/cli/run_feature_generation.py``): one graph JSON per page
(nodes = text regions, Delaunay or full interaction). Host only.
``--num_workers`` fans pages over a process pool (``utils/workers.py``).
``--language`` / ``--wv_path`` (the word-vector text-block similarity
feature) raise: that feature is not ported."""
from __future__ import annotations

import argparse
import functools
from typing import Optional, Sequence

from citlab_as_tpu_torch.cli.common import refuse
from citlab_as_tpu_torch.stages.features import generate_feature_jsons
from citlab_as_tpu_torch.utils.io import load_list_file


def _build_page_fn(kwargs):
    return functools.partial(_one_page, kwargs)


def _one_page(kwargs, page_path):
    return generate_feature_jsons([page_path], **kwargs)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pagexml_list", type=str, required=True)
    parser.add_argument("--out_path", type=str, default=None)
    parser.add_argument("--interaction", type=str, default="delaunay",
                        choices=["delaunay", "fully"])
    parser.add_argument("--visual_regions", action="store_true", default=False)
    parser.add_argument("--external_jsons", type=str, nargs="*", default=None)
    parser.add_argument("--separators", type=str, default="bb",
                        choices=["bb", "line"])
    parser.add_argument("--language", type=str, default=None,
                        help="word-vector similarity feature: not ported")
    parser.add_argument("--wv_path", type=str, default=None,
                        help="word-vector similarity feature: not ported")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Fan pages over a process pool (0 = in-process).")
    args = parser.parse_args(argv)
    for flag, value in (("--language", args.language), ("--wv_path", args.wv_path)):
        if value is not None:
            refuse(flag, "the word-vector text-block similarity feature is not "
                   "ported (ROADMAP Queue 1 item 19)")

    page_paths = load_list_file(args.pagexml_list)
    kwargs = dict(
        out_path=args.out_path, interaction=args.interaction,
        visual_regions=args.visual_regions, json_list=args.external_jsons,
        separators=args.separators)
    if args.num_workers <= 1:
        return generate_feature_jsons(page_paths, **kwargs)
    from citlab_as_tpu_torch.utils.workers import run_sharded
    results, _ = run_sharded(functools.partial(_build_page_fn, kwargs),
                             page_paths, args.num_workers)
    return [path for _, written in results for path in written]


if __name__ == "__main__":
    main()
