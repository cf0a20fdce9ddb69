"""GNN graph-feature generation CLI (port of
``citlab_as_tpu/cli/run_feature_generation.py``): one graph JSON per page
(nodes = text regions, Delaunay or full interaction). Host only.
``--num_workers`` fans pages over a process pool (``utils/workers.py``).
``--language`` with ``--wv_path`` (word2vec text or ``.npz``) adds the
word-vector text-block similarity to every edge's features
(``stages/textblock_similarity.py``)."""
from __future__ import annotations

import argparse
import functools
from typing import Optional, Sequence

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
                        help="stop-word language of the text-block similarity")
    parser.add_argument("--wv_path", type=str, default=None,
                        help="word vectors (word2vec text or .npz) of the "
                             "text-block similarity")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Fan pages over a process pool (0 = in-process).")
    args = parser.parse_args(argv)

    page_paths = load_list_file(args.pagexml_list)
    kwargs = dict(
        out_path=args.out_path, interaction=args.interaction,
        visual_regions=args.visual_regions, json_list=args.external_jsons,
        tb_similarity_setup=(args.language, args.wv_path),
        separators=args.separators)
    if args.num_workers <= 1:
        return generate_feature_jsons(page_paths, **kwargs)
    from citlab_as_tpu_torch.utils.workers import run_sharded
    results, _ = run_sharded(functools.partial(_build_page_fn, kwargs),
                             page_paths, args.num_workers)
    return [path for _, written in results for path in written]


if __name__ == "__main__":
    main()
