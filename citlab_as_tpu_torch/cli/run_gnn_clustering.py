"""GNN relation inference + clustering CLI (port of
``citlab_as_tpu/cli/run_gnn_clustering.py``): the relation net's
confidences per page graph, clustered into articles and written as
``<out_dir>/<method>/<page>_clustering.xml``.

    python -m citlab_as_tpu_torch.cli.run_gnn_clustering \\
        --eval_list jsons.lst --model models_ckpt_torch/gnn.npz [--device cpu]

``--model_dir`` takes the JAX CLI's orbax model directory (its newest step,
else the directory as a ``best/<metric>`` export:
``models_ckpt/gnn/best/f1``) or a ``.frozen`` artifact, ``--model`` a
converted ``.npz`` or a ``.frozen``; the relation net runs on ``--device``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from citlab_as_tpu_torch.cli.common import clustering_params, model_path
from citlab_as_tpu_torch.utils.io import load_list_file
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


def _parse_mask(mask_str):
    if not mask_str:
        return None
    return [int(v) for v in mask_str.strip("[]").split(",")]


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", type=str, default=None,
                        help="converted relation GNN (.npz) or a .frozen artifact; "
                             "none = random weights")
    parser.add_argument("--model_dir", type=str, default=None,
                        help="the JAX CLI's orbax model directory, or a .frozen artifact")
    parser.add_argument("--eval_list", type=str, required=True,
                        help="List of graph-feature JSON paths.")
    parser.add_argument("--clustering_method", type=str, default="dbscan",
                        choices=["greedy", "dbscan", "dbscan_std", "linkage"])
    parser.add_argument("--clustering_params", nargs="*", default=[],
                        metavar="KEY=VAL")
    parser.add_argument("--node_input_feature_mask", type=str, default=None,
                        help="e.g. [1,1,1,1,0,0,0,0,0,0,0,0,1,1,1]")
    parser.add_argument("--edge_input_feature_mask", type=str, default=None)
    parser.add_argument("--save_conf", action="store_true", default=False)
    parser.add_argument("--out_dir", type=str, default="")
    parser.add_argument("--mask_horizontally_separated_confs",
                        action="store_true", default=False)
    parser.add_argument("--mask_heading_separated_confs",
                        action="store_true", default=False)
    parser.add_argument("--image_input", action="store_true", default=False,
                        help="Visual 'v' nets: feed the page image through "
                             "the visual backbone.")
    parser.add_argument("--visual_backbone", type=str, default="ARU_v1")
    parser.add_argument("--assign_visual_features_to_nodes",
                        type=lambda s: s.lower() != "false", default=True)
    parser.add_argument("--assign_visual_features_to_edges",
                        type=lambda s: s.lower() != "false", default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    weights = model_path(args.model, args.model_dir)

    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.stages.gnn_io import gnn_clustering_for_page

    params = clustering_params(args.clustering_params)
    predictor = RelationPredictor(
        weights,
        node_feature_mask=_parse_mask(args.node_input_feature_mask),
        edge_feature_mask=_parse_mask(args.edge_input_feature_mask),
        image_input=args.image_input,
        visual_backbone=args.visual_backbone,
        assign_visual_features_to_nodes=args.assign_visual_features_to_nodes,
        assign_visual_features_to_edges=args.assign_visual_features_to_edges,
        device=args.device)

    json_paths = load_list_file(args.eval_list)
    written = []
    for json_path in json_paths:
        try:
            written.append(gnn_clustering_for_page(
                json_path, predictor,
                clustering_method=args.clustering_method,
                clustering_params=params,
                save_conf=args.save_conf, out_dir=args.out_dir,
                mask_horizontally_separated=args.mask_horizontally_separated_confs,
                mask_heading_separated=args.mask_heading_separated_confs))
        except Exception as e:  # noqa: BLE001 - per-page skip, as the JAX CLI
            logger.error("Skipping %s: %s", json_path, e)
    logger.info("Clustered %d/%d pages.", len(written), len(json_paths))
    return written


if __name__ == "__main__":
    main()
