"""Re-cluster from saved confidence JSONs (port of
``citlab_as_tpu/cli/run_conf_to_cluster.py``): no net, host only."""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from citlab_as_tpu_torch.cli.common import clustering_params
from citlab_as_tpu_torch.stages.gnn_io import conf_to_cluster
from citlab_as_tpu_torch.utils.io import load_list_file


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--conf_list", type=str, required=True,
                        help="List of *_confidences.json paths.")
    parser.add_argument("--clustering_method", type=str, default="greedy",
                        choices=["greedy", "dbscan", "dbscan_std", "linkage"])
    parser.add_argument("--clustering_params", nargs="*", default=[],
                        metavar="KEY=VAL")
    parser.add_argument("--out_dir", type=str, default="")
    args = parser.parse_args(argv)
    return conf_to_cluster(load_list_file(args.conf_list),
                           clustering_method=args.clustering_method,
                           clustering_params=clustering_params(args.clustering_params),
                           out_dir=args.out_dir)


if __name__ == "__main__":
    main()
