"""Blind end-to-end AS F1 of a visual relation-GNN checkpoint (port of
``scripts/eval_visual_gnn.py``).

For each seed: draw a fresh multi-article page
(``train_pipeline_gnn.make_article_page``), strip its GT article ids, run
the whole workflow (``cli/run_full_workflow.py::run_full_workflow``) with
the visual ``RelationPredictor`` (page images at 288 / 384 through the
``ARU_cutted_v1`` backbone), and score the clustering against the GT with
the AS measure (``cli/run_measure.py``, tolerances 10 / 30). Prints R / P /
F per seed, then the mean and the minimum F.

Usage:
    python -m citlab_as_tpu_torch.scripts.eval_visual_gnn [ckpt_dir]
        [--seeds 31,7,101,202,303] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def evaluate_seed(seed: int, gnn, separator_model_dir: str, heading_model_dir: str,
                  clustering_params=None, device="cuda"):
    """(AS R, P, F, number of articles) of one seed's page."""
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.cli.run_measure import main as measure_main
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.scripts.train_pipeline_gnn import make_article_page

    work = tempfile.mkdtemp(prefix=f"evalv_{seed}_")
    try:
        img, page_path, n_articles = make_article_page(work, "v", np.random.RandomState(seed))
        gt_dir = os.path.join(work, "gt", "page")
        os.makedirs(gt_dir)
        gt_path = os.path.join(gt_dir, "v.xml")
        shutil.copy(page_path, gt_path)
        page = Page(page_path)
        tls = page.get_textlines()
        for tl in tls:
            tl.set_article_id(None)
        page.set_textline_attr(tls)
        page.write_page_xml(page_path)
        result = run_full_workflow(
            [img], separator_model_path=separator_model_dir,
            heading_model_path=heading_model_dir, gnn_predictor=gnn,
            clustering_method="dbscan", out_dir=os.path.join(work, "out"),
            clustering_params=clustering_params, device=device)
        gt_lst = os.path.join(work, "gt.lst")
        hy_lst = os.path.join(work, "hy.lst")
        with open(gt_lst, "w") as f:
            f.write(gt_path + "\n")
        with open(hy_lst, "w") as f:
            f.write(result["clustered"][0] + "\n")
        out = measure_main(["--path_to_gt_xml_lst", gt_lst,
                            "--path_to_hy_xml_lst", hy_lst,
                            "--min_tol", "10", "--max_tol", "30"])
        return (*out["as"], n_articles)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", default=os.path.join(
        REPO, "models_ckpt", "gnn_visual", "best", "f1"))
    ap.add_argument("--seeds", default="31,7,101,202,303")
    ap.add_argument("--separator_model_dir", default=os.path.join(
        REPO, "models_ckpt", "separator"))
    ap.add_argument("--heading_model_dir", default=os.path.join(
        REPO, "models_ckpt", "heading"))
    ap.add_argument("--conf", type=float, default=None,
                    help="confidence_threshold override for the clustering")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    clustering_params = (
        {"confidence_threshold": args.conf} if args.conf is not None else None)

    from citlab_as_tpu_torch.inference import RelationPredictor
    gnn = RelationPredictor(args.ckpt, image_input=True,
                            visual_backbone="ARU_cutted_v1",
                            image_min_dimension=288, image_max_dimension=384,
                            device=args.device)
    fs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        as_r, as_p, as_f, n_articles = evaluate_seed(
            seed, gnn, args.separator_model_dir, args.heading_model_dir,
            clustering_params, args.device)
        fs.append(as_f)
        print(f"seed {seed}: n_articles={n_articles} AS R={as_r:.4f} "
              f"P={as_p:.4f} F={as_f:.4f}", flush=True)
    print(f"CKPT={args.ckpt}")
    print(f"mean F={np.mean(fs):.4f} min F={np.min(fs):.4f}")
    return float(np.mean(fs))


if __name__ == "__main__":
    main()
