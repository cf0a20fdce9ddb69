"""Train the relation GNN on synthetic newspaper layouts (port of
``scripts/train_synthetic_gnn.py``).

Writes graph-feature JSONs for synthetic multi-column pages (articles =
vertical runs of regions within a column; edge separator flags derived from
the layout) through the file contract the feature generator writes, then
trains them with ``train/trainer.py::TrainerGNN``. The pages' random draws
are the JAX script's (numpy, same order), so a seed writes the same JSON
files. The checkpoint goes to --model_dir.

Usage: python -m citlab_as_tpu_torch.scripts.train_synthetic_gnn
           --model_dir models_ckpt/gnn [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def synth_page_graph(rng: np.random.RandomState) -> Optional[dict]:
    """One synthetic page: 2-3 columns, regions stacked per column,
    consecutive runs grouped into articles; None for a page of fewer than
    two regions."""
    from citlab_as_tpu_torch.models.gnn.graph import fully_connected_edges
    from citlab_as_tpu_torch.stages.features import delaunay_edges

    n_cols = rng.randint(2, 4)
    page_w, page_h = 1000.0, 1400.0
    col_w = page_w / n_cols

    regions = []   # (cx, cy, w, h, article, heading)
    article = 0
    for c in range(n_cols):
        y = 60.0
        first_in_col = True
        while y < page_h - 150:
            h = rng.uniform(80, 260)
            if y + h > page_h - 40:
                break
            if not first_in_col and rng.rand() < 0.45:
                article += 1  # horizontal break starts a new article
            heading = first_in_col or rng.rand() < 0.15
            cx = c * col_w + col_w / 2 + rng.uniform(-8, 8)
            regions.append((cx, y + h / 2, col_w * 0.85, h, article, heading))
            y += h + rng.uniform(10, 40)
            first_in_col = False
        article += 1  # columns never continue articles in this generator

    n = len(regions)
    if n < 2:
        return None

    node_features = []
    for cx, cy, w, h, art, heading in regions:
        sx, sy = w / page_w, h / page_h
        ncx, ncy = cx / page_w, cy / page_h
        top_y = (cy - h / 2 + 14) / page_h
        bot_y = (cy + h / 2 - 6) / page_h
        bl_sx = sx * rng.uniform(0.8, 1.0)
        sw = rng.uniform(0.8, 1.0) if heading else rng.uniform(0.3, 0.6)
        th = rng.uniform(0.7, 1.0) if heading else rng.uniform(0.3, 0.6)
        node_features.append([
            sx, sy, ncx, ncy,
            bl_sx, 0.002, ncx, top_y,
            bl_sx, 0.002, ncx, bot_y,
            sw, th, float(heading)])

    centers = np.array([[f[2] * page_w, f[3] * page_h] for f in node_features])
    edges = fully_connected_edges(n) if n < 4 else delaunay_edges(n, centers)

    edge_features = []
    for a, b in edges:
        ca, cb = regions[a], regions[b]
        same_col = abs(ca[0] - cb[0]) < col_w / 2
        horizontally = float(same_col and ca[4] != cb[4] and rng.rand() < 0.9)
        vertically = float(not same_col)
        edge_features.append([horizontally, vertically])

    gt = [[1, i, j] for i in range(n) for j in range(n)
          if regions[i][4] == regions[j][4]]
    return {
        "num_nodes": n,
        "interacting_nodes": edges.tolist(),
        "num_interacting_nodes": len(edges),
        "node_features": node_features,
        "edge_features": edge_features,
        "gt_relations": gt,
        "gt_num_relations": len(gt),
    }


def write_graphs(data_dir: str, num_pages: int, seed: int):
    """``num_pages`` synthetic graphs as ``g<i>.json`` under ``data_dir``;
    returns their paths."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(num_pages):
        graph = None
        while graph is None:
            graph = synth_page_graph(rng)
        path = os.path.join(data_dir, f"g{i:04d}.json")
        with open(path, "w") as f:
            json.dump(graph, f)
        paths.append(path)
    return paths


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--num_pages", type=int, default=300)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--samples_per_epoch", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    paths = write_graphs(args.data_dir or os.path.join(args.model_dir, "synthetic_data"),
                         args.num_pages, args.seed)
    split = int(0.9 * len(paths))

    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    trainer = TrainerGNN(
        args.model_dir, paths[:split], paths[split:],
        flags={"epochs": args.epochs,
               "samples_per_epoch": args.samples_per_epoch,
               "batch_size": args.batch_size,
               "eval_every_n": 2,
               "best_export_metrics": ["f1"],
               "weight_decay": 1e-6},
        input_params={"sample_num_relations_to_consider": 300,
                      "augmentation_config": ["scaling", "translation"]},
        # a cosine cooldown sized to the short run (the default final_epochs
        # of 50 assumes 200 epochs and would pin the rate at lr / 10)
        optimizer_params={"learning_rate": 1e-3,
                          "final_epochs": max(2, args.epochs // 4)},
        seed=args.seed, device=args.device)
    result = trainer.train()
    print("best metrics:", result["best_metrics"])
    return result


if __name__ == "__main__":
    main()
