"""Host-side graph preparation for the relation GNN (port copy of
``citlab_as_tpu/models/gnn/graph.py``).

The reference does edge correction (undirect + dedup + self-loop removal)
INSIDE the TF graph with per-example map_fn + tf.sets
(gnn/model/graph_util/misc.py:7-151). Here it is
deterministic numpy preprocessing at data-build/load time, so the device
program sees only static padded tensors and masks.

Also hosts relation sampling for training (input_dataset.py:386-441) and
the full N^2 relation grid for inference (input_dataset.py:444-457).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fully_connected_edges(num_nodes: int) -> np.ndarray:
    """All ordered pairs except self-loops (feature_generation.py:494-509)."""
    idx = np.arange(num_nodes, dtype=np.int32)
    grid = np.stack(np.meshgrid(idx, idx, indexing="ij"), axis=2).reshape(-1, 2)
    return grid[grid[:, 0] != grid[:, 1]]


def correct_edges(edges: np.ndarray, edge_features: Optional[np.ndarray],
                  num_nodes: int, undirected: bool = True
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Undirect (append reversed), deduplicate, drop self-loops.

    Matches check_and_correct_interacting_nodes (misc.py:7-151): output edges
    are sorted by their ``i * num_nodes + j`` encoding (the reference's
    tf.sets.difference sorts), and each surviving edge keeps the features of
    its FIRST occurrence in the doubled list.
    """
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    if undirected:
        doubled = np.concatenate([edges, edges[:, ::-1]], axis=0)
        if edge_features is not None:
            edge_features = np.concatenate([edge_features, edge_features], axis=0)
    else:
        doubled = edges

    encoded = doubled[:, 0].astype(np.int64) * num_nodes + doubled[:, 1]
    unique_encoded, first_idx = np.unique(encoded, return_index=True)

    # remove self-loops
    not_loop = (unique_encoded // num_nodes) != (unique_encoded % num_nodes)
    unique_encoded = unique_encoded[not_loop]
    first_idx = first_idx[not_loop]

    out_edges = np.stack(
        [unique_encoded // num_nodes, unique_encoded % num_nodes], axis=1
    ).astype(np.int32)
    out_features = edge_features[first_idx] if edge_features is not None else None
    return out_edges, out_features


def sample_relations(num_nodes: int, gt_relations: Optional[np.ndarray],
                     sample_num: int, num_classes: int, rel_components: int,
                     rng) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Training-time relation sampling (input_dataset.py:386-441): half
    negatives (random non-GT pairs, up to 32x oversampling attempts), half
    positives split across the non-background classes.

    ``gt_relations``: [num_gt, 1 + rel_components] with class in column 0.
    ``rng``: random.Random-like (shuffle + randint inclusive); the same
    calls in the same order as the JAX package, so the same ``rng`` state
    gives the same relations.
    """
    relations = []
    relations_gt = []
    num_sample_false = sample_num // 2
    num_true_per_class = sample_num // (2 * (num_classes - 1))

    pos_rel_set = set()
    if gt_relations is not None and len(gt_relations) > 0:
        gt_relations = np.asarray(gt_relations)
        gt_classes = gt_relations[:, 0]
        gt_rels = [tuple(r) for r in gt_relations[:, 1:]]
        pos_rel_set = set(gt_rels)

        class_containers = [[] for _ in range(num_classes)]
        indices = list(range(len(gt_rels)))
        rng.shuffle(indices)
        for idx in indices:
            container = class_containers[int(gt_classes[idx])]
            if len(container) < num_true_per_class:
                container.append(gt_rels[idx])
        for class_idx in range(1, num_classes):
            container = class_containers[class_idx]
            relations.extend(container)
            relations_gt.extend([class_idx] * len(container))

    neg = 0
    negatives, seen = [], set()
    for _ in range(32 * num_sample_false):
        if neg == num_sample_false:
            break
        rel = tuple(rng.randint(0, num_nodes - 1) for _ in range(rel_components))
        if rel not in seen and rel not in pos_rel_set:
            negatives.append(rel)
            seen.add(rel)
            neg += 1
    relations.extend(negatives)
    relations_gt.extend([0] * neg)

    return (np.asarray(relations, dtype=np.int32).reshape(-1, rel_components),
            np.int32(len(relations)),
            np.asarray(relations_gt, dtype=np.int32))


def build_full_relations(num_nodes: int, gt_relations: Optional[np.ndarray]
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full N^2 relation grid + GT matrix for evaluation/inference
    (input_dataset.py:444-457)."""
    idx = np.arange(num_nodes, dtype=np.int32)
    relations = np.stack(np.meshgrid(idx, idx, indexing="ij"), axis=2).reshape(-1, 2)
    gt_matrix = np.zeros((num_nodes, num_nodes), dtype=np.int32)
    if gt_relations is not None and len(gt_relations) > 0:
        gt_relations = np.asarray(gt_relations)
        gt_matrix[gt_relations[:, 1], gt_relations[:, 2]] = 1
    return relations, np.int32(relations.shape[0]), gt_matrix.reshape(-1)


def pad_graph(num_nodes, node_features, edges, edge_features,
              relations, relations_gt, max_nodes, max_edges, max_relations):
    """Pad one graph's arrays to static bucket sizes; returns a dict of
    arrays + counts ready for batching. Padded edges/relations point at node
    0 and are masked by the counts."""
    dn = node_features.shape[-1] if node_features is not None else 0
    de = edge_features.shape[-1] if edge_features is not None else 0

    def pad2(arr, target, dim):
        out = np.zeros((target, dim), dtype=arr.dtype if arr is not None else np.float32)
        if arr is not None and len(arr):
            out[:len(arr)] = arr
        return out

    out = {
        "num_nodes": np.int32(num_nodes),
        "node_features": pad2(np.asarray(node_features, np.float32), max_nodes, dn),
        "interacting_nodes": pad2(np.asarray(edges, np.int32), max_edges, 2),
        "num_interacting_nodes": np.int32(len(edges)),
        "edge_features": pad2(np.asarray(edge_features, np.float32), max_edges, de),
        "relations_to_consider": pad2(np.asarray(relations, np.int32), max_relations, 2),
        "num_relations_to_consider": np.int32(len(relations)),
    }
    gt = np.zeros((max_relations,), dtype=np.int32)
    if relations_gt is not None and len(relations_gt):
        gt[:len(relations_gt)] = relations_gt
    out["relations_to_consider_gt"] = gt
    return out


def batch_graphs(graphs):
    """Stack a list of same-bucket padded graphs into batch arrays."""
    return {k: np.stack([g[k] for g in graphs], axis=0) for k in graphs[0]}
