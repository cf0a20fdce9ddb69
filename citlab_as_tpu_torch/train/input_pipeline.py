"""GNN input pipeline: graph-feature JSONs -> padded batches (port of
``citlab_as_tpu/train/input_pipeline.py``).

Reference: gnn/input/input_dataset.py:14-457. A plain-Python loader feeds
the train step: circular shuffled file iteration (FileListIterablor:
315-340), JSON parse, feature masking by boolean lists (378-383), relation
sampling for training / full N^2 grid for eval (386-457), geometric
augmentation, edge correction, and bucketed padding so the device sees a
handful of shapes instead of one per page. The same ``random.Random`` and
``np.random.RandomState`` calls in the same order as the JAX package: the
same seed gives the same batches, array for array. Batches are numpy
(int32 indices, as the JAX package's); ``torch_batch`` moves one to the
device with int64 index tensors.
"""
from __future__ import annotations

import json
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from citlab_as_tpu_torch.models.gnn.graph import (
    batch_graphs, build_full_relations, correct_edges, pad_graph,
    sample_relations,
)
from citlab_as_tpu_torch.train.augmentation import augment_geometric_features

#: integer inputs the model indexes with (int64 in the port)
INDEX_KEYS = ("interacting_nodes", "relations_to_consider")


class FileListIterablor:
    """Thread-safe circular iterator over a file list, reshuffled per cycle
    (input_dataset.py:315-340)."""

    def __init__(self, file_list: Sequence[str], shuffle: bool = True,
                 seed: Optional[int] = None):
        self._files = list(file_list)
        self._shuffle = shuffle
        self._rng = random.Random(seed)
        self._index = -1
        self._lock = threading.Lock()
        if shuffle:
            self._rng.shuffle(self._files)

    def __iter__(self):
        return self

    def __next__(self) -> str:
        with self._lock:
            self._index += 1
            if self._index >= len(self._files):
                self._index = 0
                if self._shuffle:
                    self._rng.shuffle(self._files)
            return self._files[self._index]


def apply_feature_masks(features: np.ndarray, mask: Optional[Sequence[bool]]) -> np.ndarray:
    """Keep feature columns where mask is truthy (input_dataset.py:378-383)."""
    if mask is None:
        return features
    idx = [i for i, m in enumerate(mask) if m]
    return features[..., idx]


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


DEFAULT_INPUT_PARAMS: Dict[str, object] = {
    "node_feature_dim": 15,
    "edge_feature_dim": 2,
    "node_input_feature_mask": [],   # empty = use all
    "edge_input_feature_mask": [],
    "num_relation_components": 2,
    "sample_num_relations_to_consider": 300,
    "augmentation_config": [],       # e.g. ['scaling', 'rotation', 'translation']
    "node_buckets": [16, 32, 64, 128, 256],
    "edge_buckets": [64, 128, 256, 512, 1024, 4096],
    # visual branch (input_dataset.py:116-128, 271-285): load the page image
    # next to the JSON, ratio-resize, and pad visual regions to the buckets
    "image_input": False,
    "resize_min_dim": 600,
    "resize_max_dim": 1024,
    "assign_visual_features_to_nodes": True,
    "assign_visual_features_to_edges": False,
    "visual_points_bucket": 16,      # pad region point counts to this
}


def torch_batch(batch_np: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; the index arrays as int64."""
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in INDEX_KEYS:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


class InputGNN:
    """Dataset builder for the relation GNN."""

    def __init__(self, input_params: Optional[dict] = None, num_classes: int = 2,
                 seed: Optional[int] = None):
        self.params = dict(DEFAULT_INPUT_PARAMS)
        if input_params:
            self.params.update(input_params)
        self.num_classes = num_classes
        self._rng = np.random.RandomState(seed)
        self._py_rng = random.Random(seed)

    # ------------------------------------------------------------------
    def load_graph(self, json_path: str) -> Optional[dict]:
        with open(json_path) as f:
            graph = json.load(f)
        if graph.get("num_nodes", 0) is None or graph.get("num_nodes", 0) <= 1:
            return None
        return graph

    def _visual_example(self, graph: dict, json_path: str,
                        max_nodes: int, max_edges: int) -> dict:
        """Image + padded visual regions for one example
        (input_dataset.py:271-285 + misc.py:249-269 contract). Regions are
        scaled into the resized image frame; the image pads to a static
        resize_max_dim square."""
        from citlab_as_tpu_torch.ops.image_utils import resize_image_ratio
        from citlab_as_tpu_torch.utils.io import get_img_from_json_path, load_image

        image = load_image(get_img_from_json_path(json_path), mode="L")
        orig_h, orig_w = image.shape[:2]
        resized, (th, tw) = resize_image_ratio(
            np.asarray(image, np.float32), self.params["resize_min_dim"],
            self.params["resize_max_dim"], pad_to_max_dimension=True)
        resized = np.asarray(resized, np.float32)
        if resized.max() > 1.5:
            resized = resized / 255.0
        out = {"image": resized[:, :, None],
               "image_shape": np.asarray([th, tw], np.int32)}
        sx, sy = tw / orig_w, th / orig_h
        p_max = int(self.params["visual_points_bucket"])

        def pack(regions, num_points, max_items):
            packed = np.zeros((max_items, 2, p_max), np.float32)
            counts = np.zeros((max_items,), np.int32)
            for i, region in enumerate(regions):
                arr = np.asarray(region, np.float32)[:, :p_max]
                packed[i, 0, :arr.shape[1]] = arr[0] * sx
                packed[i, 1, :arr.shape[1]] = arr[1] * sy
                counts[i] = min(int(num_points[i]), p_max)
            return packed, counts

        if (self.params["assign_visual_features_to_nodes"]
                and "visual_regions_nodes" in graph):
            packed, counts = pack(graph["visual_regions_nodes"],
                                  graph["num_points_visual_regions_nodes"],
                                  max_nodes)
            out["visual_regions_nodes"] = packed
            out["num_points_visual_regions_nodes"] = counts
        if (self.params["assign_visual_features_to_edges"]
                and "visual_regions_edges" in graph):
            packed, counts = pack(graph["visual_regions_edges"],
                                  graph["num_points_visual_regions_edges"],
                                  max_edges)
            out["visual_regions_edges"] = packed
            out["num_points_visual_regions_edges"] = counts
        return out

    def prepare_example(self, graph: dict, training: bool,
                        json_path: Optional[str] = None) -> Optional[dict]:
        """One graph JSON -> padded example dict."""
        n = int(graph["num_nodes"])
        node_features = np.asarray(graph["node_features"], np.float32)
        edge_features = np.asarray(graph["edge_features"], np.float32)
        edges = np.asarray(graph["interacting_nodes"], np.int32)

        node_features = apply_feature_masks(
            node_features, self.params["node_input_feature_mask"] or None)
        edge_features = apply_feature_masks(
            edge_features, self.params["edge_input_feature_mask"] or None)

        if training and self.params["augmentation_config"]:
            node_features = augment_geometric_features(
                node_features.copy(), self.params["augmentation_config"], self._rng)

        edges, edge_features = correct_edges(edges, edge_features, n)

        gt_relations = np.asarray(graph.get("gt_relations", []), np.int32)
        if training:
            rels, num_rels, rel_gt = sample_relations(
                n, gt_relations if len(gt_relations) else None,
                self.params["sample_num_relations_to_consider"],
                self.num_classes, self.params["num_relation_components"],
                self._py_rng)
            if num_rels == 0:
                return None
            max_rels = self.params["sample_num_relations_to_consider"]
        else:
            rels, num_rels, rel_gt = build_full_relations(
                n, gt_relations if len(gt_relations) else None)
            max_rels = _bucket(int(num_rels), [b * b for b in self.params["node_buckets"]])

        max_nodes = _bucket(n, self.params["node_buckets"])
        max_edges = _bucket(len(edges), self.params["edge_buckets"])
        example = pad_graph(n, node_features, edges, edge_features,
                            rels, rel_gt, max_nodes, max_edges, max_rels)
        if self.params["image_input"] and json_path is not None:
            example.update(self._visual_example(
                graph, json_path, max_nodes, max_edges))
        return example

    # ------------------------------------------------------------------
    def train_batches(self, file_list: Sequence[str], batch_size: int,
                      steps: int) -> Iterator[dict]:
        """Yield ``steps`` padded training batches; same-bucket examples are
        grouped per batch (max bucket in the batch wins)."""
        iterator = FileListIterablor(file_list, shuffle=True,
                                     seed=self._py_rng.randint(0, 2 ** 31))
        for _ in range(steps):
            examples = []
            while len(examples) < batch_size:
                path = next(iterator)
                graph = self.load_graph(path)
                if graph is None:
                    continue
                ex = self.prepare_example(graph, training=True, json_path=path)
                if ex is not None:
                    examples.append(ex)
            yield self._stack_to_common_shape(examples)

    def eval_batches(self, file_list: Sequence[str]) -> Iterator[dict]:
        """Per-page eval batches (batch size 1, full relation grid)."""
        for path in file_list:
            graph = self.load_graph(path)
            if graph is None:
                continue
            ex = self.prepare_example(graph, training=False, json_path=path)
            if ex is not None:
                yield batch_graphs([ex]), path, graph

    @staticmethod
    def _stack_to_common_shape(examples: List[dict]) -> dict:
        """Re-pad examples to the batch maximum per array before stacking."""
        out = {}
        for key in examples[0]:
            arrs = [e[key] for e in examples]
            if arrs[0].ndim == 0:
                out[key] = np.stack(arrs)
                continue
            target = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
            padded = []
            for a in arrs:
                pad = [(0, t - s) for s, t in zip(a.shape, target)]
                padded.append(np.pad(a, pad))
            out[key] = np.stack(padded)
        return out
