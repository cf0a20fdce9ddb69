"""Inference wrappers (port of ``citlab_as_tpu/inference.py``):
``SegmentationPredictor`` (``__init__``, ``__call__``, ``predict_batch``,
``predict_batch_device``) and ``RelationPredictor`` (the relation GNN over
page groups).

Pages are zero-padded to a multiple of ``pad_multiple`` and cropped back.
The batch is the caller's: there is no device batch cap (the JAX package's
``MAX_DEVICE_BATCH`` was a TPU measurement and does not carry over).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, resolve_device
from citlab_as_tpu_torch.models.arunet import ARUNet
from citlab_as_tpu_torch.models.gnn.graph import (
    batch_graphs, build_full_relations, correct_edges, pad_graph,
)
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.ops.image_utils import resize_image_ratio
from citlab_as_tpu_torch.train.input_pipeline import apply_feature_masks, torch_batch
from citlab_as_tpu_torch.utils.async_copy import prefetch
from citlab_as_tpu_torch.weights import (
    arunet_state_dict_from_flax, gnn_state_dict_from_flax, load_npz,
)

logger = logging.getLogger(__name__)


class SegmentationPredictor:
    """ARU-Net forward: grayscale [H, W] in [0, 1] -> probabilities [H, W, C].

    ``model_path``: a converted ``.npz`` (``scripts/convert_weights_to_torch.py``)
    or a ``.frozen`` artifact (``train/export.py``, written by either
    package), which brings its own architecture kwargs and compute dtype
    (float32 unless its kwargs say otherwise), as in the JAX predictor; None
    -> random init from ``seed`` (logged loudly). ``dtype`` is the compute
    dtype otherwise (bf16 by default, as the JAX predictor); parameters are
    held in it. Runs on ``device`` ("cuda" unless told "cpu")."""

    def __init__(self, model_path: Optional[str] = None, n_classes: int = 2,
                 graph_params: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16, pad_multiple: int = 64,
                 seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.pad_multiple = pad_multiple
        if model_path is not None and model_path.endswith(".frozen"):
            from citlab_as_tpu_torch.train.export import load_frozen
            self.model, _, _ = load_frozen(model_path)
            if not isinstance(self.model, ARUNet):
                raise ValueError(f"{model_path} does not hold an ARU-Net")
            dtype = self.model.compute_dtype or torch.float32
            self.model.compute_dtype = None
            logger.info("Loaded frozen ARU-Net from %s", model_path)
        else:
            self.model = ARUNet(n_classes=n_classes, graph_params=graph_params)
            if model_path is not None:
                self.model.load_state_dict(
                    arunet_state_dict_from_flax(load_npz(model_path)))
                logger.info("Loaded ARU-Net params from %s", model_path)
            else:
                self.model.init_random(seed)
                logger.warning("SegmentationPredictor using RANDOM params "
                               "(no model_path given).")
        self.model = self.model.to(device=self.device, dtype=dtype).eval()

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.model(x), dim=-1)

    def _pack(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        ph = -(-max(im.shape[0] for im in images) // self.pad_multiple) * self.pad_multiple
        pw = -(-max(im.shape[1] for im in images) // self.pad_multiple) * self.pad_multiple
        x = np.zeros((len(images), ph, pw, 1), np.float32)
        for i, im in enumerate(images):
            x[i, :im.shape[0], :im.shape[1], 0] = im
        return torch.from_numpy(x).to(self.device)

    def __call__(self, image_grey: np.ndarray) -> np.ndarray:
        return self.predict_batch([image_grey])[0]

    def predict_batch(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Batch same-bucket images; returns per-image HWC probabilities."""
        return self.predict_batch_device(images)()

    def predict_batch_device(self, images: Sequence[np.ndarray]
                             ) -> Callable[[], List[np.ndarray]]:
        """Enqueue the forward (CUDA work is asynchronous) and return a
        zero-arg callable that copies the per-image results to the host."""
        if not images:
            return lambda: []
        probs = self._forward(self._pack(images))
        shapes = [im.shape[:2] for im in images]

        def materialize():
            host = probs.cpu().numpy()
            return [host[i, :h, :w, :] for i, (h, w) in enumerate(shapes)]
        return materialize


class RelationPredictor:
    """GraphRelation forward over page graph JSON dicts -> [N, N] confidence
    matrices (the run_gnn_clustering device step), one forward per page
    group on the union graph.

    ``model_path``: a converted ``.npz`` (``scripts/convert_weights_to_torch.py
    --kind gnn``) or a ``.frozen`` artifact, whose kwargs then build the net
    in place of this predictor's (as the JAX predictor does); None -> random
    init from ``seed`` (logged loudly). The net is built at the first group,
    whose feature widths it takes, as the JAX predictor initializes at its
    first call. Runs in float32 on ``device`` ("cuda" unless told "cpu").

    ``image_input`` (the visual 'v' nets): the page images go with the
    graphs (``confidences(graph, image)``, ``confidences_batch(graphs,
    images)``); each is ratio-resized on the host to
    ``image_min_dimension`` / ``image_max_dimension`` and zero-padded to a
    square, and its regions' polygons (``visual_regions_nodes`` in the
    feature JSON, written with ``visual_regions=True``) are scaled into it.
    The committed ``gnn_visual`` checkpoint was trained and evaluated at
    288 / 384 with ``visual_backbone="ARU_cutted_v1"``; ``inception_v3``
    (the JAX package's default) runs at the defaults, 600 / 1024."""

    def __init__(self, model_path: Optional[str] = None, num_classes: int = 2,
                 gnn_params=None, message_params=None, update_params=None,
                 node_feature_mask: Optional[Sequence[int]] = None,
                 edge_feature_mask: Optional[Sequence[int]] = None,
                 node_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 image_input: bool = False, visual_backbone: str = "ARU_v1",
                 assign_visual_features_to_nodes: bool = True,
                 assign_visual_features_to_edges: bool = False,
                 image_min_dimension: int = 600, image_max_dimension: int = 1024,
                 seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model_path = model_path
        self.num_classes = num_classes
        self.gnn_params = gnn_params
        self.message_params = message_params
        self.update_params = update_params
        self.node_feature_mask = node_feature_mask
        self.edge_feature_mask = edge_feature_mask
        self.node_buckets = list(node_buckets)
        self.image_input = image_input
        self.visual_backbone = visual_backbone
        self.assign_nodes = assign_visual_features_to_nodes
        self.assign_edges = assign_visual_features_to_edges
        self.image_min_dimension = image_min_dimension
        self.image_max_dimension = image_max_dimension
        self.seed = seed
        self.model: Optional[GraphRelation] = None
        # grow-only shapes of the batched inputs (see _batch_inputs)
        self._group_bucket = self._node_bucket = self._edges_bucket = 1
        self._points_bucket = 1

    def _ensure_params(self, inputs: Dict[str, torch.Tensor]) -> None:
        if self.model is not None:
            return
        if self.model_path is not None and self.model_path.endswith(".frozen"):
            from citlab_as_tpu_torch.train.export import load_frozen
            model, _, _ = load_frozen(self.model_path, *self._input_widths(inputs))
            if not isinstance(model, GraphRelation):
                raise ValueError(f"{self.model_path} does not hold a relation GNN")
            logger.info("Loaded frozen GNN from %s", self.model_path)
            self.model = model.to(self.device).eval()
            return
        node_dim, edge_dim = self._input_widths(inputs)
        model = GraphRelation(
            node_feature_dim=node_dim, edge_feature_dim=edge_dim,
            num_classes=self.num_classes, gnn_params=self.gnn_params,
            message_params=self.message_params, update_params=self.update_params,
            image_input=self.image_input, visual_backbone=self.visual_backbone,
            assign_visual_features_to_nodes=self.assign_nodes,
            assign_visual_features_to_edges=self.assign_edges)
        if self.model_path is not None:
            model.load_state_dict(gnn_state_dict_from_flax(load_npz(self.model_path)))
            logger.info("Loaded GNN params from %s", self.model_path)
        else:
            gen = torch.Generator().manual_seed(self.seed)
            for name, param in model.named_parameters():
                with torch.no_grad():
                    if name.endswith("weight"):
                        bound = (6.0 / sum(param.shape)) ** 0.5
                        param.uniform_(-bound, bound, generator=gen)
                    else:
                        param.zero_()
            logger.warning("RelationPredictor using RANDOM params.")
        self.model = model.to(self.device).eval()

    @staticmethod
    def _input_widths(inputs: Dict[str, torch.Tensor]):
        return inputs["node_features"].shape[-1], inputs["edge_features"].shape[-1]

    def _bucket(self, n: int) -> int:
        for b in self.node_buckets:
            if n <= b:
                return b
        # page exceeds the configured buckets: grow to the next power of two
        # and remember it, so later oversized pages reuse the same shapes
        b = self.node_buckets[-1]
        while b < n:
            b *= 2
        self.node_buckets.append(b)
        logger.info("RelationPredictor: growing node bucket to %d for a "
                    "%d-node page", b, n)
        return b

    @staticmethod
    def _edge_bucket(e: int) -> int:
        """Round the edge count up to a power of two (floor 16), so that
        groups share a few shapes instead of one per page."""
        b = 16
        while b < e:
            b *= 2
        return b

    def _correct_graph(self, graph: dict):
        """Masked + edge-corrected arrays for one page graph."""
        n = int(graph["num_nodes"])
        node_features = apply_feature_masks(
            np.asarray(graph["node_features"], np.float32), self.node_feature_mask)
        edge_features = apply_feature_masks(
            np.asarray(graph["edge_features"], np.float32), self.edge_feature_mask)
        edges, edge_features = correct_edges(
            np.asarray(graph["interacting_nodes"], np.int32), edge_features, n)
        return n, node_features, edges, edge_features

    def _visual_inputs(self, graph: dict, image: np.ndarray, max_nodes: int,
                       max_edges: int, max_points: int) -> Dict[str, np.ndarray]:
        """Page image + visual regions -> the model's visual inputs: the
        ratio-resized, zero-padded image [1, D, D, 1] in [0, 1], its true
        shape, and the regions [1, N, 2, P] scaled into the resized frame
        with their valid point counts, padded to the node / edge buckets and
        the shared point bucket."""
        orig_h, orig_w = image.shape[:2]
        resized, (th, tw) = resize_image_ratio(
            image, self.image_min_dimension, self.image_max_dimension,
            pad_to_max_dimension=True)
        if resized.max() > 1.5:
            resized = resized / 255.0
        out = {"image": resized[None, :, :, None],
               "image_shape": np.asarray([[th, tw]], np.int32)}
        sx, sy = tw / orig_w, th / orig_h

        def pack(regions, num_points, max_items):
            packed = np.zeros((1, max_items, 2, max_points), np.float32)
            counts = np.zeros((1, max_items), np.int32)
            for i, r in enumerate(regions):
                a = np.asarray(r, np.float32)          # [2, P_i]
                packed[0, i, 0, :a.shape[1]] = a[0] * sx
                packed[0, i, 1, :a.shape[1]] = a[1] * sy
                counts[0, i] = num_points[i]
            return packed, counts

        for kind, on, max_items in (("nodes", self.assign_nodes, max_nodes),
                                    ("edges", self.assign_edges, max_edges)):
            if on and f"visual_regions_{kind}" in graph:
                packed, counts = pack(graph[f"visual_regions_{kind}"],
                                      graph[f"num_points_visual_regions_{kind}"],
                                      max_items)
                out[f"visual_regions_{kind}"] = packed
                out[f"num_points_visual_regions_{kind}"] = counts
        return out

    def confidences(self, graph: dict,
                    image: Optional[np.ndarray] = None) -> np.ndarray:
        return self.confidences_batch(
            [graph], [image] if image is not None else None)[0]

    __call__ = confidences

    def _batch_inputs(self, graphs: Sequence[dict],
                      images: Optional[Sequence[np.ndarray]] = None):
        """Shared-bucket union-graph inputs for a page group, on the device.

        Buckets (nodes, edges, group size, and for visual nets the region
        points) are GROW-ONLY across calls: a group smaller than a previous
        one pads up to the seen maximum, so a corpus runs a few shapes after
        its first groups."""
        ns_real = len(graphs)
        group = max(self._group_bucket, ns_real)
        self._group_bucket = group
        graphs = list(graphs) + [graphs[-1]] * (group - ns_real)
        if images is not None:
            images = list(images) + [images[-1]] * (group - len(images))
        corrected = [self._correct_graph(g) for g in graphs]
        ns = [c[0] for c in corrected]
        max_nodes = max(self._node_bucket, self._bucket(max(ns)))
        self._node_bucket = max_nodes
        max_edges = max(self._edges_bucket, self._edge_bucket(
            max(max(len(c[2]) for c in corrected), 1)))
        self._edges_bucket = max_edges
        ns = ns[:ns_real]   # padding pages are sliced away at materialize
        padded = []
        for n, node_features, edges, edge_features in corrected:
            rels, _, _ = build_full_relations(n, None)
            padded.append(pad_graph(
                n, node_features, edges, edge_features, rels, None,
                max_nodes, max_edges, max_nodes * max_nodes))
        batch = batch_graphs(padded)
        if self.image_input and images is not None:
            max_points = max(self._points_bucket, self._edge_bucket(max(
                max((np.asarray(r).shape[1] for r in g.get("visual_regions_nodes", [])),
                    default=1) for g in graphs)))
            self._points_bucket = max_points
            vis = [self._visual_inputs(g, im, max_nodes, max_edges, max_points)
                   for g, im in zip(graphs, images)]
            batch.update({k: np.concatenate([v[k] for v in vis], axis=0) for k in vis[0]})
        return torch_batch(batch, self.device), ns

    def confidences_batch(self, graphs: Sequence[dict],
                          images: Optional[Sequence[np.ndarray]] = None
                          ) -> List[np.ndarray]:
        """ONE forward over a whole page group (the union-graph batching of
        graph_gnn.py:81-119); pages pad to the group's shared node/edge
        buckets. ``images``: the pages' grayscale images, for a visual net.
        Returns a list of [n_i, n_i] confidence arrays."""
        return self.confidences_batch_device(graphs, images)()

    @torch.no_grad()
    def forward_confidences(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """softmax(logits)[..., 1] on the device, [B, R]."""
        return torch.softmax(self.model(inputs), dim=-1)[..., 1]

    def confidences_batch_device(self, graphs: Sequence[dict],
                                 images: Optional[Sequence[np.ndarray]] = None
                                 ) -> Callable[[], List[np.ndarray]]:
        """Queue the group's forward and the readback of its confidences
        behind it (``utils/async_copy.py::prefetch``), and return a
        zero-arg callable that waits for that copy and yields the per-page
        [n_i, n_i] arrays."""
        inputs, ns = self._batch_inputs(graphs, images)
        self._ensure_params(inputs)
        conf = prefetch(self.forward_confidences(inputs))

        def materialize():
            host = conf.numpy()
            return [host[i, :n * n].reshape(n, n) for i, n in enumerate(ns)]
        return materialize
