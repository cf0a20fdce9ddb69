"""Inference wrappers (port of ``citlab_as_tpu/inference.py``):
``SegmentationPredictor`` (``__init__``, ``__call__``, ``predict_batch``,
``predict_batch_device``), its data-parallel ``ShardedSegmentationPredictor``
and ``RelationPredictor`` (the relation GNN over page groups, optionally
over a mesh).

Pages are zero-padded to a multiple of ``pad_multiple`` and cropped back.
The unsharded batch is the caller's: there is no device batch cap (the JAX
package's ``MAX_DEVICE_BATCH`` was a TPU measurement and does not carry
over); the sharded predictor keeps the JAX package's per-shard chunking.
"""
from __future__ import annotations

import copy
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from citlab_as_tpu_torch.device import DeviceLike, device_scope, resolve_device, row_streams
from citlab_as_tpu_torch.models.arunet import ARUNet
from citlab_as_tpu_torch.models.gnn.graph import (
    batch_graphs, build_full_relations, correct_edges, pad_graph,
)
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.ops.image_utils import resize_image_ratio
from citlab_as_tpu_torch.train.input_pipeline import apply_feature_masks, torch_batch
from citlab_as_tpu_torch.utils.async_copy import prefetch
from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, gnn_state_dict_from_flax

logger = logging.getLogger(__name__)


def _variables(model_path: str, bare_state_ok: bool) -> Dict[str, np.ndarray]:
    """float32 flat flax variables of a converted ``.npz`` or a model
    directory (``train.checkpoint.checkpoint_variables``: the JAX package's
    orbax checkpoints or the port's)."""
    from citlab_as_tpu_torch.train.checkpoint import checkpoint_variables
    flat, _ = checkpoint_variables(model_path, bare_state_ok)
    # float32, as the JAX predictors restore into a float32 template (a bf16
    # leaf widens exactly)
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
            for k, v in flat.items()}


def jax_keyword(value, jax_value, name: str, jax_name: str):
    """``value`` of the port's keyword ``name``, or ``jax_value`` of the JAX
    package's ``jax_name`` for the same argument (``model_dir=``,
    ``separator_model_dir=``, ...); both given raises ``TypeError``."""
    if jax_value is None:
        return value
    if value is not None:
        raise TypeError(f"{name} and {jax_name} name the same model: give one of them")
    return jax_value


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class SegmentationPredictor:
    """ARU-Net forward: grayscale [H, W] in [0, 1] -> probabilities [H, W, C].

    ``model_path``: a model directory, whose newest numbered step is read
    (the JAX package's orbax checkpoints, ``models_ckpt/separator``, or the
    port's own; its ``params`` subtree, as the JAX predictor restores it;
    a step's own directory raises ``FileNotFoundError``, as there), a best
    export's directory (``best/<metric>``, the variables, which the JAX
    predictor does not take), a converted ``.npz``
    (``scripts/convert_weights_to_torch.py``) or a ``.frozen`` artifact
    (``train/export.py``, written by either package), which brings its own
    architecture kwargs and compute dtype (float32 unless its kwargs say
    otherwise), as in the JAX predictor; None -> random init from ``seed``
    (logged loudly). ``dtype`` is the compute
    dtype otherwise (bf16 by default, as the JAX predictor); parameters are
    held in it. Runs on ``device`` ("cuda" unless told "cpu"). ``model_dir``:
    the JAX predictor's keyword for ``model_path`` (give one of them)."""

    def __init__(self, model_path: Optional[str] = None, n_classes: int = 2,
                 graph_params: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16, pad_multiple: int = 64,
                 seed: int = 0, device: DeviceLike = "cuda", *,
                 model_dir: Optional[str] = None):
        model_path = jax_keyword(model_path, model_dir, "model_path", "model_dir")
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
                    arunet_state_dict_from_flax(_variables(model_path, bare_state_ok=False)))
                logger.info("Loaded ARU-Net params from %s", model_path)
            else:
                self.model.init_random(seed)
                logger.warning("SegmentationPredictor using RANDOM params "
                               "(no model_path given).")
        self.model = self.model.to(device=self.device, dtype=dtype).eval()

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.model(x), dim=-1)

    def _pack_host(self, images: Sequence[np.ndarray], batch: Optional[int] = None
                   ) -> np.ndarray:
        """The pages zero-padded to the batch's common shape (a multiple of
        ``pad_multiple``), [batch, H, W, 1] float32; ``batch`` (default the
        number of pages) adds all-zero pages."""
        ph = _round_up(max(im.shape[0] for im in images), self.pad_multiple)
        pw = _round_up(max(im.shape[1] for im in images), self.pad_multiple)
        x = np.zeros((batch or len(images), ph, pw, 1), np.float32)
        for i, im in enumerate(images):
            x[i, :im.shape[0], :im.shape[1], 0] = im
        return x

    def _pack(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        return torch.from_numpy(self._pack_host(images)).to(self.device)

    @classmethod
    def view(cls, model: torch.nn.Module, device: torch.device,
             pad_multiple: int = 64) -> "SegmentationPredictor":
        """A predictor over an existing ``model`` on ``device`` (one shard
        of a :class:`ShardedSegmentationPredictor`), without loading."""
        pred = cls.__new__(cls)
        pred.model, pred.device, pred.pad_multiple = model, device, pad_multiple
        return pred

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


class ShardedSegmentationPredictor(SegmentationPredictor):
    """Data-parallel ARU-Net inference over a mesh (port of the JAX
    package's ``ShardedSegmentationPredictor``).

    One replica of the net per data shard of ``mesh`` (default
    ``parallel.mesh.make_mesh()``: every CUDA device), each on its shard's
    device (the mesh's devices replace ``device``). A batch is padded to its
    common padded shape and, with all-zero pages, to a multiple of
    ``n_data``, then split into equal consecutive shards; each shard's
    forward is issued on its own device and CUDA stream, so shards on
    different GPUs overlap, and the probabilities are gathered in page
    order. Batches above ``MAX_SHARD_BATCH * n_data`` pages are chunked, as
    the JAX predictor chunks at ``MAX_DEVICE_BATCH * n_data`` (7 per shard,
    the reference's cap, not an H100 measurement). Other arguments as
    :class:`SegmentationPredictor`.

    Over a mesh with ``model > 1`` each data shard's sub-batch runs the
    height-sharded forward (``parallel/spatial.py::SpatialARU``) over its
    row's devices, one replica on each distinct device of the row and a
    stream on each; its logits are gathered on the row's first device,
    which holds the data shard and its probabilities."""

    MAX_SHARD_BATCH = 7

    def __init__(self, model_path: Optional[str] = None, mesh=None, **kwargs):
        from citlab_as_tpu_torch.parallel.mesh import make_mesh, one_process
        mesh = one_process(mesh if mesh is not None else make_mesh(),
                           "ShardedSegmentationPredictor")
        kwargs["device"] = mesh.data_devices[0]
        super().__init__(model_path, **kwargs)
        self._shard_over(mesh)

    @classmethod
    def from_predictor(cls, predictor: SegmentationPredictor, mesh
                       ) -> "ShardedSegmentationPredictor":
        """Shard an already loaded predictor's net over ``mesh``."""
        from citlab_as_tpu_torch.parallel.mesh import one_process
        one_process(mesh, "ShardedSegmentationPredictor")
        sharded = cls.__new__(cls)
        sharded.model, sharded.pad_multiple = predictor.model, predictor.pad_multiple
        sharded.device = mesh.data_devices[0]
        sharded._shard_over(mesh)
        return sharded

    def _shard_over(self, mesh) -> None:
        from citlab_as_tpu_torch.parallel.mesh import replicate
        from citlab_as_tpu_torch.parallel.spatial import SpatialARU
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.devices = mesh.data_devices
        if mesh.shape["model"] > 1:
            self.replicas = [SpatialARU(nets, mesh.model_devices(i)).eval() for i, nets
                             in enumerate(replicate(mesh, self.model, over_model=True))]
            self.model = self.replicas[0].net
        else:
            self.replicas = [r.eval() for r in replicate(mesh, self.model)]
            self.model = self.replicas[0]
        self.MAX_DEVICE_BATCH = self.MAX_SHARD_BATCH * self.n_data
        self._streams = [row_streams(mesh.model_devices(i)) for i in range(self.n_data)]

    def shards(self) -> List[SegmentationPredictor]:
        """One plain predictor per data shard, over that shard's replica
        (a ``SpatialARU`` over a mesh with ``model > 1``)."""
        return [SegmentationPredictor.view(r, d, self.pad_multiple)
                for r, d in zip(self.replicas, self.devices)]

    def predict_batch_device(self, images: Sequence[np.ndarray]
                             ) -> Callable[[], List[np.ndarray]]:
        if not images:
            return lambda: []
        if len(images) > self.MAX_DEVICE_BATCH:
            parts = [self.predict_batch_device(images[start:start + self.MAX_DEVICE_BATCH])
                     for start in range(0, len(images), self.MAX_DEVICE_BATCH)]
            return lambda: [out for part in parts for out in part()]
        x = self._pack_host(images, _round_up(len(images), self.n_data))
        per = x.shape[0] // self.n_data
        copies = []
        for i, (replica, dev, stream) in enumerate(
                zip(self.replicas, self.devices, self._streams)):
            with device_scope(dev, stream), torch.no_grad():
                shard = torch.from_numpy(x[i * per:(i + 1) * per]).to(dev)
                copies.append(prefetch(torch.softmax(replica(shard), dim=-1)))
        shapes = [im.shape[:2] for im in images]

        def materialize():
            host = np.concatenate([c.numpy() for c in copies], axis=0)
            return [host[i, :h, :w, :] for i, (h, w) in enumerate(shapes)]
        return materialize


class RelationPredictor:
    """GraphRelation forward over page graph JSON dicts -> [N, N] confidence
    matrices (the run_gnn_clustering device step), one forward per page
    group on the union graph.

    ``model_path``: a model directory (the JAX package's orbax checkpoints
    or the port's: its newest numbered step's ``params`` subtree or, with no
    numbered step, the directory itself as a ``best/<metric>`` export, as
    the JAX predictor restores them), a converted ``.npz``
    (``scripts/convert_weights_to_torch.py --kind gnn``) or a ``.frozen``
    artifact, whose kwargs then build the net in place of this predictor's
    (as the JAX predictor does); None -> random init from ``seed`` (logged
    loudly). The net is built at the first group,
    whose feature widths it takes, as the JAX predictor initializes at its
    first call. Runs in float32 on ``device`` ("cuda" unless told "cpu").
    ``model_dir``: the JAX predictor's keyword for ``model_path`` (give one
    of them).

    ``image_input`` (the visual 'v' nets): the page images go with the
    graphs (``confidences(graph, image)``, ``confidences_batch(graphs,
    images)``); each is ratio-resized on the host to
    ``image_min_dimension`` / ``image_max_dimension`` and zero-padded to a
    square, and its regions' polygons (``visual_regions_nodes`` in the
    feature JSON, written with ``visual_regions=True``) are scaled into it.
    The committed ``gnn_visual`` checkpoint was trained and evaluated at
    288 / 384 with ``visual_backbone="ARU_cutted_v1"``; ``inception_v3``
    (the JAX package's default) runs at the defaults, 600 / 1024.

    ``mesh`` (``parallel.mesh.make_mesh``): data-parallel over its data
    shards, as the JAX predictor over its mesh. The group bucket rounds up
    to a multiple of ``n_data``, the union-graph batch splits on its page
    axis into one equal piece per shard, each piece runs on its shard's
    replica and device (one replica per data row, on the row's first
    device, whatever the ``model`` axis), and the confidences are gathered
    in page order. The mesh's first device then replaces ``device``."""

    def __init__(self, model_path: Optional[str] = None, num_classes: int = 2,
                 gnn_params=None, message_params=None, update_params=None,
                 node_feature_mask: Optional[Sequence[int]] = None,
                 edge_feature_mask: Optional[Sequence[int]] = None,
                 node_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 image_input: bool = False, visual_backbone: str = "ARU_v1",
                 assign_visual_features_to_nodes: bool = True,
                 assign_visual_features_to_edges: bool = False,
                 image_min_dimension: int = 600, image_max_dimension: int = 1024,
                 seed: int = 0, device: DeviceLike = "cuda", mesh=None, *,
                 model_dir: Optional[str] = None):
        if mesh is not None:
            from citlab_as_tpu_torch.parallel.mesh import one_process
            one_process(mesh, "RelationPredictor")
        self.device = resolve_device(mesh.data_devices[0] if mesh is not None else device)
        self.model_path = jax_keyword(model_path, model_dir, "model_path", "model_dir")
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
        self.mesh = mesh
        self._replicas: Optional[List[GraphRelation]] = None
        self._replicas_mesh = None
        # grow-only shapes of the batched inputs (see _batch_inputs)
        self._group_bucket = self._node_bucket = self._edges_bucket = 1
        self._points_bucket = 1

    def over_mesh(self, mesh) -> "RelationPredictor":
        """A view of this predictor that runs over ``mesh``: it shares the
        net once built, and keeps its own mesh, replicas and grow-only
        buckets, so this predictor is left as it was."""
        from citlab_as_tpu_torch.parallel.mesh import one_process
        one_process(mesh, "RelationPredictor")
        view = copy.copy(self)
        view.device = resolve_device(mesh.data_devices[0])
        view.mesh = mesh
        view.node_buckets = list(self.node_buckets)
        view._replicas = view._replicas_mesh = None
        return view

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
            model.load_state_dict(gnn_state_dict_from_flax(
                _variables(self.model_path, bare_state_ok=True)))
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
        # over a mesh the page axis splits evenly over the data shards
        group = _round_up(group, self.n_data)
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
        if self.mesh is not None:
            per = group // self.n_data
            return [torch_batch({k: v[i * per:(i + 1) * per] for k, v in batch.items()}, dev)
                    for i, dev in enumerate(self.mesh.data_devices)], ns
        return torch_batch(batch, self.device), ns

    def confidences_batch(self, graphs: Sequence[dict],
                          images: Optional[Sequence[np.ndarray]] = None
                          ) -> List[np.ndarray]:
        """ONE forward over a whole page group (the union-graph batching of
        graph_gnn.py:81-119); pages pad to the group's shared node/edge
        buckets. ``images``: the pages' grayscale images, for a visual net.
        Returns a list of [n_i, n_i] confidence arrays."""
        return self.confidences_batch_device(graphs, images)()

    @property
    def n_data(self) -> int:
        return self.mesh.shape["data"] if self.mesh is not None else 1

    @torch.no_grad()
    def forward_confidences(self, inputs: Dict[str, torch.Tensor],
                            model: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """softmax(logits)[..., 1] on the device, [B, R]."""
        return torch.softmax((model or self.model)(inputs), dim=-1)[..., 1]

    def _mesh_replicas(self) -> List[GraphRelation]:
        """The net's replica on each data shard of the mesh (made once, or
        again when the mesh changes)."""
        from citlab_as_tpu_torch.parallel.mesh import replicate
        if self._replicas is None or self._replicas_mesh is not self.mesh:
            self._replicas = replicate(self.mesh, self.model)
            self._replicas_mesh = self.mesh
        return self._replicas

    def confidences_batch_device(self, graphs: Sequence[dict],
                                 images: Optional[Sequence[np.ndarray]] = None
                                 ) -> Callable[[], List[np.ndarray]]:
        """Queue the group's forward and the readback of its confidences
        behind it (``utils/async_copy.py::prefetch``), and return a
        zero-arg callable that waits for that copy and yields the per-page
        [n_i, n_i] arrays."""
        inputs, ns = self._batch_inputs(graphs, images)
        if self.mesh is None:
            self._ensure_params(inputs)
            copies = [prefetch(self.forward_confidences(inputs))]
        else:
            self._ensure_params(inputs[0])
            copies = []
            for shard, replica, dev in zip(inputs, self._mesh_replicas(),
                                           self.mesh.data_devices):
                with device_scope(dev):
                    copies.append(prefetch(self.forward_confidences(shard, replica)))

        def materialize():
            host = np.concatenate([c.numpy() for c in copies], axis=0)
            return [host[i, :n * n].reshape(n, n) for i, n in enumerate(ns)]
        return materialize
