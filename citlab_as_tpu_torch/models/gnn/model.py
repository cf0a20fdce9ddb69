"""Relation-prediction GNN in PyTorch (port of
``citlab_as_tpu/models/gnn/model.py``: ``_MLP``, ``_segment_softmax``,
``MessageFn``, ``UpdateFnLSTM``, ``GraphGNN``, ``GraphRelation``).

Architecture per the reference training code:
- GraphGNN (gnn/model/graph/graph_gnn.py:46-167): batch flattened into one
  union graph via ``b * max_nodes`` index offsets; optional node-feature
  compression; T=3 message+update transitions from zero h/c; output
  'hidden' | 'add_final_hidden_and_input' | 'concat_final_hidden_and_input'.
- Message function (message_fn_chunk.py:8-453): per-edge interaction feature
  = MLP over [u_from, u_to, u_diff, u_diff^2, edge_feat, h_from, h_to,
  h_diff, h_diff^2] -> tanh 32-d; neighbor weighting 1/in-degree (default)
  or MLP attention with per-destination softmax, multi-head concat/average;
  aggregation sum or max per destination node.
- Update function (update_fn_lstm.py:31-101): per-node LSTM built from four
  dense gates over concat [x, h, u], hidden 32-d.
- Classifier (graph_relation.py:229-287): gather the two nodes' features per
  relation, concat, MLP (64, 32) -> num_classes logits.

As in the JAX module, the gathers and segment reductions run once over the
flattened union graph: ``jax.ops.segment_sum`` becomes ``index_add_`` and
``segment_max`` becomes ``scatter_reduce("amax")`` into a tensor that starts
at -inf, so that an empty segment stays -inf as in JAX and is then mapped
to 0 explicitly. Padded edges go to a dummy segment past the last node.
Dense layers are ``nn.Linear`` (the JAX package computes them in XLA,
outside any Pallas kernel). Module names mirror the flax scopes, so the
converted parameters map by path (``weights.py::gnn_state_dict_from_flax``).

PyTorch needs the input widths at construction, where flax infers them at
the first call: ``GraphRelation`` takes ``node_feature_dim`` and
``edge_feature_dim``. The visual branch (``image_input``, ``visual.py``)
adds its pooled features' width to them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

DEFAULT_GNN_PARAMS: Dict[str, Any] = {
    "num_transition_steps": 3,
    "compress_node_feature_dim": 0,
    "dropout_rate_node_features": 0.0,
    "output_type": "hidden",
}

DEFAULT_MESSAGE_PARAMS: Dict[str, Any] = {
    "aggregation_type": "sum",
    "interaction_feature_dim": 32,
    "num_hidden_units_interaction_fct": [32],
    "use_attention": False,
    "num_attention_heads": 1,
    "multihead_attention_merge_type": "concat",
    "num_hidden_units_attention_fct": [16],
}

DEFAULT_UPDATE_PARAMS: Dict[str, Any] = {
    "hidden_node_feature_dim": 32,
    "incorporate_hidden_features_in_update": True,
    "incorporate_node_input_features_in_update": True,
}


def _merge(defaults: Dict[str, Any], override: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(defaults)
    if override:
        out.update(override)
    return out


class _MLP(nn.Module):
    """ReLU hidden layers ``hidden_<i>`` then the linear ``out`` layer."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 output_activation: Optional[Callable] = None):
        super().__init__()
        self.n_hidden = len(hidden)
        for i, units in enumerate(hidden):
            setattr(self, f"hidden_{i}", nn.Linear(in_dim, units))
            in_dim = units
        self.out = nn.Linear(in_dim, out_dim)
        self.output_activation = output_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        x = self.out(x)
        if self.output_activation is not None:
            x = self.output_activation(x)
        return x


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: zeros where a segment is empty."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segments, values)


def segment_max(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: -inf where a segment is empty (the output
    starts at -inf and the reduction includes it)."""
    out = values.new_full((num_segments,) + tuple(values.shape[1:]), float("-inf"))
    index = segments.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, index, values, reduce="amax", include_self=True)


def _segment_softmax(values, segments, num_segments, mask):
    """Numerically-stable softmax of ``values`` grouped by ``segments``
    (per-destination attention normalization)."""
    neg_inf = torch.full_like(values, float("-inf"))
    values = torch.where(mask, values, neg_inf)
    seg_max = segment_max(values, segments, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    shifted = torch.where(mask, values - seg_max[segments], neg_inf)
    exp = torch.where(mask, torch.exp(shifted), torch.zeros_like(values))
    seg_sum = segment_sum(exp, segments, num_segments)
    return exp / torch.clamp(seg_sum[segments], min=1e-12)


class MessageFn(nn.Module):
    """Segment-reduction message function (one or more attention heads)."""

    def __init__(self, params: Dict[str, Any], in_dim: int):
        super().__init__()
        self.params = p = params
        self.heads = p["num_attention_heads"] if p["use_attention"] else 1
        x_dim = p["interaction_feature_dim"]
        if p["use_attention"] and p["multihead_attention_merge_type"] == "concat":
            x_dim = x_dim // self.heads
        self.x_dim = x_dim
        for head in range(self.heads):
            setattr(self, f"head_{head}_interaction",
                    _MLP(in_dim, p["num_hidden_units_interaction_fct"], x_dim,
                         output_activation=torch.tanh))
            if p["use_attention"]:
                setattr(self, f"head_{head}_attention",
                        _MLP(in_dim, p["num_hidden_units_attention_fct"], 1))

    @property
    def out_dim(self) -> int:
        p = self.params
        if p["use_attention"] and p["multihead_attention_merge_type"] == "concat":
            return self.x_dim * self.heads
        return self.x_dim

    def forward(self, u, h, edges, edge_feats, edge_mask, num_segments: int):
        # u: [M, Du] or None; h: [M, Dh]; edges: [Etot, 2] flat indices;
        # edge_feats: [Etot, De] or None; edge_mask: [Etot] bool
        p = self.params
        src, dst = edges[:, 0], edges[:, 1]
        safe_src = torch.where(edge_mask, src, torch.zeros_like(src))
        safe_dst = torch.where(edge_mask, dst, torch.full_like(dst, num_segments))

        parts = []
        if u is not None:
            u_from, u_to = u[safe_src], u[dst]
            parts += [u_from, u_to, u_to - u_from, (u_to - u_from) ** 2]
        if edge_feats is not None:
            parts.append(edge_feats)
        h_from, h_to = h[safe_src], h[dst]
        parts += [h_from, h_to, h_to - h_from, (h_to - h_from) ** 2]
        feats = torch.cat(parts, dim=-1)

        # in-degree of each destination over valid edges (balanced weighting);
        # kept with the dummy segment, which padded edges gather (JAX clamps
        # that out-of-range gather; its value is masked either way)
        ones = edge_mask.to(feats.dtype)
        degree = segment_sum(ones, safe_dst, num_segments + 1)

        mask_col = edge_mask[:, None]
        head_outputs = []
        for head in range(self.heads):
            inter = getattr(self, f"head_{head}_interaction")(feats)
            if p["use_attention"]:
                att_logit = getattr(self, f"head_{head}_attention")(feats)[..., 0]
                att = _segment_softmax(att_logit, safe_dst, num_segments + 1, edge_mask)
            else:
                att = torch.where(
                    edge_mask, 1.0 / torch.clamp(degree[safe_dst], min=1.0),
                    torch.zeros_like(ones))
            weighted = inter * att[:, None]
            weighted = torch.where(mask_col, weighted, torch.zeros_like(weighted))
            if p["aggregation_type"] == "max":
                agg = segment_max(
                    torch.where(mask_col, weighted, torch.full_like(weighted, float("-inf"))),
                    safe_dst, num_segments + 1)[:-1]
                agg = torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
            else:
                agg = segment_sum(weighted, safe_dst, num_segments + 1)[:-1]
            head_outputs.append(agg)

        if not p["use_attention"] or p["multihead_attention_merge_type"] == "average":
            return sum(head_outputs) / len(head_outputs)
        return torch.cat(head_outputs, dim=-1)


class UpdateFnLSTM(nn.Module):
    """Four dense gates over concat [x, h, u] (update_fn_lstm.py:31-101)."""

    def __init__(self, params: Dict[str, Any], in_dim: int):
        super().__init__()
        self.params = params
        h_dim = params["hidden_node_feature_dim"]
        self.ingate = nn.Linear(in_dim, h_dim)
        self.outgate = nn.Linear(in_dim, h_dim)
        self.forgetgate = nn.Linear(in_dim, h_dim)
        self.cellinput = nn.Linear(in_dim, h_dim)

    def forward(self, x, h, c, u):
        p = self.params
        parts = [x]
        if p["incorporate_hidden_features_in_update"]:
            parts.append(h)
        if p["incorporate_node_input_features_in_update"] and u is not None:
            parts.append(u)
        z = torch.cat(parts, dim=-1)
        ingate = torch.sigmoid(self.ingate(z))
        outgate = torch.sigmoid(self.outgate(z))
        forget = torch.sigmoid(self.forgetgate(z))
        cellinput = torch.tanh(self.cellinput(z))
        c = forget * c + ingate * cellinput
        h = outgate * torch.tanh(c)
        return h, c


class GraphGNN(nn.Module):
    """Batched GraphLSTM over the union graph (graph_gnn.py:46-167)."""

    def __init__(self, node_feature_dim: int, edge_feature_dim: Optional[int],
                 gnn_params: Optional[Dict[str, Any]] = None,
                 message_params: Optional[Dict[str, Any]] = None,
                 update_params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.gp = gp = _merge(DEFAULT_GNN_PARAMS, gnn_params)
        mp = _merge(DEFAULT_MESSAGE_PARAMS, message_params)
        self.up = up = _merge(DEFAULT_UPDATE_PARAMS, update_params)
        h_dim = up["hidden_node_feature_dim"]
        self.h_dim = h_dim
        self.out_dim = node_feature_dim
        if gp["num_transition_steps"] == 0:
            return
        du = node_feature_dim
        if gp["compress_node_feature_dim"] > 0:
            du = gp["compress_node_feature_dim"]
            self.compress_input = nn.Linear(node_feature_dim, du)
        msg_in = 4 * du + (edge_feature_dim or 0) + 4 * h_dim
        self.message_fn = MessageFn(mp, msg_in)
        upd_in = self.message_fn.out_dim
        if up["incorporate_hidden_features_in_update"]:
            upd_in += h_dim
        if up["incorporate_node_input_features_in_update"]:
            upd_in += du
        self.update_fn = UpdateFnLSTM(up, upd_in)
        self.out_dim = h_dim
        if gp["output_type"] == "add_final_hidden_and_input":
            self.output_proj = nn.Linear(node_feature_dim, h_dim, bias=False)
        elif gp["output_type"] == "concat_final_hidden_and_input":
            self.out_dim = h_dim + node_feature_dim

    def forward(self, inputs: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """``train`` with ``dropout_rate_node_features`` > 0 drops node
        features (inverted dropout, keep mask drawn from ``generator``), as
        flax's ``nn.Dropout`` does in train mode."""
        gp = self.gp
        if gp["num_transition_steps"] == 0:
            return None
        node_features = inputs["node_features"]      # [B, N, Dn]
        edges = inputs["interacting_nodes"]          # [B, E, 2] (corrected, padded)
        num_edges = inputs["num_interacting_nodes"]  # [B]

        b, n = edges.shape[0], node_features.shape[1]
        m = b * n
        # flatten the batch into one union graph
        offsets = (torch.arange(b, device=edges.device) * n)[:, None, None]
        flat_edges = (edges + offsets).reshape(-1, 2)
        edge_mask = (torch.arange(edges.shape[1], device=edges.device)[None, :]
                     < num_edges[:, None]).reshape(-1)
        edge_feats = inputs.get("edge_features")
        flat_edge_feats = (edge_feats.reshape(-1, edge_feats.shape[-1])
                           if edge_feats is not None else None)

        feats = node_features
        if gp["compress_node_feature_dim"] > 0:
            feats = torch.tanh(self.compress_input(feats))
        rate = gp["dropout_rate_node_features"]
        if rate > 0 and train:
            keep = 1.0 - rate
            kept = torch.rand(feats.shape, generator=generator,
                              device=feats.device) < keep
            feats = torch.where(kept, feats / keep, torch.zeros_like(feats))
        u = feats.reshape(m, feats.shape[-1])

        h = node_features.new_zeros((m, self.h_dim))
        c = node_features.new_zeros((m, self.h_dim))
        for _ in range(gp["num_transition_steps"]):
            x = self.message_fn(u, h, flat_edges, flat_edge_feats, edge_mask, m)
            h, c = self.update_fn(x, h, c, u)

        out = h.reshape(b, n, self.h_dim)
        if gp["output_type"] == "add_final_hidden_and_input":
            out = out + self.output_proj(node_features)
        elif gp["output_type"] == "concat_final_hidden_and_input":
            out = torch.cat([out, node_features], dim=-1)
        return out


def _visual_layers(backbone: str) -> Sequence[str]:
    """The backbone end points the visual features pool from."""
    if backbone == "inception_v3":
        return ("Mixed_5d", "Mixed_6e", "Mixed_7c")
    if backbone == "ARU_cutted_v1":
        # per-scale pre-pool maps of the cutted extractor (1/4 .. 1/16)
        return ("res_block_2", "res_block_3", "res_block_4")
    return ("scale_0_unet_down_2_conv", "scale_0_unet_down_3_conv",
            "scale_0_unet_down_4_conv")


class GraphRelation(nn.Module):
    """GNN + pairwise relation classifier (graph_relation.py:67-287).

    inputs: num_nodes [B], node_features [B, N, Dn], interacting_nodes
    [B, E, 2], num_interacting_nodes [B], edge_features [B, E, De],
    relations_to_consider [B, R, 2] (index tensors int64). Returns logits
    [B, R, num_classes].

    With ``image_input`` (the 'v' nets) the inputs also hold image
    [B, H, W, 1], image_shape [B, 2] and visual_regions_nodes [B, N, 2, P]
    with num_points_visual_regions_nodes [B, N] (and the edge variants);
    the per-region pooled backbone features (``visual.py``) are appended to
    the node (and edge) features, so the GNN's widths grow by their size.
    """

    def __init__(self, node_feature_dim: int, edge_feature_dim: Optional[int],
                 num_classes: int = 2, classifier_hidden: Sequence[int] = (64, 32),
                 gnn_params: Optional[Dict[str, Any]] = None,
                 message_params: Optional[Dict[str, Any]] = None,
                 update_params: Optional[Dict[str, Any]] = None,
                 image_input: bool = False, visual_backbone: str = "inception_v3",
                 visual_from_layers: Optional[Sequence[str]] = None,
                 visual_compressed_dims: Sequence[int] = (16, 16, 16),
                 assign_visual_features_to_nodes: bool = True,
                 assign_visual_features_to_edges: bool = False):
        super().__init__()
        self.image_input = image_input
        if image_input:
            from citlab_as_tpu_torch.models.gnn.visual import VisualFeatureExtractor
            self.visual = VisualFeatureExtractor(
                backbone=visual_backbone,
                from_layers=tuple(visual_from_layers or _visual_layers(visual_backbone)),
                layer_compressed_dims=tuple(visual_compressed_dims),
                nodes=assign_visual_features_to_nodes,
                edges=assign_visual_features_to_edges)
            if assign_visual_features_to_nodes:
                node_feature_dim += self.visual.out_dim
            if assign_visual_features_to_edges:
                edge_feature_dim = (edge_feature_dim or 0) + self.visual.out_dim
        self.GraphLSTM1 = GraphGNN(node_feature_dim, edge_feature_dim,
                                   gnn_params, message_params, update_params)
        self.Classification = _MLP(2 * self.GraphLSTM1.out_dim,
                                   tuple(classifier_hidden), num_classes)

    def forward(self, inputs: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` / ``generator``: node-feature dropout (``GraphGNN``);
        with the Inception v3 visual backbone ``train`` raises
        (``inception_v3.TrainModeUnsupported``), as the JAX package's
        train mode does: its batch statistics are never mutable."""
        if self.image_input and "image" in inputs:
            node_vis, edge_vis = self.visual(
                inputs["image"],
                inputs.get("visual_regions_nodes"),
                inputs.get("num_points_visual_regions_nodes"),
                inputs.get("visual_regions_edges"),
                inputs.get("num_points_visual_regions_edges"), train)
            inputs = dict(inputs)
            if node_vis is not None:
                inputs["node_features"] = torch.cat([inputs["node_features"], node_vis], -1)
            if edge_vis is not None:
                inputs["edge_features"] = torch.cat([inputs["edge_features"], edge_vis], -1)
        gnn_out = self.GraphLSTM1(inputs, train, generator)
        if gnn_out is None:
            gnn_out = inputs["node_features"]
        relations = inputs["relations_to_consider"]  # [B, R, 2]
        b, r = relations.shape[0], relations.shape[1]
        batch = torch.arange(b, device=relations.device)[:, None, None]
        pair_feats = gnn_out[batch, relations]       # [B, R, 2, D]
        return self.Classification(pair_feats.reshape(b, r, -1))

    def predict_confidences(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """softmax(logits)[..., 1] — the 'belong_to_same_instance'
        probability per relation (model_relation.py:326-342)."""
        return torch.softmax(self(inputs), dim=-1)[..., 1]
