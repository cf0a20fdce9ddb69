"""Frozen model export: one self-contained artifact for deployment (port of
``citlab_as_tpu/train/export.py``).

The artifact is the JAX package's: a zip holding ``config.json`` (format
version, architecture, constructor kwargs, metadata) and
``params.msgpack``, the flax variables (``params`` and, for Inception v3,
``batch_stats``) in flax's msgpack encoding, written and read by the port's
own stdlib codec (``utils/msgpack.py``). A ``.frozen`` written by either
package loads in the other: the kwargs are the flax modules' field names,
which the port's modules take too (``dtype`` strings become torch dtypes),
and the variables map to the port's modules through ``weights.py``.

The port's variables are flat ``{flax path: array}`` dicts, as in the
converted ``models_ckpt_torch/*.npz`` and the trainers' checkpoints.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from citlab_as_tpu_torch.utils import msgpack

FROZEN_FORMAT_VERSION = 1

#: exportable architectures -> the port's modules
_ARCHITECTURES = ("arunet", "graph_relation", "inception_v3")


def _check_architecture(architecture: str) -> None:
    if architecture not in _ARCHITECTURES:
        raise ValueError(f"Unknown architecture '{architecture}'; "
                         f"known: {sorted(_ARCHITECTURES)}")


def _jsonable(value):
    """Constructor kwargs -> JSON-safe (dtypes become their names)."""
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    try:
        return str(np.dtype(value).name)
    except TypeError:
        raise ValueError(f"model kwarg {value!r} is not JSON-serializable") from None


def flax_variables(architecture: str, model: nn.Module) -> Dict[str, np.ndarray]:
    """A port module's state as flat flax variables (``weights.py``)."""
    from citlab_as_tpu_torch import weights

    _check_architecture(architecture)
    state = model.state_dict()
    if architecture == "arunet":
        return weights.arunet_flax_from_state_dict(state)
    if architecture == "graph_relation":
        return weights.gnn_flax_from_state_dict(state)
    return weights.inception_flax_from_state_dict(state)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _host(value):
    """A leaf as numpy, or as a CPU tensor where numpy lacks its dtype
    (bfloat16)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return value if value.dtype == torch.bfloat16 else value.numpy()
    return np.asarray(value)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat paths -> nested dicts with keys in sorted order at every level,
    the order ``jax.tree_util.tree_map`` gives the JAX package's export."""
    out: Dict[str, Any] = {}
    for path in sorted(flat, key=lambda p: p.split("/")):
        *scopes, leaf = path.split("/")
        node = out
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = flat[path]
    return out


def export_frozen(out_path: str, architecture: str, variables,
                  model_kwargs: Optional[Dict[str, Any]] = None,
                  metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write variables + architecture config as one ``.frozen`` zip.

    ``variables``: flat ``{flax path: array}``, a nested dict of them, or a
    port module of ``architecture`` (mapped by ``weights.py``). Returns the
    written path."""
    _check_architecture(architecture)
    if isinstance(variables, nn.Module):
        variables = flax_variables(architecture, variables)
    flat = {k: _host(v) for k, v in _flatten(variables).items()}
    config = {
        "format_version": FROZEN_FORMAT_VERSION,
        "architecture": architecture,
        "model_kwargs": _jsonable(model_kwargs or {}),
        "metadata": metadata or {},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("config.json", json.dumps(config, indent=1))
        zf.writestr("params.msgpack", msgpack.packb(_nest(flat)))
    with open(out_path, "wb") as f:
        f.write(buf.getvalue())
    return out_path


def _coerce_dtype_kwargs(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(kwargs)
    if isinstance(out.get("dtype"), str):
        out["dtype"] = getattr(torch, out["dtype"])
    return out


def read_frozen(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(config, flat variables) of a ``.frozen`` artifact, without building
    a model."""
    with zipfile.ZipFile(path) as zf:
        config = json.loads(zf.read("config.json"))
        raw = zf.read("params.msgpack")
    if config["format_version"] > FROZEN_FORMAT_VERSION:
        raise ValueError(
            f"frozen artifact version {config['format_version']} is newer "
            f"than supported ({FROZEN_FORMAT_VERSION})")
    _check_architecture(config["architecture"])
    flat = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in _flatten(msgpack.unpackb(raw)).items()}
    return config, flat


def gnn_feature_dims(variables: Dict[str, np.ndarray],
                     kwargs: Dict[str, Any]) -> Tuple[int, Optional[int]]:
    """The node and edge input widths of a ``GraphRelation`` (without its
    visual features), read off its variables: flax infers them at the first
    call, PyTorch needs them to build the module."""
    from citlab_as_tpu_torch.models.gnn.model import (
        DEFAULT_GNN_PARAMS, DEFAULT_MESSAGE_PARAMS, DEFAULT_UPDATE_PARAMS, _merge)

    def rows(scope):
        for leaf in ("hidden_0/kernel", "out/kernel", "kernel"):
            key = f"params/{scope}/{leaf}"
            if key in variables:
                return variables[key].shape[0]
        raise KeyError(f"no kernel under params/{scope}")

    gp = _merge(DEFAULT_GNN_PARAMS, kwargs.get("gnn_params"))
    mp = _merge(DEFAULT_MESSAGE_PARAMS, kwargs.get("message_params"))
    up = _merge(DEFAULT_UPDATE_PARAMS, kwargs.get("update_params"))
    visual = sum(kwargs.get("visual_compressed_dims", (16, 16, 16))) \
        if kwargs.get("image_input") else 0
    node_visual = visual if kwargs.get("assign_visual_features_to_nodes", True) else 0
    edge_visual = visual if kwargs.get("assign_visual_features_to_edges", False) else 0
    h = up["hidden_node_feature_dim"]
    if gp["num_transition_steps"] == 0:
        return rows("Classification") // 2 - node_visual, None
    msg_in = rows("GraphLSTM1/message_fn/head_0_interaction")
    msg_out = mp["interaction_feature_dim"]
    if mp["use_attention"] and mp["multihead_attention_merge_type"] == "concat":
        msg_out = msg_out // mp["num_attention_heads"] * mp["num_attention_heads"]
    if gp["compress_node_feature_dim"] > 0:
        node, du = rows("GraphLSTM1/compress_input"), gp["compress_node_feature_dim"]
    elif up["incorporate_node_input_features_in_update"]:
        du = (rows("GraphLSTM1/update_fn/ingate") - msg_out
              - (h if up["incorporate_hidden_features_in_update"] else 0))
        node = du
    elif gp["output_type"] == "add_final_hidden_and_input":
        node = du = rows("GraphLSTM1/output_proj")
    elif gp["output_type"] == "concat_final_hidden_and_input":
        node = du = rows("Classification") // 2 - h
    else:
        raise ValueError("cannot read the node feature width off these variables; "
                         "pass node_feature_dim")
    edge = msg_in - 4 * du - 4 * h
    return node - node_visual, (edge - edge_visual) if edge else None


def _build_model(architecture: str, model_kwargs: Dict[str, Any],
                variables: Dict[str, np.ndarray],
                node_feature_dim: Optional[int] = None,
                edge_feature_dim: Optional[int] = None) -> nn.Module:
    """The port's module for an artifact's architecture and kwargs, with
    ``variables`` loaded. An ARU-Net keeps float32 weights and computes in
    ``dtype`` (``compute_dtype``), as flax casts at use; ``GraphRelation``
    takes its input widths from the arguments or from the variables."""
    from citlab_as_tpu_torch import weights

    _check_architecture(architecture)
    kwargs = _coerce_dtype_kwargs(model_kwargs)
    dtype = kwargs.pop("dtype", None)
    if architecture == "arunet":
        from citlab_as_tpu_torch.models.arunet import ARUNet
        model = ARUNet(compute_dtype=None if dtype in (None, torch.float32) else dtype,
                       **kwargs)
        model.load_state_dict(weights.arunet_state_dict_from_flax(variables))
    elif architecture == "graph_relation":
        from citlab_as_tpu_torch.models.gnn.model import GraphRelation
        if node_feature_dim is None:
            node_feature_dim, inferred_edge = gnn_feature_dims(variables, model_kwargs)
            edge_feature_dim = inferred_edge if edge_feature_dim is None else edge_feature_dim
        model = GraphRelation(node_feature_dim, edge_feature_dim, **kwargs)
        model.load_state_dict(weights.gnn_state_dict_from_flax(variables))
    else:
        from citlab_as_tpu_torch.models.inception_v3 import InceptionV3
        cin = variables["params/Conv2d_1a_3x3/Conv_0/kernel"].shape[2]
        model = InceptionV3(cin=cin, **kwargs)
        model.load_state_dict(weights.inception_state_dict_from_flax(variables))
        if dtype is not None:
            model = model.to(dtype)
    return model


def load_frozen(path: str, node_feature_dim: Optional[int] = None,
                edge_feature_dim: Optional[int] = None
                ) -> Tuple[nn.Module, Dict[str, np.ndarray], Dict[str, Any]]:
    """Read a ``.frozen`` artifact -> (model with its weights, flat
    variables, metadata). The model is on the CPU; its caller moves it.
    ``node_feature_dim`` / ``edge_feature_dim``: a ``GraphRelation``'s input
    widths where the caller knows them."""
    config, variables = read_frozen(path)
    model = _build_model(config["architecture"], config["model_kwargs"], variables,
                        node_feature_dim, edge_feature_dim)
    return model, variables, config.get("metadata", {})


def export_checkpoint_frozen(ckpt_dir: str, out_path: str, architecture: str,
                             model_kwargs: Optional[Dict[str, Any]] = None,
                             metadata: Optional[Dict[str, Any]] = None) -> str:
    """Freeze the newest checkpoint under ``ckpt_dir`` (or a best/<metric>
    export directory, or an ``.npz``) into ``out_path``: an orbax
    checkpoint (the JAX package's or the port's) or an earlier port run's
    ``checkpoint.npz``, a trainer state's ``params`` subtree
    (``train.checkpoint.checkpoint_variables``)."""
    from citlab_as_tpu_torch.train.checkpoint import checkpoint_variables
    variables, source = checkpoint_variables(ckpt_dir)
    meta = dict(metadata or {})
    meta.setdefault("source_checkpoint", source)
    return export_frozen(out_path, architecture, variables, model_kwargs, meta)
