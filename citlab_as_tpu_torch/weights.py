"""Weight bridge between the JAX package's flax parameter trees and the
port's modules (the ARU-Nets, Inception v3 and the relation GNNs, the
visual ones included), both ways.

The flax tree is carried as a flat ``{path: ndarray}`` dict with
``/``-joined paths (``params/featMapG/unet_down_0/conv1/conv/kernel``), as
``scripts/convert_weights_to_torch.py`` writes it into an ``.npz``. The
port's module names mirror the flax scopes, so a path maps to a
``state_dict`` key by dropping the leading ``params`` and the inner
``conv`` / ``deconv`` scope. The inverse maps (``*_flax_from_state_dict``)
give a port ``state_dict`` back as the flat flax dict, bit for bit, so a
JAX init goes into the port and a net the port trained goes back (the
training checkpoints and best exports name every tensor by that path).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch


def arunet_state_dict_from_flax(params: Dict[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """Map flat flax ARU-Net params to the port's ``ARUNet`` state_dict.

    - ``<scope>/conv/kernel`` HWIO -> ``<scope>.weight`` OIHW, read by both
      K1 and ``F.conv2d``;
    - ``<scope>/deconv/kernel`` HWIO -> ``<scope>.weight`` [I, O, kh, kw],
      spatially flipped for ``F.conv_transpose2d`` (flax's ConvTranspose
      correlates with the unflipped kernel);
    - ``.../bias`` -> ``.bias``."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in params.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        *scopes, inner, leaf = [""] * (3 - len(parts)) + parts
        if (not scopes[0] or inner not in ("conv", "deconv")
                or leaf not in ("kernel", "bias")):
            raise KeyError(f"unexpected ARU-Net parameter path {path!r}")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            if inner == "conv":
                arr = arr.transpose(3, 2, 0, 1)
            else:
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        name = ".".join(scopes) + (".weight" if leaf == "kernel" else ".bias")
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


_GNN_SCOPE = re.compile(
    r"(GraphLSTM1|Classification|message_fn|update_fn|compress_input|"
    r"output_proj|head_\d+_(interaction|attention)|hidden_\d+|out|ingate|"
    r"outgate|forgetgate|cellinput)$")
_FEATURE_MAP_CONV = re.compile(r"(proj_\d+_\w+|reduce_\d+|down_\d+)$")
_COMPRESS = re.compile(r"visual_(node|edge)_compress_fm_\d+$")


def _is_inception(paths) -> bool:
    """True when backbone paths (flax ``/`` or torch ``.`` joined) are the
    Inception v3's: its units' inner scopes are ``Conv_0`` / ``BatchNorm_0``,
    the ARU-Nets' ``conv`` / ``deconv``."""
    return any(part in ("Conv_0", "BatchNorm_0")
               for p in paths for part in p.replace(".", "/").split("/"))


def _visual_state_dict(params: Dict[str, np.ndarray],
                       batch_stats: Optional[Dict[str, np.ndarray]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The ``params/visual`` subtree (paths relative to it; with
    ``batch_stats``, the ``batch_stats/visual`` one) -> the port's
    ``GraphRelation.visual`` entries: ``backbone/...`` by the ARU-Net or the
    Inception v3 mapping, ``feature_maps/<conv>/kernel`` (a plain flax
    ``Conv``, HWIO) to OIHW, ``visual_<node|edge>_compress_fm_<i>/kernel``
    (``Dense``) transposed."""
    out: Dict[str, torch.Tensor] = {}
    backbone = {}
    for path, value in params.items():
        scope, _, rest = path.partition("/")
        if scope == "backbone":
            backbone[rest] = value
            continue
        *scopes, leaf = path.split("/")
        arr = np.asarray(value, np.float32)
        if leaf not in ("kernel", "bias"):
            raise KeyError(f"unexpected visual parameter path {path!r}")
        if scopes[:1] == ["feature_maps"] and len(scopes) == 2 \
                and _FEATURE_MAP_CONV.match(scopes[1]):
            arr = arr.transpose(3, 2, 0, 1) if leaf == "kernel" else arr
        elif len(scopes) == 1 and _COMPRESS.match(scopes[0]):
            arr = arr.T if leaf == "kernel" else arr
        else:
            raise KeyError(f"unexpected visual parameter path {path!r}")
        name = "visual." + ".".join(scopes) + (".weight" if leaf == "kernel" else ".bias")
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    stats = {}
    for path, value in (batch_stats or {}).items():
        scope, _, rest = path.partition("/")
        if scope != "backbone":
            raise KeyError(f"unexpected visual batch_stats path {path!r}")
        stats[rest] = value
    if stats or _is_inception(backbone):
        mapped = inception_state_dict_from_flax(
            {**{"params/" + k: v for k, v in backbone.items()},
             **{"batch_stats/" + k: v for k, v in stats.items()}})
    else:
        mapped = arunet_state_dict_from_flax(backbone)
    for name, value in mapped.items():
        out["visual.backbone." + name] = value
    return out


def gnn_state_dict_from_flax(params: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """Map flat flax relation-GNN params to the port's ``GraphRelation``
    state_dict.

    Paths look like ``params/GraphLSTM1/message_fn/head_0_interaction/
    hidden_0/kernel``, ``params/GraphLSTM1/update_fn/ingate/bias`` and
    ``params/Classification/out/kernel``; the port's modules carry the same
    names. A flax ``Dense`` kernel [in, out] becomes ``Linear.weight``
    [out, in]. The visual nets' ``params/visual/...`` subtree maps through
    :func:`_visual_state_dict`, with the Inception backbone's
    ``batch_stats/visual/backbone/...``. A path with a scope the relation
    GNN does not have raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    visual: Dict[str, np.ndarray] = {}
    visual_stats: Dict[str, np.ndarray] = {}
    for path, value in params.items():
        parts = path.split("/")
        if parts[0] == "batch_stats" and parts[1:2] == ["visual"]:
            visual_stats["/".join(parts[2:])] = value
            continue
        if parts[0] == "params":
            parts = parts[1:]
        if parts[0] == "visual" and len(parts) > 2:
            visual["/".join(parts[1:])] = value
            continue
        *scopes, leaf = parts
        if (not scopes or scopes[0] not in ("GraphLSTM1", "Classification")
                or leaf not in ("kernel", "bias")
                or not all(_GNN_SCOPE.match(s) for s in scopes)):
            raise KeyError(f"unexpected relation-GNN parameter path {path!r}")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            arr = arr.T
        name = ".".join(scopes) + (".weight" if leaf == "kernel" else ".bias")
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    out.update(_visual_state_dict(visual, visual_stats))
    return out


def _np(t) -> np.ndarray:
    """A tensor as numpy; bf16 (which numpy lacks) widened to float32,
    exactly."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def arunet_flax_from_state_dict(state_dict: Dict[str, torch.Tensor],
                                prefix: str = "params/") -> Dict[str, np.ndarray]:
    """Inverse of :func:`arunet_state_dict_from_flax`: ``<scope>.weight`` of a
    conv (OIHW) -> ``<scope>/conv/kernel`` HWIO, of a transposed conv (a
    scope named ``*_deconv``, [I, O, kh, kw] flipped) ->
    ``<scope>/deconv/kernel`` HWIO unflipped; ``.bias`` -> ``/bias``."""
    out: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        *scopes, leaf = name.split(".")
        if not scopes or leaf not in ("weight", "bias"):
            raise KeyError(f"unexpected ARU-Net parameter {name!r}")
        inner = "deconv" if scopes[-1].endswith("_deconv") else "conv"
        arr = _np(value)
        if leaf == "weight":
            if inner == "conv":
                arr = arr.transpose(2, 3, 1, 0)
            else:
                arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        key = "/".join(scopes + [inner, "kernel" if leaf == "weight" else "bias"])
        out[prefix + key] = np.ascontiguousarray(arr)
    return out


def gnn_flax_from_state_dict(state_dict: Dict[str, torch.Tensor],
                             prefix: str = "params/") -> Dict[str, np.ndarray]:
    """Inverse of :func:`gnn_state_dict_from_flax`: ``Linear.weight`` [out,
    in] -> ``kernel`` [in, out]; the ``visual.`` entries by the inverse of
    the visual mapping (the backbone by :func:`arunet_flax_from_state_dict`,
    feature-map convs OIHW -> HWIO, compress layers transposed; an
    Inception backbone by :func:`inception_flax_from_state_dict`, its
    running statistics under ``batch_stats/``)."""
    out: Dict[str, np.ndarray] = {}
    backbone = {}
    for name, value in state_dict.items():
        *scopes, leaf = name.split(".")
        if scopes[:2] == ["visual", "backbone"]:
            backbone[".".join(scopes[2:] + [leaf])] = value
            continue
        if leaf not in ("weight", "bias"):
            raise KeyError(f"unexpected relation-GNN parameter {name!r}")
        arr = _np(value)
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        key = "/".join(scopes + ["kernel" if leaf == "weight" else "bias"])
        out[prefix + key] = np.ascontiguousarray(arr)
    if _is_inception(backbone):
        for key, arr in inception_flax_from_state_dict(backbone).items():
            collection, _, rest = key.partition("/")
            out[prefix.replace("params", collection, 1) + "visual/backbone/" + rest] = arr
    else:
        for key, arr in arunet_flax_from_state_dict(backbone, prefix="").items():
            out[prefix + "visual/backbone/" + key] = arr
    return out


_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def inception_state_dict_from_flax(variables: Dict[str, np.ndarray]
                                   ) -> Dict[str, torch.Tensor]:
    """Map flat flax Inception v3 variables (``params/...`` and
    ``batch_stats/...`` paths) to the port's ``InceptionV3`` state_dict:
    ``<scope>/Conv_0/kernel`` HWIO -> ``<scope>.Conv_0.weight`` OIHW;
    ``<scope>/BatchNorm_0/{scale,bias}`` and the batch statistics
    ``{mean,var}`` -> ``weight``, ``bias``, ``running_mean``,
    ``running_var`` (``num_batches_tracked``, which flax does not keep,
    set to 0)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in variables.items():
        collection, *scopes, inner, leaf = path.split("/")
        arr = np.asarray(value, np.float32)
        if inner == "Conv_0" and collection == "params" and leaf == "kernel" and scopes:
            name = ".".join(scopes + [inner, "weight"])
            arr = arr.transpose(3, 2, 0, 1)
        elif inner == "BatchNorm_0" and (collection, leaf) in _BN_LEAVES and scopes:
            name = ".".join(scopes + [inner, _BN_LEAVES[collection, leaf]])
            out[".".join(scopes + [inner, "num_batches_tracked"])] = torch.tensor(0)
        else:
            raise KeyError(f"unexpected Inception v3 variable path {path!r}")
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def inception_flax_from_state_dict(state_dict: Dict[str, torch.Tensor]
                                   ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`inception_state_dict_from_flax`, with the
    collection prefixes ``params/`` and ``batch_stats/``;
    ``num_batches_tracked`` is dropped."""
    leaves = {v: k for k, v in _BN_LEAVES.items()}
    out: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        *scopes, inner, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = _np(value)
        if inner == "Conv_0" and leaf == "weight":
            collection, key = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0)
        elif inner == "BatchNorm_0" and leaf in leaves:
            collection, key = leaves[leaf]
        else:
            raise KeyError(f"unexpected Inception v3 parameter {name!r}")
        out["/".join([collection] + scopes + [inner, key])] = np.ascontiguousarray(arr)
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{flax path: ndarray}`` from a converted ``.npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
