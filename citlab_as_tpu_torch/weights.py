"""Weight bridge between the JAX package's flax parameter trees and the
port's modules (the ARU-Nets and the relation GNNs, the visual ones
included), both ways.

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
from typing import Dict

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


def _visual_state_dict(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The ``params/visual`` subtree (paths relative to it) -> the port's
    ``GraphRelation.visual`` entries: ``backbone/...`` by the ARU-Net
    mapping, ``feature_maps/<conv>/kernel`` (a plain flax ``Conv``, HWIO)
    to OIHW, ``visual_<node|edge>_compress_fm_<i>/kernel`` (``Dense``)
    transposed."""
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
    for name, value in arunet_state_dict_from_flax(backbone).items():
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
    :func:`_visual_state_dict`. A path with a scope the relation GNN does
    not have raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    visual: Dict[str, np.ndarray] = {}
    for path, value in params.items():
        parts = path.split("/")
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
    out.update(_visual_state_dict(visual))
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
    feature-map convs OIHW -> HWIO, compress layers transposed)."""
    out: Dict[str, np.ndarray] = {}
    backbone = {}
    for name, value in state_dict.items():
        *scopes, leaf = name.split(".")
        if leaf not in ("weight", "bias"):
            raise KeyError(f"unexpected relation-GNN parameter {name!r}")
        if scopes[:2] == ["visual", "backbone"]:
            backbone[".".join(scopes[2:] + [leaf])] = value
            continue
        arr = _np(value)
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        key = "/".join(scopes + ["kernel" if leaf == "weight" else "bias"])
        out[prefix + key] = np.ascontiguousarray(arr)
    for key, arr in arunet_flax_from_state_dict(backbone, prefix="").items():
        out[prefix + "visual/backbone/" + key] = arr
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{flax path: ndarray}`` from a converted ``.npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
