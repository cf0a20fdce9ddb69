"""Weight bridge from the JAX package's flax parameter trees (the ARU-Nets
and the relation GNN).

The flax tree is carried as a flat ``{path: ndarray}`` dict with
``/``-joined paths (``params/featMapG/unet_down_0/conv1/conv/kernel``), as
``scripts/convert_weights_to_torch.py`` writes it into an ``.npz``. The
port's module names mirror the flax scopes, so a path maps to a
``state_dict`` key by dropping the leading ``params`` and the inner
``conv`` / ``deconv`` scope.
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
        *scopes, inner, leaf = parts
        if inner not in ("conv", "deconv") or leaf not in ("kernel", "bias"):
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


def gnn_state_dict_from_flax(params: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """Map flat flax relation-GNN params to the port's ``GraphRelation``
    state_dict.

    Paths look like ``params/GraphLSTM1/message_fn/head_0_interaction/
    hidden_0/kernel``, ``params/GraphLSTM1/update_fn/ingate/bias`` and
    ``params/Classification/out/kernel``; the port's modules carry the same
    names. A flax ``Dense`` kernel [in, out] becomes ``Linear.weight``
    [out, in]. A path with a scope the relation GNN does not have (the
    visual branch included) raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in params.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
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
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{flax path: ndarray}`` from a converted ``.npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
