"""Helpers the port's CLIs share: flags the port cannot honour raise by
name, and ``KEY=VAL`` parameters (clustering, optimizer) parse as the JAX
package parses them."""
from __future__ import annotations

from typing import Dict, Sequence


class UnsupportedFlag(ValueError):
    """A flag of the JAX package's CLI that the port has no counterpart for."""


def refuse(flag: str, why: str) -> None:
    raise UnsupportedFlag(f"{flag} is not supported by the port: {why}")


def refuse_model_dir(model_dir) -> None:
    """The JAX CLIs read orbax checkpoint directories; the port reads the
    converted ``.npz`` files (``scripts/convert_weights_to_torch.py``)."""
    if model_dir is not None:
        refuse("--model_dir", "it reads converted .npz weights, not orbax checkpoints "
               "(convert with scripts/convert_weights_to_torch.py and pass --model)")


def clustering_params(pairs: Sequence[str]) -> Dict:
    """``KEY=VAL`` strings -> dict (run_gnn_clustering.py:69-72; the
    trainer CLIs parse ``--optimizer_params`` the same way,
    run_train_gnn.py:47-51); a string without ``=`` is ignored, as in the
    JAX package."""
    from citlab_as_tpu_torch.config.flags import _parse_dict_value
    out = {}
    for kv in pairs:
        if "=" in kv:
            key, val = kv.split("=", 1)
            out[key] = _parse_dict_value(val)
    return out
