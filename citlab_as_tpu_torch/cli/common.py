"""Helpers the port's CLIs share: flags the port cannot honour raise by
name, and ``KEY=VAL`` parameters (clustering, optimizer) parse as the JAX
package parses them."""
from __future__ import annotations

from typing import Dict, Sequence


class UnsupportedFlag(ValueError):
    """A flag of the JAX package's CLI that the port has no counterpart for."""


def refuse(flag: str, why: str) -> None:
    raise UnsupportedFlag(f"{flag} is not supported by the port: {why}")


def model_path(model, model_dir, flag="--model"):
    """The weights a CLI loads: ``--model`` (a converted ``.npz`` or a
    ``.frozen``), or ``--model_dir`` where it names a ``.frozen`` artifact,
    as the JAX predictors read one from there. An orbax checkpoint
    directory is refused: the port reads converted ``.npz`` weights
    (``scripts/convert_weights_to_torch.py``) and ``.frozen`` artifacts.
    ``flag`` names the pair in messages (``--gnn_model`` stands for
    ``--gnn_model`` and ``--gnn_model_dir``)."""
    if model_dir is None:
        return model
    if not model_dir.endswith(".frozen"):
        refuse(f"{flag}_dir", "it reads converted .npz weights and .frozen artifacts, "
               "not orbax checkpoints (convert with scripts/convert_weights_to_torch.py "
               f"and pass {flag})")
    if model is not None:
        raise ValueError(f"pass {flag} or {flag}_dir, not both")
    return model_dir


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
