"""Helpers the port's CLIs share: a model flag pair (``--model`` /
``--model_dir``, where a model directory is the JAX package's orbax
checkpoints as its CLIs take them), and ``KEY=VAL`` parameters (clustering,
optimizer) parse as the JAX package parses them."""
from __future__ import annotations

from typing import Dict, Sequence


def model_path(model, model_dir, flag="--model"):
    """The weights a CLI loads: ``--model`` (a converted ``.npz`` or a
    ``.frozen``) or ``--model_dir``, which takes what the JAX CLI's does: a
    model directory of orbax checkpoints (``models_ckpt/separator``, a
    trainer's ``--model_dir``, a ``best/<metric>`` export), read on the
    card's machine without orbax (``train/orbax.py``), or the port's own
    checkpoints, or a ``.frozen`` artifact. ``flag`` names the pair in
    messages (``--gnn_model`` stands for ``--gnn_model`` and
    ``--gnn_model_dir``)."""
    if model_dir is None:
        return model
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
