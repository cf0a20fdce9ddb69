"""One orbax checkpoint directory of the JAX package read without orbax,
tensorstore or JAX: ``<ckpt_dir>/<step>/`` or ``best/<metric>/`` as
``citlab_as_tpu/train/checkpoint.py`` writes it (orbax's
``StandardCheckpointHandler``: an OCDBT store of zarr v2 arrays).

``_METADATA`` (JSON) holds the tree: per leaf its key path (``key_type`` 2 a
dict key, 1 a sequence index) and its ``value_metadata``: ``value_type``
"jax.Array", "np.ndarray" or "scalar" for an array stored under the zarr
name ``".".join(keys)``, and an empty container or None ("Dict", "List",
"Tuple", "None", with ``skip_deserialize``). :func:`restore` returns the
nested dict orbax restores without a template: dicts, lists for sequences,
numpy arrays (bf16 leaves as ``torch.bfloat16`` tensors), a Python number
for a "scalar". ``_CHECKPOINT_METADATA``, ``_sharding`` and
``array_metadatas/`` describe devices and write shapes; a restore on the
host needs none of them. A checkpoint in zarr v3 (``use_zarr3``), one
written without OCDBT, or a value type other than these raises
:class:`OrbaxError` naming it.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

from citlab_as_tpu_torch.utils import zarr
from citlab_as_tpu_torch.utils.ocdbt import OcdbtStore

METADATA_FILE = "_METADATA"
_EMPTY = {"Dict": dict, "List": list, "Tuple": list, "None": lambda: None}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")


class OrbaxError(ValueError):
    """An orbax checkpoint in a form this reader does not read."""


def is_orbax_checkpoint(path: str) -> bool:
    """``path`` is one orbax checkpoint (a step or a best export)."""
    return os.path.isfile(os.path.join(path, METADATA_FILE))


def read_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or not isinstance(meta.get("tree_metadata"), dict):
        raise OrbaxError(f"{path}: {METADATA_FILE} holds no tree_metadata")
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{path}: zarr v3 arrays (use_zarr3) are not read yet, "
                         "only zarr v2")
    if not meta.get("use_ocdbt", False):
        raise OrbaxError(f"{path}: a checkpoint written without OCDBT (one zarr "
                         "directory per array) is not read")
    return meta


def _finish(node: Dict[str, Any], kinds: Dict[int, int], path: str):
    """Sequence containers (their children's key_type 1) become lists."""
    for key, child in node.items():
        if isinstance(child, dict) and id(child) in kinds:
            node[key] = _finish(child, kinds, f"{path}/{key}")
    if kinds.get(id(node)) != 1:
        return node
    try:
        order = sorted(node, key=int)
    except ValueError:
        raise OrbaxError(f"{path}: sequence index {sorted(node)!r} is not a number") from None
    if [int(k) for k in order] != list(range(len(order))):
        raise OrbaxError(f"{path}: sequence indices {order!r} are not 0..n-1")
    return [node[k] for k in order]


def restore(path: str) -> Dict[str, Any]:
    """The tree of the orbax checkpoint in directory ``path``."""
    path = os.path.abspath(path)
    meta = read_metadata(path)
    store = OcdbtStore(path)

    def read(key: str):
        return store.read(key) if key in store else None

    root: Dict[str, Any] = {}
    kinds: Dict[int, int] = {id(root): 2}
    for name, entry in meta["tree_metadata"].items():
        try:
            keys = [(str(k["key"]), int(k["key_type"])) for k in entry["key_metadata"]]
            value = entry["value_metadata"]
            vtype = value["value_type"]
        except (KeyError, TypeError, ValueError):
            raise OrbaxError(f"{path}: malformed tree entry {name}") from None
        if not keys or any(t not in (1, 2) for _, t in keys) or keys[0][1] != 2:
            raise OrbaxError(f"{path}: key path of {name} is not read")
        if value.get("skip_deserialize"):
            if vtype not in _EMPTY:
                raise OrbaxError(f"{path}: {name} is skipped with value type {vtype!r}")
            leaf = _EMPTY[vtype]()
        elif vtype in _ARRAYS:
            try:
                leaf = zarr.read_array(read, ".".join(k for k, _ in keys))
            except zarr.ZarrError as e:
                raise OrbaxError(f"{path}: {e}") from None
            if vtype == "scalar":
                leaf = leaf.item()
        else:
            raise OrbaxError(f"{path}: value type {vtype!r} of {name} is not read")
        node = root
        for depth, (key, _) in enumerate(keys[:-1]):
            kind = keys[depth + 1][1]
            child = node.setdefault(key, {})
            if not isinstance(child, dict) or kinds.setdefault(id(child), kind) != kind:
                raise OrbaxError(f"{path}: {name} conflicts with another leaf")
            node = child
        key, _ = keys[-1]
        if key in node or kinds[id(node)] != keys[-1][1]:
            raise OrbaxError(f"{path}: {name} conflicts with another leaf")
        node[key] = leaf
    return _finish(root, kinds, path)

