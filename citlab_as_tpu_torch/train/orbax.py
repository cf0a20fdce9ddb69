"""One orbax checkpoint directory of the JAX package, read and written
without orbax, tensorstore or JAX: ``<ckpt_dir>/<step>/`` or
``best/<metric>/`` as ``citlab_as_tpu/train/checkpoint.py`` writes it
(orbax's ``StandardCheckpointHandler``: an OCDBT store of zarr arrays).

``_METADATA`` (JSON) holds the tree: per leaf its key path (``key_type`` 2 a
dict key or a NamedTuple field, 1 a sequence index) and its
``value_metadata``: ``value_type`` "jax.Array", "np.ndarray" or "scalar"
for an array stored under the zarr name ``".".join(keys)``, and an empty
container or None ("Dict", "List", "Tuple", "None", with
``skip_deserialize``). :func:`restore` returns the nested dict orbax
restores without a template: dicts, lists for sequences, numpy arrays
(bf16 leaves as ``torch.bfloat16`` tensors), a Python number for a
"scalar". The arrays are zarr v2 or, under ``use_zarr3``, zarr v3.
``_CHECKPOINT_METADATA``, ``_sharding`` and ``array_metadatas/`` describe
devices and write shapes; a restore on the host needs none of them. A
checkpoint written without OCDBT, or a value type other than these, raises
:class:`OrbaxError` naming it.

:func:`save` writes a tree as orbax saves the JAX trainers' states, so the
JAX package restores it as its own: a tensor is a "jax.Array" (its
``write_shape``, and a ``_sharding`` entry naming the host's first CPU
device, without which orbax's restore without a template gives numpy
arrays), a numpy array or a number an "np.ndarray" (as the JAX package's
``_arrayify`` makes it); zarr v2 arrays in a one-level OCDBT store
(``utils/ocdbt.py``); and ``_CHECKPOINT_METADATA`` of the
``StandardCheckpointHandler``. ``array_metadatas/`` is left out: every
restore of the JAX package does without it.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from citlab_as_tpu_torch.utils import zarr
from citlab_as_tpu_torch.utils.ocdbt import OcdbtStore, OcdbtWriter

METADATA_FILE = "_METADATA"
CHECKPOINT_METADATA_FILE = "_CHECKPOINT_METADATA"
SHARDING_FILE = "_sharding"
_EMPTY = {"Dict": dict, "List": list, "Tuple": list, "None": lambda: None}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
#: where a JAX process on the host holds an array: its first CPU device
_HOST_SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding",
                             "device_str": "TFRT_CPU_0"})


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
    read_array = zarr.read_array_v3 if meta.get("use_zarr3") else zarr.read_array

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
                leaf = read_array(read, ".".join(k for k, _ in keys))
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



# ---------------------------------------------------------------- writing

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaves(node, keys: Tuple[Tuple[str, int], ...], out: List) -> None:
    """(key path, value) of every leaf and empty container of ``node`` in
    the order ``jax.tree_util`` flattens it: dict keys sorted, NamedTuple
    fields and sequence items in order."""
    if isinstance(node, dict):
        children = [(k, 2, node[k]) for k in sorted(node)]
        if any(not isinstance(k, str) for k in node):
            raise OrbaxError(f"{'.'.join(k for k, _ in keys)}: dict keys must be str")
    elif _is_namedtuple(node):
        children = [(f, 2, getattr(node, f)) for f in node._fields]
    elif isinstance(node, (list, tuple)):
        children = [(str(i), 1, v) for i, v in enumerate(node)]
    else:
        out.append((keys, node))
        return
    if not children and keys:
        out.append((keys, node))
    for key, kind, child in children:
        _leaves(child, keys + ((key, kind),), out)


def named_arrays(tree) -> Dict[str, Any]:
    """``{zarr name: leaf}`` of every array leaf of ``tree`` (a tree
    :func:`save` takes or :func:`restore` gives), named as orbax names
    them: ``".".join(keys)``."""
    leaves: List = []
    _leaves(tree, (), leaves)
    return {".".join(k for k, _ in keys): v for keys, v in leaves
            if not (v is None or isinstance(v, (dict, list, tuple)))}


def _empty_type(node) -> str:
    if node is None or _is_namedtuple(node):
        return "None"     # orbax's type for None and an empty NamedTuple
    return {dict: "Dict", list: "List", tuple: "Tuple"}[type(node)]


def _write(tmp: str, tree: Dict[str, Any], t0: int) -> None:
    """Every file of the checkpoint of ``tree``, written into ``tmp``."""
    store = OcdbtWriter(tmp)
    entries: Dict[str, Any] = {}
    sharding: Dict[str, str] = {}
    leaves: List = []
    _leaves(tree, (), leaves)
    for keys, value in leaves:
        key_meta = [{"key": k, "key_type": t} for k, t in keys]
        name = ".".join(k for k, _ in keys)
        if value is None or isinstance(value, (dict, list, tuple)):
            meta = {"value_type": _empty_type(value), "skip_deserialize": True}
        elif isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            meta = {"value_type": "jax.Array", "skip_deserialize": False,
                    "write_shape": list(value.shape)}
            sharding[base64.b64encode(name.encode()).decode()] = _HOST_SHARDING
            if value.dtype != torch.bfloat16:
                value = value.numpy()
        elif isinstance(value, (np.ndarray, np.generic, bool, int, float)):
            meta = {"value_type": "np.ndarray", "skip_deserialize": False}
            value = np.asarray(value)
        else:
            raise OrbaxError(f"{name}: a leaf of type {type(value).__name__} is not written")
        if not meta["skip_deserialize"]:
            try:
                zarr.write_array(store.put, name, value)
            except zarr.ZarrError as e:
                raise OrbaxError(str(e)) from None
        entries[str(tuple(k for k, _ in keys))] = {"key_metadata": key_meta,
                                                    "value_metadata": meta}
    store.commit()
    with open(os.path.join(tmp, METADATA_FILE), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    if sharding:
        with open(os.path.join(tmp, SHARDING_FILE), "w") as f:
            json.dump(sharding, f, separators=(",", ":"))
    with open(os.path.join(tmp, CHECKPOINT_METADATA_FILE), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def save(path: str, tree: Dict[str, Any]) -> str:
    """Write ``tree`` (a dict of dicts, NamedTuples, lists and tuples whose
    leaves are tensors, numpy arrays or numbers) as an orbax checkpoint in
    directory ``path``, under a temporary name first and then renamed into
    place over whatever ``path`` held. Returns the absolute path."""
    path = os.path.abspath(path)
    if not isinstance(tree, dict):
        raise OrbaxError("an orbax checkpoint's tree is a dict")
    t0 = time.time_ns()
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        _write(tmp, tree, t0)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path
