"""Device mesh, data-parallel and row-sharded placement (port of
``citlab_as_tpu/parallel/mesh.py``).

The JAX package places arrays on a ``jax.sharding.Mesh`` and lets GSPMD
derive the per-chip programs. PyTorch has no such compiler, so the port's
mesh is an explicit grid of ``torch.device`` s, and the placements are
explicit too:

- ``data`` axis: :func:`shard_batch` splits the leading axis into one
  tensor per data row of the mesh, on the row's first device (where the
  JAX package's batch sharding, replicated over ``model``, also holds it);
  :func:`replicate` gives one copy of a module or state dict per row, and
  the callers run each row on its own device
  (``inference.py::ShardedSegmentationPredictor``, the pipelined
  workflow's ``mesh``).
- ``model`` axis: :func:`spatial_sharding` is the placement that splits an
  NHWC page's height over a row's model devices, and :func:`place_rows`
  applies it: one row range per device, boundaries on a multiple of the
  net's alignment (:func:`row_partition`). ``parallel/spatial.py`` runs
  the ARU-Net over such shards with explicit halo exchanges, which GSPMD
  inserts in JAX.
- gradients: :func:`reduce_gradients` sums one gradient dict per data
  shard and hands the sum to every shard (the all-reduce GSPMD inserts
  under ``jax.jit`` of a train step over a replicated state and a sharded
  batch); the data-parallel train steps of ``train/segmentation.py`` and
  ``train/trainer.py`` are built on it. One process drives every shard;
  a reduction across processes is not here.

A device list may name one device more than once: each entry is a shard of
its own, so a one-GPU machine (or the CPU) runs a multi-shard mesh, as the
JAX tests get eight CPU devices from ``--xla_force_host_platform_device_count``.

``initialize_multihost`` brings up ``torch.distributed`` from torchrun's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""
from __future__ import annotations

import copy
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

DeviceSpec = Union[str, torch.device]


class Mesh:
    """A (data, model) grid of ``torch.device`` s: ``devices`` is a numpy
    object array of that shape, ``shape`` maps the axis names to sizes, as
    ``jax.sharding.Mesh`` does."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a (data, model) grid, got {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard: its row's first device."""
        return list(self.devices[:, 0])

    def model_devices(self, row: int) -> List[torch.device]:
        """The devices of data row ``row``, over which a page's height is
        sharded."""
        return list(self.devices[row])

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, " \
               f"devices={[str(d) for d in self.devices.ravel()]})"


def _all_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "citlab_as_tpu_torch: make_mesh() takes every CUDA device, but none "
            "is available; pass devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence[DeviceSpec]] = None,
              data: Optional[int] = None, model: int = 1) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: every CUDA
    device). A device may appear more than once."""
    if devices is None:
        devices = _all_cuda_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data({data}) * model({model}) != devices({n})")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, model))


@dataclass(frozen=True)
class BatchSharding:
    """How :func:`shard_batch` places an array of ``ndim`` axes: axis
    ``batch_axis`` split evenly over the mesh's data shards."""
    mesh: Mesh
    ndim: int = 4
    batch_axis: int = 0

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.data_devices


def batch_sharding(mesh: Mesh, ndim: int = 4, batch_axis: int = 0) -> BatchSharding:
    """The placement that splits axis ``batch_axis`` over 'data'."""
    return BatchSharding(mesh, ndim, batch_axis)


@dataclass(frozen=True)
class SpatialSharding:
    """How :func:`place_rows` places an array of ``ndim`` axes: axis
    ``h_axis`` (the height of an NHWC page) split over the model devices of
    a data row."""
    mesh: Mesh
    ndim: int = 4
    h_axis: int = 1

    def devices(self, row: int = 0) -> List[torch.device]:
        return self.mesh.model_devices(row)


def spatial_sharding(mesh: Mesh, ndim: int = 4, h_axis: int = 1) -> SpatialSharding:
    """The placement that splits the height axis ``h_axis`` over 'model'
    (the JAX package's ``NamedSharding(mesh, P(None, 'model'))``)."""
    return SpatialSharding(mesh, ndim, h_axis)


def row_partition(height: int, shards: int, align: int) -> List[Tuple[int, int]]:
    """(start, stop) of each row shard of a page of ``height`` rows over at
    most ``shards`` devices. Every shard starts on a multiple of ``align``
    and holds at least ``align`` rows; the ``height // align`` whole blocks
    spread as evenly as they go, the earlier shards taking one more, and
    the last shard takes the remainder too (1500 rows over 4 at 64:
    384 / 384 / 384 / 348). Under ``align * shards`` rows fewer shards hold
    rows (256 over 8 at 64: 4 of 64), under ``align`` one holds them all."""
    blocks = height // align
    k = max(1, min(shards, blocks))
    q, extra = divmod(blocks, k)
    sizes = [(q + (j < extra)) * align for j in range(k)]
    sizes[-1] += height - sum(sizes)
    bounds = np.cumsum([0] + sizes).tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def split_rows(x: torch.Tensor, devices: Sequence[torch.device], align: int,
               axis: int = 1) -> List[torch.Tensor]:
    """``x`` split along ``axis`` by :func:`row_partition` over ``devices``:
    one tensor per shard that holds rows, in page order, each on its device
    (a view of ``x`` where ``x`` is there already, else a ``non_blocking``
    copy)."""
    parts = row_partition(x.shape[axis], len(devices), align)
    logger.debug("split_rows: %d rows over %d of %d devices: %s", x.shape[axis],
                 len(parts), len(devices), [stop - start for start, stop in parts])
    return [x.narrow(axis, start, stop - start).to(dev, non_blocking=True)
            for (start, stop), dev in zip(parts, devices)]


def place_rows(sharding: SpatialSharding, x, align: int, row: int = 0
               ) -> List[torch.Tensor]:
    """``x`` placed with ``sharding`` over the model devices of data row
    ``row`` (:func:`split_rows` along its ``h_axis``)."""
    x = torch.as_tensor(x)
    if x.dim() != sharding.ndim:
        raise ValueError(f"place_rows: a {x.dim()}-axis array for a {sharding.ndim}-axis "
                         "sharding")
    return split_rows(x, sharding.devices(row), align, sharding.h_axis)


def _map_tree(fn: Callable[[Any], Any], tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh: Mesh, batch, batch_axis: int = 0) -> list:
    """Split every array of ``batch`` (a tensor, a numpy array, or a dict /
    list / tuple of them) evenly along ``batch_axis`` into one piece per
    data shard, each on its shard's device. Returns the list of per-shard
    trees, in shard order. The axis must divide evenly, as in JAX."""
    devices = mesh.data_devices
    n = len(devices)
    for leaf in _leaves(batch):
        if leaf.shape[batch_axis] % n:
            raise ValueError(f"batch axis of size {leaf.shape[batch_axis]} does "
                             f"not split over {n} data shards")

    def piece(i):
        dev = devices[i]

        def take(x):
            x = torch.as_tensor(x)
            size = x.shape[batch_axis] // n
            return x.narrow(batch_axis, i * size, size).to(dev)
        return _map_tree(take, batch)
    return [piece(i) for i in range(n)]


def replicate(mesh: Mesh, tree, over_model: bool = False) -> list:
    """One copy of ``tree`` per data row, on the row's first device; with
    ``over_model`` a dict per row instead, with one copy on each distinct
    device of the row (the replicas a row-sharded forward runs on). An
    ``nn.Module`` is deep-copied (a device repeated across rows gets a copy
    for each, so rows never share parameters or buffers), a tensor or a
    dict / list / tuple of tensors is copied to each device. The copies are
    finished when it returns: they run on the devices' current streams, and
    the callers read the replicas from streams of their own."""
    def one(dev):
        if isinstance(tree, torch.nn.Module):
            return copy.deepcopy(tree).to(dev)
        return _map_tree(lambda x: torch.as_tensor(x).to(dev, copy=True), tree)

    if over_model:
        out = [{dev: one(dev) for dev in dict.fromkeys(mesh.model_devices(i))}
               for i in range(mesh.shape["data"])]
    else:
        out = [one(dev) for dev in mesh.data_devices]
    if any(dev.type == "cuda" for dev in mesh.devices.ravel()):
        for index in range(torch.cuda.device_count()):   # sources and targets
            torch.cuda.synchronize(index)
    return out


def data_parallel_jit(fn: Callable) -> Callable:
    """``fn`` over shards: the returned function takes per-shard lists (as
    :func:`replicate` and :func:`shard_batch` make them) for each argument
    and calls ``fn`` once per shard, under that shard's device, returning
    the list of results. It reduces nothing across shards: ``jax.jit`` of a
    train step over a replicated state and a sharded batch computes the
    whole batch's loss and one gradient, all-reduced over the mesh, where
    this gives each shard its own. The data-parallel train steps are
    ``train/segmentation.py::make_sharded_train_step`` and
    ``train/trainer.py::TrainerGNN._make_sharded_train_step``, which sum
    the shards' gradients with :func:`reduce_gradients`."""
    def run(*shard_args):
        n = len(shard_args[0])
        outs = []
        for i in range(n):
            args = [a[i] for a in shard_args]
            dev = next((leaf.device for a in args for leaf in _leaves(a)
                        if isinstance(leaf, torch.Tensor)), torch.device("cpu"))
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(fn(*args))
            else:
                outs.append(fn(*args))
        return outs
    return run


def sum_on_first(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """``values`` (one tensor per data shard, each on its shard's device)
    summed in shard order on the first data device: the same sum, bit for
    bit, whichever devices the shards name."""
    first = mesh.data_devices[0]
    total = values[0].to(first)
    for v in values[1:]:
        total = total + v.to(first)
    return total


def reduce_gradients(mesh: Mesh, grads: Sequence[Dict[str, Optional[torch.Tensor]]],
                     like: Sequence[Dict[str, torch.Tensor]]
                     ) -> List[Dict[str, torch.Tensor]]:
    """The sum over data shards of ``grads`` (one ``{name: gradient}`` dict
    per shard, on its shard's device), on every shard's device: what the
    all-reduce GSPMD inserts under ``jax.jit`` over a sharded batch gives.

    A shard's None gradient (a parameter its loss does not reach) is a
    zero, as ``jax.grad`` gives it; ``like`` (the shards' parameter dicts)
    gives a name that is None on every shard its zeros. Each dtype's
    gradients are flattened into one buffer per shard, the buffers summed
    in shard order on the first data device (:func:`sum_on_first`) and the
    sum copied back, so every shard gets the same bits whatever the
    devices. Shards that name the same device share the sum's tensors."""
    devices = mesh.data_devices
    if len(grads) != len(devices) or len(like) != len(devices):
        raise ValueError(f"{len(grads)} gradient dicts and {len(like)} parameter "
                         f"dicts for {len(devices)} data shards")
    names = list(like[0])
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devices]
    for dtype in dict.fromkeys(like[0][k].dtype for k in names):
        group = [k for k in names if like[0][k].dtype == dtype]
        flats = []
        for shard, shard_like in zip(grads, like):
            parts = []
            for k in group:
                g = shard.get(k)
                parts.append((torch.zeros_like(shard_like[k]) if g is None else g).reshape(-1))
            flats.append(torch.cat(parts))
        total = sum_on_first(mesh, flats)
        copies: Dict[torch.device, torch.Tensor] = {}
        for i, dev in enumerate(devices):
            if dev not in copies:
                copies[dev] = total.to(dev)
            parts = copies[dev].split([like[i][k].numel() for k in group])
            out[i].update({k: p.view_as(like[i][k]) for k, p in zip(group, parts)})
    return out


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` at
    ``coordinator_address`` ("host:port", else ``MASTER_ADDR`` and
    ``MASTER_PORT``), with ``num_processes`` (else ``WORLD_SIZE``, default 1)
    and ``process_id`` (else ``RANK``, default 0); ``nccl`` when a CUDA
    device is present, ``gloo`` on the CPU, unless ``backend`` names one.

    Returns False when no coordinator is configured (one process, the
    common case), True when the group is up; a second call is a no-op."""
    import torch.distributed as dist

    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    logger.info("torch.distributed up: %s, rank %d of %d", backend,
                int(process_id), int(num_processes))
    return True
