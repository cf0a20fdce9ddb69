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
  ``train/trainer.py`` are built on it.

A device list may name one device more than once: each entry is a shard of
its own, so a one-GPU machine (or the CPU) runs a multi-shard mesh, as the
JAX tests get eight CPU devices from ``--xla_force_host_platform_device_count``.

Several processes: ``initialize_multihost`` brings up ``torch.distributed``
from torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) and pins the process to its cards (:func:`process_cards`,
:func:`local_devices`). In a group of more than one process
:func:`make_mesh` with no devices spans every process's cards, as the JAX
package's does over ``jax.devices()``: ``mesh.shape["data"]`` counts every
process's shards, and ``mesh.local_rows`` names the data rows this process
holds. :func:`shard_batch` and :func:`replicate` place this process's part
only, and :func:`sum_on_first` and :func:`reduce_gradients` gather every
process's shards (``torch.distributed.all_gather``) and sum them in global
shard order, so every process ends with the same bits as a one-process
mesh of as many shards. The inference paths drive every shard of their
mesh from one process and refuse a mesh that spans processes by name
(:func:`one_process`), where the JAX package fails to read back an array
that is not fully addressable.
"""
from __future__ import annotations

import copy
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from citlab_as_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

DeviceSpec = Union[str, torch.device]


class Mesh:
    """A (data, model) grid of ``torch.device`` s: ``devices`` is a numpy
    object array of that shape, ``shape`` maps the axis names to sizes, as
    ``jax.sharding.Mesh`` does.

    ``processes`` (same shape; default all 0) holds the rank of the process
    that drives each entry, and ``process_index`` is this process's rank;
    each data row belongs to one process. ``local_rows`` are the global
    indices of this process's data rows, and :attr:`data_devices` their
    first devices: the shards this process drives."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray, processes: Optional[np.ndarray] = None,
                 process_index: int = 0):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a (data, model) grid, got {devices.shape}")
        if processes is None:
            processes = np.zeros(devices.shape, np.int64)
        if processes.shape != devices.shape:
            raise ValueError(f"processes {processes.shape} for devices {devices.shape}")
        owners = processes[:, 0]
        if (processes != owners[:, None]).any() or (owners != np.sort(owners)).any() \
                or len(set(np.bincount(owners)) - {0}) > 1:
            raise ValueError(f"mesh rows of processes {processes.tolist()}: each process "
                             "must hold as many whole data rows, in rank order")
        self.devices = devices
        self.processes = processes
        self.process_index = process_index
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.local_rows: List[int] = [r for r in range(devices.shape[0])
                                      if processes[r, 0] == process_index]

    @property
    def process_count(self) -> int:
        """The number of processes whose shards the mesh holds."""
        return len(np.unique(self.processes))

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard this process drives: its row's
        first device, in global row order."""
        return [self.devices[r, 0] for r in self.local_rows]

    def model_devices(self, row: int) -> List[torch.device]:
        """The devices of data row ``row``, over which a page's height is
        sharded."""
        one_process(self, "the height-sharded forward (parallel/spatial.py::SpatialARU)")
        return list(self.devices[row])

    def __repr__(self) -> str:
        procs = (f", processes={self.processes[:, 0].tolist()}, process_index="
                 f"{self.process_index}" if self.spans_processes else "")
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, " \
               f"devices={[str(d) for d in self.devices.ravel()]}{procs})"


def one_process(mesh: Mesh, caller: str) -> Mesh:
    """``mesh``, refused by the name of ``caller`` where it spans processes:
    ``caller`` drives every shard of its mesh from this process."""
    if mesh.spans_processes:
        raise ValueError(
            f"{caller} runs every shard of its mesh in one process, and this mesh "
            f"spans {mesh.process_count} processes; give it a mesh of this process's "
            "devices (make_mesh(devices))")
    return mesh


def process_cards(env: Mapping[str, str], device_count: int) -> List[int]:
    """The indices of the CUDA cards a process drives: under torchrun with
    several processes on the host (``LOCAL_WORLD_SIZE`` > 1) card
    ``LOCAL_RANK`` alone, else every visible card."""
    local_world = int(env.get("LOCAL_WORLD_SIZE") or 1)
    if local_world > 1:
        rank = int(env.get("LOCAL_RANK") or 0)
        if not 0 <= rank < device_count:
            raise ValueError(f"LOCAL_RANK {rank} of {local_world} processes on this host, "
                             f"but {device_count} visible CUDA devices")
        return [rank]
    return list(range(device_count))


def local_devices() -> List[torch.device]:
    """This process's devices, as ``jax.local_devices()``: its cards
    (:func:`process_cards` over the environment), or the CPU where there is
    no card."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in process_cards(os.environ, torch.cuda.device_count())]


def _group() -> Tuple[int, int]:
    """(world size, rank) of the ``torch.distributed`` group; (1, 0)
    without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _all_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "citlab_as_tpu_torch: make_mesh() takes every CUDA device, but none "
            "is available; pass devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence[DeviceSpec]] = None,
              data: Optional[int] = None, model: int = 1, *,
              process_devices: Optional[Sequence[DeviceSpec]] = None) -> Mesh:
    """Build a (data, model) mesh over ``devices``, this process's alone. A
    device may appear more than once.

    With no devices: every CUDA device; in a ``torch.distributed`` group
    of more than one process, every process's cards (:func:`local_devices`)
    in rank order, as the JAX package's ``make_mesh()`` after
    ``initialize_multihost`` spans ``jax.devices()``. ``process_devices``
    names this process's entries of such a mesh, each process its own:
    ``make_mesh(process_devices=["cpu"] * k)`` in each of P processes is a
    mesh of P * k shards, the JAX package's ``make_mesh()`` in P processes
    started with ``--xla_force_host_platform_device_count=k``. Every process
    of the group makes such a mesh together (their device lists are
    gathered); each brings as many entries, and whole data rows."""
    if devices is not None and process_devices is not None:
        raise ValueError("make_mesh: pass devices or process_devices, not both")
    world, rank = _group()
    if devices is None and process_devices is None:
        cards = _all_cuda_devices()
        if world == 1:
            devices = cards
        else:
            process_devices = local_devices()
    # each of this process's devices as every entry point takes it (a card
    # that is there; TF32 off, so f32 steps compute in f32 as in JAX)
    names = [[str(resolve_device(d)) for d in (devices if devices is not None
                                               else process_devices)]]
    if devices is not None:
        rank = 0
    else:
        if world > 1:
            import torch.distributed as dist
            local, names = names[0], [None] * world
            dist.all_gather_object(names, local)
        if len({len(n) for n in names}) != 1:
            raise ValueError(f"make_mesh: the processes bring {[len(n) for n in names]} "
                             "devices; each must bring as many")
    n = sum(len(d) for d in names)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data({data}) * model({model}) != devices({n})")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in sum(names, [])]
    owners = np.repeat(np.arange(len(names)), [len(d) for d in names])
    return Mesh(arr.reshape(data, model), owners.reshape(data, model), rank)


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
    one_process(mesh, "the height-sharded forward (parallel/spatial.py::SpatialARU)")
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
    list / tuple of them) evenly along ``batch_axis`` over the mesh's data
    shards: global shard g takes ``[g * s, (g + 1) * s)``. Returns the
    pieces of this process's shards (``mesh.local_rows``), each on its
    shard's device, in shard order; every process passes the whole batch,
    as each passes it to ``jax.device_put`` in the JAX package. The axis
    must divide evenly, as in JAX."""
    n = mesh.shape["data"]
    for leaf in _leaves(batch):
        if leaf.shape[batch_axis] % n:
            raise ValueError(f"batch axis of size {leaf.shape[batch_axis]} does "
                             f"not split over {n} data shards")

    def piece(g, dev):
        def take(x):
            x = torch.as_tensor(x)
            size = x.shape[batch_axis] // n
            return x.narrow(batch_axis, g * size, size).to(dev)
        return _map_tree(take, batch)
    return [piece(g, dev) for g, dev in zip(mesh.local_rows, mesh.data_devices)]


def replicate(mesh: Mesh, tree, over_model: bool = False) -> list:
    """One copy of ``tree`` per data row of this process, on the row's first
    device (every process passes equal values, as to ``jax.device_put``;
    nothing is broadcast); with
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
    if any(dev.type == "cuda" for dev in mesh.devices[mesh.local_rows].ravel()):
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


def _every_shard(mesh: Mesh, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``values`` (one tensor per data shard of this process, of one shape
    and dtype) and, where the mesh spans processes, every other process's
    (one ``torch.distributed.all_gather`` of their bytes): one tensor per
    data shard of the mesh, in global shard order, on this process's first
    data device."""
    first = mesh.data_devices[0]
    local = [v.to(first) for v in values]
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist
    stacked = torch.stack(local)
    raw = stacked.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.process_count)]
    dist.all_gather(parts, raw)
    return [shard for part in parts
            for shard in part.view(stacked.dtype).view(stacked.shape).unbind(0)]


def sum_on_first(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """``values`` (one tensor per data shard of this process, each on its
    shard's device) summed over every shard of the mesh in global shard
    order on this process's first data device: the same sum, bit for bit,
    whichever devices and processes the shards name."""
    shards = _every_shard(mesh, values)
    total = shards[0]
    for v in shards[1:]:
        total = total + v
    return total


def reduce_gradients(mesh: Mesh, grads: Sequence[Dict[str, Optional[torch.Tensor]]],
                     like: Sequence[Dict[str, torch.Tensor]]
                     ) -> List[Dict[str, torch.Tensor]]:
    """The sum over data shards of ``grads`` (one ``{name: gradient}`` dict
    per shard of this process, on its shard's device), on every shard's
    device: what the all-reduce GSPMD inserts under ``jax.jit`` over a
    sharded batch gives.

    A shard's None gradient (a parameter its loss does not reach) is a
    zero, as ``jax.grad`` gives it; ``like`` (the shards' parameter dicts)
    gives a name that is None on every shard its zeros. Each dtype's
    gradients are flattened into one buffer per shard, the buffers of every
    shard of the mesh (gathered from the other processes where it spans
    several) summed in global shard order on this process's first data
    device (:func:`sum_on_first`) and the sum copied back, so every shard
    of every process gets the same bits whatever the devices. Shards that
    name the same device share the sum's tensors."""
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
    device is present, ``gloo`` on the CPU, unless ``backend`` names one
    (``gloo`` takes CUDA tensors too, and several processes on one card,
    which ``nccl`` refuses). The process is pinned to its first card
    (``torch.cuda.set_device``; :func:`process_cards`) as the group comes
    up, so ``"cuda"`` names card ``LOCAL_RANK`` in each of torchrun's
    processes on a host.

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
    if torch.cuda.is_available():
        torch.cuda.set_device(local_devices()[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    logger.info("torch.distributed up: %s, rank %d of %d, devices %s", backend,
                int(process_id), int(num_processes), local_devices())
    return True
