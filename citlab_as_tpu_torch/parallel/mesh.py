"""Device mesh and data-parallel helpers (port of
``citlab_as_tpu/parallel/mesh.py``).

The JAX package places a batch on a ``jax.sharding.Mesh`` and lets GSPMD
derive the per-chip programs. PyTorch has no such compiler, so the port's
mesh is an explicit grid of ``torch.device`` s, and data parallelism is
explicit too: :func:`shard_batch` splits the leading axis into one tensor
per data shard on that shard's device, :func:`replicate` gives one copy of
a module or state dict per shard, and the callers run each shard on its own
device (``inference.py::ShardedSegmentationPredictor``, the pipelined
workflow's ``mesh``).

A device list may name one device more than once: each entry is a shard of
its own, so a one-GPU machine (or the CPU) runs a multi-shard mesh, as the
JAX tests get eight CPU devices from ``--xla_force_host_platform_device_count``.
The ``model`` axis is kept for the JAX package's layout (``make_mesh`` builds
the same grid), but nothing here shards over it: its one use in JAX is
``spatial_sharding`` (the height-sharded ARU forward), which is not ported
(ROADMAP item 21): it is a GSPMD annotation, and in PyTorch it would need a
hand-written halo exchange at every ARU scale. So the data-parallel paths
refuse a mesh with ``model > 1`` rather than leave its devices idle.

``initialize_multihost`` brings up ``torch.distributed`` from torchrun's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""
from __future__ import annotations

import copy
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

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
        """The device of each data shard. A ``model`` axis above 1 raises
        ``NotImplementedError``: nothing shards over it (ROADMAP item 21)."""
        if self.shape["model"] > 1:
            raise NotImplementedError(
                f"citlab_as_tpu_torch: a mesh with model={self.shape['model']} would "
                "leave devices idle; the model axis serves spatial_sharding, which "
                "is not ported (ROADMAP item 21)")
        return list(self.devices[:, 0])

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


def replicate(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` per data shard, on the shard's device: an
    ``nn.Module`` is deep-copied (a repeated device gets a copy of its own,
    so shards never share parameters or buffers), a tensor or a dict /
    list / tuple of tensors is copied to each device. The copies are
    finished when it returns: they run on the devices' current streams, and
    the callers read the replicas from streams of their own."""
    out = []
    for dev in mesh.data_devices:
        if isinstance(tree, torch.nn.Module):
            out.append(copy.deepcopy(tree).to(dev))
        else:
            out.append(_map_tree(lambda x, dev=dev: torch.as_tensor(x).to(dev, copy=True),
                                 tree))
    if any(dev.type == "cuda" for dev in mesh.data_devices):
        for index in range(torch.cuda.device_count()):   # sources and targets
            torch.cuda.synchronize(index)
    return out


def data_parallel_jit(fn: Callable) -> Callable:
    """``fn`` over shards: the returned function takes per-shard lists (as
    :func:`replicate` and :func:`shard_batch` make them) for each argument
    and calls ``fn`` once per shard, under that shard's device, returning
    the list of results. (The JAX version is ``jax.jit``: placement there
    follows the data; here the caller holds one piece per device.)"""
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
