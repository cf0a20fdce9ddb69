"""The height-sharded ARU-Net forward (port of the JAX package's
``spatial_sharding`` path, ``citlab_as_tpu/parallel/mesh.py``).

In JAX a page placed with ``spatial_sharding`` runs the jitted forward
height-sharded over the mesh's ``model`` axis, and GSPMD inserts the halo
exchanges. Here they are explicit. A page's rows are split over the
devices of a mesh row (``mesh.py::split_rows``, boundaries on a multiple
of ``models/arunet.py::row_alignment``), and ``ARUNet.forward`` walks its
own modules over the shards (:class:`RowShards`):

- the pools, the upsampling sums, the softmax over the attention maps and
  the weighted sum run on each shard alone: with the boundaries aligned,
  their windows never cross one;
- before each conv and transposed conv the shards exchange the rows the
  layer needs (:func:`exchange_rows`: 1 above and 1 below for a 3 x 3
  conv, 1 above and 2 below for a 4 x 4 one, 1 above for the transposed
  convs' input); the layer runs on the rows with their neighbours' and
  keeps its own (``_Conv.rows``, ``_Deconv.rows``). A 3 x 3 conv of
  Cout 8 / 16 / 32 is K1 on every shard, on the concatenated rows: one
  more copy of its input per shard. At the page's edges the SAME zero
  padding stays;
- the input standardization (``mvn``) reduces each shard's sum and sum of
  squared deviations on the row's first device.

Every shard runs on its own device, on that device's current stream; the
rows a shard takes from a neighbour on another device are a
device-to-device copy, which PyTorch orders with CUDA events against both
devices' current streams. On one device a halo is a narrow of the
neighbour's rows, copied by the concatenation. The logits are gathered on
the row's first device in page order. Nothing falls back: a shard whose
copy or launch fails raises.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from citlab_as_tpu_torch.models.arunet import ARUNet, row_alignment, standardize
from citlab_as_tpu_torch.parallel.mesh import split_rows

Halo = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def exchange_rows(shards: Sequence[torch.Tensor], top: int, bottom: int,
                  axis: int = 1) -> List[Halo]:
    """(above, below) of each shard: the last ``top`` rows (along ``axis``)
    of the shard above and the first ``bottom`` rows of the shard below, on
    the receiving shard's device; None at the page's top and bottom edges
    and where ``top`` or ``bottom`` is 0. A neighbour with fewer rows than
    that raises."""
    def take(src: torch.Tensor, start: int, rows: int, dst: torch.Tensor):
        if src.shape[axis] < rows:
            raise ValueError(f"exchange_rows: a shard of {src.shape[axis]} rows cannot "
                             f"give {rows}")
        return src.narrow(axis, start, rows).to(dst.device, non_blocking=True)

    out = []
    for i, x in enumerate(shards):
        above = below = None
        if top and i > 0:
            prev = shards[i - 1]
            above = take(prev, prev.shape[axis] - top, top, x)
        if bottom and i + 1 < len(shards):
            below = take(shards[i + 1], 0, bottom, x)
        out.append((above, below))
    return out


def _indexed(device: torch.device) -> torch.device:
    """``device`` as a tensor on it names it (``cuda`` -> ``cuda:<current>``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Peers:
    """The parameters a layer of the walked net uses on each device: its
    own on the net's device (the cast ones under ``ARUNet.forward``'s
    ``functional_call``), else those of the same layer in the device's
    replica, cast to the layer's dtype once per forward."""

    def __init__(self, names: Dict[int, str], replicas: Dict[torch.device, Dict[str, nn.Module]]):
        self.names, self.replicas = names, replicas
        self.cast: Dict[Tuple[int, torch.dtype], Tuple[torch.Tensor, torch.Tensor]] = {}

    def params(self, layer: nn.Module, device: torch.device):
        if layer.weight.device == device:
            return layer.weight, layer.bias
        peer = self.replicas[device][self.names[id(layer)]]
        dtype = layer.weight.dtype
        if peer.weight.dtype == dtype:
            return peer.weight, peer.bias
        key = (id(peer), dtype)
        if key not in self.cast:
            self.cast[key] = (peer.weight.to(dtype), peer.bias.to(dtype))
        return self.cast[key]


class RowShards:
    """An NHWC activation of a height-sharded forward: ``parts[i]`` holds
    shard i's rows, in page order, on its device. ``models/arunet.py``
    runs its layers through :meth:`each`, :meth:`with_halo` and
    :meth:`standardized`."""

    def __init__(self, parts: Sequence[torch.Tensor], peers: _Peers):
        self.parts, self._peers = list(parts), peers

    def each(self, fn: Callable, *others: "RowShards") -> "RowShards":
        """``fn`` on each shard, with the same shard of each of ``others``."""
        return RowShards([fn(x, *(o.parts[i] for o in others))
                          for i, x in enumerate(self.parts)], self._peers)

    def with_halo(self, layer: nn.Module, top: int, bottom: int,
                  *others: "RowShards") -> "RowShards":
        """``layer.rows`` on each shard with ``top`` rows of the shard above
        and ``bottom`` of the shard below, and the layer's parameters on
        the shard's device."""
        out = []
        for i, (x, (above, below)) in enumerate(
                zip(self.parts, exchange_rows(self.parts, top, bottom))):
            weight, bias = self._peers.params(layer, x.device)
            out.append(layer.rows(x, weight, bias, *(o.parts[i] for o in others),
                                  above=above, below=below))
        return RowShards(out, self._peers)

    def standardized(self) -> "RowShards":
        """``per_image_standardization`` over all rows: each shard's sum and
        sum of squared deviations from its own mean, in float64, go to the
        first shard's device, which combines them (Chan's pairwise update)
        into the page's mean and std, and sends both back; each shard then
        applies ``arunet.standardize``, the JAX formula with its clamp."""
        dims = tuple(range(1, self.parts[0].dim()))
        first = self.parts[0].device
        counts = [math.prod(x.shape[1:]) for x in self.parts]
        sums, m2s = [], []
        for x, c in zip(self.parts, counts):
            x64 = x.to(torch.float64)
            s = x64.sum(dim=dims, keepdim=True)
            sums.append(s.to(first, non_blocking=True))
            m2s.append(((x64 - s / c) ** 2).sum(dim=dims, keepdim=True).to(
                first, non_blocking=True))
        n = sum(counts)
        mean = sum(sums) / n
        m2 = sum(m2 + c * (s / c - mean) ** 2 for s, m2, c in zip(sums, m2s, counts))
        stats = torch.stack([mean, torch.sqrt(m2 / n)])
        return RowShards([standardize(x, *stats.to(x.device, non_blocking=True), n)
                          for x in self.parts], self._peers)


class SpatialARU:
    """An ARU-Net over the devices of one mesh row, called like the net:
    NHWC input (on any device) -> float32 logits on ``devices[0]``, the
    forward run height-sharded (:class:`RowShards`).

    ``nets`` holds one replica per distinct device of ``devices``
    (``mesh.py::replicate(mesh, net, over_model=True)``); the replica on
    ``devices[0]`` is walked, the others lend each layer its parameters on
    their device. A device may repeat: its shards share its replica."""

    def __init__(self, nets: Dict[torch.device, ARUNet], devices: Sequence[torch.device]):
        self.devices = [_indexed(d) for d in devices]
        self.nets = {_indexed(d): net for d, net in nets.items()}
        self.net = self.nets[self.devices[0]]
        self.align = row_alignment(self.net.gp)
        self._names = {id(m): name for name, m in self.net.named_modules()}
        self._replicas = {dev: dict(net.named_modules()) for dev, net in self.nets.items()}

    def eval(self) -> "SpatialARU":
        for net in self.nets.values():
            net.eval()
        return self

    def shard(self, x: torch.Tensor) -> RowShards:
        """``x`` split into this row's shards."""
        return RowShards(split_rows(x, self.devices, self.align),
                         _Peers(self._names, self._replicas))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.net(self.shard(x)).parts
        return torch.cat([p.to(self.devices[0], non_blocking=True) for p in parts], dim=1)
