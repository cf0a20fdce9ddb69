"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). There is no silent CPU fallback: a
CUDA request on a machine without a CUDA device raises.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Raises ``RuntimeError`` for a CUDA device when none is present. Also
    turns TF32 off for f32 convolutions and matmuls, so f32 runs compute
    in full f32 as the JAX reference does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "citlab_as_tpu_torch: a CUDA device was requested but none "
                "is available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_scope(device: torch.device, stream=None):
    """The context that runs work on ``device``: the device current and,
    given one, ``stream`` the current stream (a dict of streams: each its
    device's current stream, as :func:`row_streams` makes them for the
    devices of a mesh row); nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    scope = contextlib.ExitStack()
    # entering a stream makes its device current: the device comes last
    for s in (stream.values() if isinstance(stream, dict) else [stream]):
        if s is not None:
            scope.enter_context(torch.cuda.stream(s))
    scope.enter_context(torch.cuda.device(device))
    return scope


def row_streams(devices: Sequence[torch.device]) -> Dict[torch.device, "torch.cuda.Stream"]:
    """A new CUDA stream on each distinct CUDA device of ``devices``, each
    ordered after the work already queued on its device's current stream
    (the nets' weights were copied there)."""
    streams = {}
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            streams[dev] = torch.cuda.Stream(dev)
            streams[dev].wait_stream(torch.cuda.current_stream(dev))
    return streams
