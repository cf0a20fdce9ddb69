"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). There is no silent CPU fallback: a
CUDA request on a machine without a CUDA device raises.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

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


def device_scope(device: torch.device, stream: Optional["torch.cuda.Stream"] = None):
    """The context that runs work on ``device``: the device current and,
    given one, ``stream`` the current stream; nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    scope = contextlib.ExitStack()
    scope.enter_context(torch.cuda.device(device))
    if stream is not None:
        scope.enter_context(torch.cuda.stream(stream))
    return scope
