"""K2: fused separator-mask morphology.

Port of ``citlab_as_tpu/ops/pallas/separator_morphology.py::
fused_separator_masks``, batched: the CC-cleaned 0/255 pages [B, H, W] in,
the (horizontal, vertical) masks [B, H, W] out, in the input dtype (uint8
or float32; values are exactly 0 or 255, so every window min/max is exact
and the result is bit-identical to the float32 chain). On a CUDA tensor
:func:`separator_morphology` launches ``csrc/separator_morphology.cu``; on a
CPU tensor it computes :func:`separator_morphology_plain`. There is no
fallback from the kernel to the plain version on the card.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from citlab_as_tpu_torch.ops.kernels import build
from citlab_as_tpu_torch.ops.morphology import morph_open

_DTYPES = {torch.float32: 0, torch.uint8: 2}

#: launches of the CUDA kernel (the plain version does not count), from
#: whichever thread launches it
launches = 0
_launches_lock = threading.Lock()


def separator_morphology_plain(cleaned: torch.Tensor, h_kernel: int,
                               v_kernel: int, noise_kernel: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain of ``stages/separator.py::_separator_morphology_device``
    built from rect openings: horizontal open, vertical open, saturating
    subtract, noise open. Computed in float32, returned in the input dtype."""
    x = cleaned.to(torch.float32)
    horizontal = morph_open(x, h_kernel, 1)
    vertical = morph_open(x, 1, v_kernel)
    horizontal = torch.clamp(horizontal - vertical, 0, 255)
    horizontal = morph_open(horizontal, noise_kernel, 1)
    return horizontal.to(cleaned.dtype), vertical.to(cleaned.dtype)


@functools.cache
def _lib():
    lib = build.load("separator_morphology")
    fn = lib.citlab_separator_morphology
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def separator_morphology(cleaned: torch.Tensor, h_kernel: int, v_kernel: int,
                         noise_kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor, the plain chain on a CPU tensor. ``cleaned`` is
    [B, H, W] (or [H, W]) holding only 0 and 255."""
    global launches
    if cleaned.device.type == "cpu":
        return separator_morphology_plain(cleaned, h_kernel, v_kernel,
                                          noise_kernel)
    if cleaned.device.type != "cuda":
        raise ValueError(f"separator_morphology: unsupported device {cleaned.device}")
    if cleaned.dtype not in _DTYPES:
        raise TypeError(f"separator_morphology: dtype {cleaned.dtype} not in "
                        f"{list(_DTYPES)}")
    if cleaned.dim() not in (2, 3):
        raise ValueError(f"separator_morphology: expected [B, H, W] or [H, W], "
                         f"got {tuple(cleaned.shape)}")
    if min(h_kernel, v_kernel, noise_kernel) < 1:
        raise ValueError("separator_morphology: kernel sizes must be >= 1")
    # the library launches on the current device: make it the tensor's
    with torch.cuda.device(cleaned.device):
        x = cleaned.contiguous()
        batched = x if x.dim() == 3 else x[None]
        b, h, w = batched.shape
        horizontal = torch.empty_like(batched)
        vertical = torch.empty_like(batched)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = _lib()
        err = lib.citlab_separator_morphology(
            batched.data_ptr(), horizontal.data_ptr(), vertical.data_ptr(),
            b, h, w, int(h_kernel), int(v_kernel), int(noise_kernel),
            _DTYPES[x.dtype], stream)
    build.check(lib, err, "separator_morphology")
    with _launches_lock:
        launches += 1
    if x.dim() == 2:
        return horizontal[0], vertical[0]
    return horizontal, vertical
