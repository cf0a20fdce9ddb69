"""K1: SAME 3x3 stride-1 conv, NHWC, + bias + optional ReLU.

Port of ``citlab_as_tpu/ops/pallas/conv3x3.py::conv3x3_mxu``. On a CUDA
tensor :func:`conv3x3` launches the hand-written kernel in
``csrc/conv3x3.cu`` (f32 accumulation, output in the input dtype); on a CPU
tensor it computes :func:`conv3x3_plain`, the same function in plain
PyTorch. There is no fallback from the kernel to the plain version on the
card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from citlab_as_tpu_torch.ops.kernels import build

COUT_SUPPORTED = (8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version does not count)
launches = 0


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """``x`` [B, H, W, Cin] NHWC, ``weight`` [Cout, Cin, 3, 3] (OIHW),
    ``bias`` [Cout] -> [B, H, W, Cout] in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1)
    if bias is not None:
        y = y + bias[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1)


@functools.cache
def _fn():
    fn = build.load("conv3x3").citlab_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """K1 on a CUDA tensor, :func:`conv3x3_plain` on a CPU tensor."""
    global launches
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, relu)
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3: dtype {x.dtype} not in {list(_DTYPES)}")
    if cout not in COUT_SUPPORTED:
        raise ValueError(f"conv3x3: Cout={cout} not in {COUT_SUPPORTED}")
    if tuple(weight.shape) != (cout, cin, 3, 3) or tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3: weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not match Cin={cin}, Cout={cout}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"conv3x3: {name} is {t.dtype} on {t.device}, "
                             f"x is {x.dtype} on {x.device}")
    x = x.contiguous()
    weight = weight.contiguous()
    bias = bias.contiguous()
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                b, h, w, cin, cout, int(relu), _DTYPES[x.dtype], stream)
    build.check(err, "conv3x3")
    launches += 1
    return y
