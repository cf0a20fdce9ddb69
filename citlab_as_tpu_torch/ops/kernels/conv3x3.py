"""K1: SAME 3x3 stride-1 conv, NHWC, + bias + optional ReLU.

Port of ``citlab_as_tpu/ops/pallas/conv3x3.py::conv3x3_mxu``. On a CUDA
tensor :func:`conv3x3` launches the hand-written kernel in
``csrc/conv3x3.cu`` (bf16: implicit GEMM on the tensor cores; f32: FMAs on
the CUDA cores; f32 accumulation, output in the input dtype); on a CPU
tensor it computes :func:`conv3x3_plain`, the same function in plain
PyTorch. There is no fallback from the kernel to the plain version on the
card.

The kernel reads its weights in the order :func:`pack_weights` gives them
(the counterpart of the TPU kernel's ``_pack_weights``, not a copy of it).
:func:`conv3x3` packs a weight tensor once and keeps the result until the
tensor changes or dies.

Under autograd (grad enabled and one of x, weight, bias requiring grad)
:func:`conv3x3` goes through :class:`Conv3x3Function`: the forward is the
same K1 launch (or plain version on the CPU), the backward computes dX and
dW with ``torch.nn.grad.conv2d_input`` / ``conv2d_weight`` (cuDNN on the
card: the JAX package has no backward kernel for K1 and trains through
XLA's convolution) and db as the sum over (B, H, W). Under ``no_grad`` and
in inference the Function is not entered.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from citlab_as_tpu_torch.ops.kernels import build

COUT_SUPPORTED = (8, 16, 32)
#: bf16 keeps all 9 * Cin * Cout weights and two halo tiles in one block's
#: shared memory; past this Cin they no longer fit
BF16_MAX_CIN = 112
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version does not count), from
#: whichever thread launches it
launches = 0
_launches_lock = threading.Lock()


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


def packed_layout(cin: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(cinp, row): the channels per pixel the kernel works on (Cin rounded
    up, the rest zeros) and the elements per packed weight row.

    bf16: one k step of the tensor-core product is 16 channels (8 when Cin
    is exactly 8), and a row is padded to an odd number of 16-byte pieces
    so that the 8 rows of an ``ldmatrix`` fall on distinct shared-memory
    banks. f32: chunks of 8 channels, no padding."""
    if dtype == torch.bfloat16:
        cinp = 8 if cin == 8 else -(-cin // 16) * 16
        return cinp, 8 * ((cinp // 8) | 1)
    cinp = -(-cin // 8) * 8
    return cinp, cinp


def pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, 3, 3]`` -> ``[9, Cout, row]`` with
    ``packed[ky * 3 + kx, co, ci] = weight[co, ci, ky, kx]`` and zeros from
    ``Cin`` on: per tap a Cout x K matrix with K contiguous, which is the
    B operand of ``mma.sync`` (``.col``) as ``ldmatrix`` reads it, and the
    exact image of the kernel's shared-memory copy."""
    cout, cin = weight.shape[:2]
    _, row = packed_layout(cin, weight.dtype)
    packed = weight.new_zeros((9, cout, row))
    packed[:, :, :cin] = weight.permute(2, 3, 0, 1).reshape(9, cout, cin)
    return packed


_packed: Dict[int, Tuple[weakref.ref, tuple, torch.Tensor]] = {}


def _packed_weights(weight: torch.Tensor) -> torch.Tensor:
    """:func:`pack_weights` of ``weight``, cached by the tensor's identity,
    storage, dtype and version (an in-place update repacks)."""
    key = (weight.data_ptr(), weight._version, weight.dtype, tuple(weight.shape))
    hit = _packed.get(id(weight))
    if hit is not None and hit[0]() is weight and hit[1] == key:
        return hit[2]
    ident = id(weight)
    packed = pack_weights(weight.detach())
    _packed[ident] = (weakref.ref(weight, lambda _: _packed.pop(ident, None)),
                      key, packed)
    return packed


@functools.cache
def _lib():
    lib = build.load("conv3x3")
    lib.citlab_conv3x3.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                   + [ctypes.c_void_p])
    lib.citlab_conv3x3.restype = ctypes.c_int
    return lib


class Conv3x3Function(torch.autograd.Function):
    """K1 with a backward: ReLU masks the incoming gradient by y > 0; dX and
    dW are the transposed convolutions of SAME padding 1 on NCHW views; db
    is the sum over (B, H, W)."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu):
        y = _conv3x3_forward(x, weight, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, weight, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        if gy.device.type == "cuda":
            with torch.cuda.device(gy.device):
                return Conv3x3Function._backward(ctx, gy)
        return Conv3x3Function._backward(ctx, gy)

    @staticmethod
    def _backward(ctx, gy):
        x, weight, y = ctx.saved_tensors
        if ctx.relu:
            gy = gy * (y > 0)
        gn = gy.permute(0, 3, 1, 2)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                (x.shape[0], x.shape[3], x.shape[1], x.shape[2]), weight, gn,
                padding=1).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), weight.shape,
                                             gn, padding=1)
        if ctx.needs_input_grad[2]:
            db = gy.sum(dim=(0, 1, 2))
        return dx, dw, db, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """K1 on a CUDA tensor, :func:`conv3x3_plain` on a CPU tensor; through
    :class:`Conv3x3Function` when autograd has to record it."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return Conv3x3Function.apply(x, weight, bias, relu)
    return _conv3x3_forward(x, weight, bias, relu)


def _conv3x3_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     relu: bool) -> torch.Tensor:
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
    if x.dtype == torch.bfloat16 and cin > BF16_MAX_CIN:
        raise ValueError(f"conv3x3: bf16 takes Cin <= {BF16_MAX_CIN}, got {cin}")
    if tuple(weight.shape) != (cout, cin, 3, 3) or tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3: weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not match Cin={cin}, Cout={cout}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"conv3x3: {name} is {t.dtype} on {t.device}, "
                             f"x is {x.dtype} on {x.device}")
    # the library sizes its grid for, and launches on, the current device:
    # make it x's (a caller on another GPU would launch into that one)
    with torch.cuda.device(x.device):
        x = x.contiguous()
        if x.data_ptr() % 16:           # the kernel copies 16-byte pieces
            x = x.clone()
        packed = _packed_weights(weight)
        bias = bias.contiguous()
        cinp, row = packed_layout(cin, x.dtype)
        y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = _lib()
        err = lib.citlab_conv3x3(x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                 y.data_ptr(), b, h, w, cin, cout, cinp,
                                 row * x.element_size(), int(relu), _DTYPES[x.dtype],
                                 stream)
    build.check(lib, err, "conv3x3")
    with _launches_lock:
        launches += 1
    return y
