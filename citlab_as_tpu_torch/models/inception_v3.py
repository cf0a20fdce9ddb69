"""Inception v3 backbone in PyTorch (port of
``citlab_as_tpu/models/inception_v3.py``; reference: article_separation/
backbones/Inception_v3.py:7-585).

The visual relation GNN's default backbone: the end points Mixed_5d /
Mixed_6e / Mixed_7c feed the multi-resolution feature maps whose
per-region max-pools become visual node (or edge) features
(``models/gnn/visual.py``). Standard Inception v3: conv + BatchNorm + ReLU
units, A / B / C blocks with the factorized 7x7 in B.

Input and end points are NHWC, as in the JAX package; inside, the maps are
NCHW for ``F.conv2d`` (the JAX package runs these convs through XLA,
outside any Pallas kernel), and each end point is an NHWC view of its map.
Module names mirror the flax scopes (``Mixed_5b.ConvUnit_3.Conv_0``,
``.BatchNorm_0``), so ``weights.py`` maps parameters and batch statistics
by path.

Every strided conv and max pool is ``VALID`` and every ``SAME`` conv has
stride 1 and an odd kernel, so a symmetric pad of ``k // 2`` is flax's
``SAME``. flax's ``avg_pool(padding="SAME")`` counts the pad, as
``count_include_pad=True`` does. BatchNorm: flax's ``momentum=0.9997`` is
torch's ``momentum=0.0003``, ``epsilon=1e-3``; the forward normalizes with
the running statistics (flax's ``use_running_average=True``). The JAX
package never makes ``batch_stats`` mutable, so its train mode raises;
``forward(train=True)`` raises here too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: flax's ``BatchNorm(momentum=0.9997, epsilon=1e-3)`` in torch's terms
BN_MOMENTUM, BN_EPS = 1.0 - 0.9997, 1e-3


class TrainModeUnsupported(ValueError):
    """Inception v3 has no train mode: its batch statistics are never
    updated (the JAX package raises flax's ``ModifyScopeVariableError``)."""


class ConvUnit(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU on NCHW maps."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: str = "SAME"):
        super().__init__()
        if padding == "SAME":
            if strides != (1, 1) or kernel[0] % 2 == 0 or kernel[1] % 2 == 0:
                raise ValueError("SAME is symmetric only for stride 1 and odd kernels")
            pad = (kernel[0] // 2, kernel[1] // 2)
        else:
            pad = (0, 0)
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride=strides, padding=pad,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm_0
        x = F.batch_norm(self.Conv_0(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """Numbers its units ``ConvUnit_<i>`` in construction order, as flax's
    compact modules name them in call order; a branch is a tuple of unit
    indices run one after another."""

    def _branch(self, *units) -> Tuple[int, ...]:
        first = sum(1 for _ in self.children())
        for i, (args, kwargs) in enumerate(units):
            setattr(self, f"ConvUnit_{first + i}", ConvUnit(*args, **kwargs))
        return tuple(range(first, first + len(units)))

    def _run(self, branch: Tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
        for i in branch:
            x = getattr(self, f"ConvUnit_{i}")(x)
        return x


def _u(cin, features, kernel, strides=(1, 1), padding="SAME"):
    return (cin, features, kernel), {"strides": strides, "padding": padding}


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1 = self._branch(_u(cin, 64, (1, 1)))
        self.b5 = self._branch(_u(cin, 48, (1, 1)), _u(48, 64, (5, 5)))
        self.b3 = self._branch(_u(cin, 64, (1, 1)), _u(64, 96, (3, 3)), _u(96, 96, (3, 3)))
        self.bp = self._branch(_u(cin, pool_features, (1, 1)))
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self._run(self.b1, x), self._run(self.b5, x),
                          self._run(self.b3, x), self._run(self.bp, _avg_pool_same(x))],
                         dim=1)


class ReductionA(_Block):
    def __init__(self, cin: int):
        super().__init__()
        self.b3 = self._branch(_u(cin, 384, (3, 3), (2, 2), "VALID"))
        self.bd = self._branch(_u(cin, 64, (1, 1)), _u(64, 96, (3, 3)),
                               _u(96, 96, (3, 3), (2, 2), "VALID"))
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([self._run(self.b3, x), self._run(self.bd, x),
                          _max_pool_valid(x)], dim=1)


class InceptionB(_Block):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.b1 = self._branch(_u(cin, 192, (1, 1)))
        self.b7 = self._branch(_u(cin, c7, (1, 1)), _u(c7, c7, (1, 7)), _u(c7, 192, (7, 1)))
        self.bd = self._branch(_u(cin, c7, (1, 1)), _u(c7, c7, (7, 1)), _u(c7, c7, (1, 7)),
                               _u(c7, c7, (7, 1)), _u(c7, 192, (1, 7)))
        self.bp = self._branch(_u(cin, 192, (1, 1)))
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([self._run(self.b1, x), self._run(self.b7, x),
                          self._run(self.bd, x), self._run(self.bp, _avg_pool_same(x))],
                         dim=1)


class ReductionB(_Block):
    def __init__(self, cin: int):
        super().__init__()
        self.b3 = self._branch(_u(cin, 192, (1, 1)), _u(192, 320, (3, 3), (2, 2), "VALID"))
        self.b7 = self._branch(_u(cin, 192, (1, 1)), _u(192, 192, (1, 7)),
                               _u(192, 192, (7, 1)), _u(192, 192, (3, 3), (2, 2), "VALID"))
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([self._run(self.b3, x), self._run(self.b7, x),
                          _max_pool_valid(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin: int):
        super().__init__()
        self.b1 = self._branch(_u(cin, 320, (1, 1)))
        self.b3 = self._branch(_u(cin, 384, (1, 1)))
        self.b3a = self._branch(_u(384, 384, (1, 3)))
        self.b3b = self._branch(_u(384, 384, (3, 1)))
        self.bd = self._branch(_u(cin, 448, (1, 1)), _u(448, 384, (3, 3)))
        self.bda = self._branch(_u(384, 384, (1, 3)))
        self.bdb = self._branch(_u(384, 384, (3, 1)))
        self.bp = self._branch(_u(cin, 192, (1, 1)))
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = self._run(self.b3, x)
        bd = self._run(self.bd, x)
        return torch.cat([self._run(self.b1, x), self._run(self.b3a, b3),
                          self._run(self.b3b, b3), self._run(self.bda, bd),
                          self._run(self.bdb, bd), self._run(self.bp, _avg_pool_same(x))],
                         dim=1)


#: the end points in order, with the block that makes each
_MIXED = (("Mixed_5b", "A32"), ("Mixed_5c", "A64"), ("Mixed_5d", "A64"),
          ("Mixed_6a", "RA"), ("Mixed_6b", "B128"), ("Mixed_6c", "B160"),
          ("Mixed_6d", "B160"), ("Mixed_6e", "B192"), ("Mixed_7a", "RB"),
          ("Mixed_7b", "C"), ("Mixed_7c", "C"))


class InceptionV3(nn.Module):
    """``forward(x)`` with NHWC ``x`` returns (final map, end points), both
    NHWC: Mixed_5b (256 channels), 5c-5d (288), Mixed_6a-6e (768),
    Mixed_7a (1280), 7b-7c (2048). ``cin`` is the input's channels (flax
    infers it; the visual GNN feeds one grey channel)."""

    def __init__(self, cin: int = 1):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvUnit(cin, 32, (3, 3), (2, 2), "VALID")
        self.Conv2d_2a_3x3 = ConvUnit(32, 32, (3, 3), padding="VALID")
        self.Conv2d_2b_3x3 = ConvUnit(32, 64, (3, 3))
        self.Conv2d_3b_1x1 = ConvUnit(64, 80, (1, 1), padding="VALID")
        self.Conv2d_4a_3x3 = ConvUnit(80, 192, (3, 3), padding="VALID")
        ch = 192
        self._channels: Dict[str, int] = {}
        for name, kind in _MIXED:
            if kind[0] == "A":
                block = InceptionA(ch, int(kind[1:]))
            elif kind[0] == "B":
                block = InceptionB(ch, int(kind[1:]))
            elif kind == "RA":
                block = ReductionA(ch)
            elif kind == "RB":
                block = ReductionB(ch)
            else:
                block = InceptionC(ch)
            setattr(self, name, block)
            ch = self._channels[name] = block.out_channels

    def endpoint_channels(self, name: str) -> int:
        """Channels of the end point ``name`` (``Mixed_5b`` ... ``Mixed_7c``)."""
        return self._channels[name]

    def init_random(self, seed: int = 0) -> "InceptionV3":
        """flax's initializers from a seeded generator: lecun-normal conv
        kernels (variance 1 / fan_in), BatchNorm scale 1, bias 0, mean 0,
        var 1."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, ConvUnit):
                    w = m.Conv_0.weight
                    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                    w.copy_(torch.randn(w.shape, generator=gen) * fan_in ** -0.5)
                    m.BatchNorm_0.reset_parameters()
        return self

    def forward(self, x: torch.Tensor, train: bool = False):
        if train:
            raise TrainModeUnsupported(
                "InceptionV3 has no train mode: its batch statistics are never "
                "mutable, as in the JAX package (flax raises ModifyScopeVariableError)")
        x = x.to(self.Conv2d_1a_3x3.Conv_0.weight.dtype).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_valid(x)
        x = _max_pool_valid(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        end_points: Dict[str, torch.Tensor] = {}
        for name, _ in _MIXED:
            x = getattr(self, name)(x)
            end_points[name] = x.permute(0, 2, 3, 1)
        return x.permute(0, 2, 3, 1), end_points
