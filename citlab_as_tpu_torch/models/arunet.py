"""ARU-Net in PyTorch (port of ``citlab_as_tpu/models/arunet.py``).

Same architecture, same parameter tree (module names mirror the flax
scopes, see ``weights.arunet_state_dict_from_flax``), NHWC activations at
every public function, as the JAX code has them:

- detCNN: a residual U-Net, ``scale_space_num`` scales, 2x2 max pools
  down, stride-2 transposed convs up with skip concats;
- ARU: the shared detCNN also runs on 2x and 4x avg-pooled inputs, a
  shared attention CNN scores each scale, a per-pixel softmax over the
  scales weights the upsampled det maps;
- logits: a final 4x4 conv.

Border rules carried over from flax/XLA: SAME pads lo = (k-1)//2 (so the
even 4x4 convs pad (1, 2)); SAME max pools pad -inf and SAME avg pools
count the padded zeros; ``ConvTranspose(padding="SAME")`` does not flip
its kernel and pads as ``lax.conv_transpose`` (the converted weights are
stored flipped, ready for ``F.conv_transpose2d``); the all-ones transposed
conv upsample (``_upsample_sum``) sums channels and repeats the sum.

Every 3x3 conv with Cout in {8, 16, 32} and Cin >= 8 — where the JAX
package routes to its Pallas kernel when ``USE_MXU_CONV`` is on — goes
through K1 (``ops/kernels/conv3x3.py``); the rest are ``F.conv2d``.

``ARUCutted`` is the down-path-only extractor of the visual relation GNN
(featRoot 12, Cout 12 * 2^k: none of its convs is a K1 conv).

The forward also runs height-sharded (``parallel/spatial.py``): passed a
``RowShards`` in place of a tensor, every module walks the same code over
the page's row shards. :func:`_each` runs a layer without neighbours on
each shard; the convs and transposed convs take the rows they need from
the neighbouring shards (``RowShards.with_halo``) in place of their SAME
zero rows, and the input standardization reduces over all shards.
:func:`row_alignment` is the row multiple the shard boundaries fall on.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from citlab_as_tpu_torch.ops.kernels.conv3x3 import COUT_SUPPORTED, conv3x3

DEFAULT_GRAPH_PARAMS: Dict[str, Any] = {
    "graph": "ARU",          # U | RU | ARU
    "mvn": False,             # per-image standardization of inputs
    "featRoot": 8,
    "num_scales_att": 3,
    "scale_space_num": 5,
    "res_depth": 3,
    "filter_size": 3,
    "pool_size": 2,
    "activation_name": "relu",
}

_ACTIVATIONS = {"relu": F.relu, "elu": F.elu, "leaky": F.leaky_relu}


def per_image_standardization(image: torch.Tensor) -> torch.Tensor:
    """(x - mean) / adjusted_stddev per image of a batch [B, ...]. Mean and
    std are taken in float64 and rounded to x's dtype once, so that a
    row-sharded forward, which reduces the same sums in another order
    (``parallel/spatial.py``), finds the same values."""
    dims = tuple(range(1, image.dim()))
    x64 = image.to(torch.float64)
    return standardize(image, x64.mean(dim=dims, keepdim=True),
                       x64.std(dim=dims, keepdim=True, unbiased=False),
                       math.prod(image.shape[1:]))


def standardize(image: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                n: int) -> torch.Tensor:
    """(x - mean) / max(std, 1 / sqrt(n)), the JAX formula, with the float64
    ``mean`` and ``std`` rounded to x's dtype."""
    adjusted = torch.clamp(std, min=1.0 / math.sqrt(n))
    return (image - mean.to(image.dtype)) / adjusted.to(image.dtype)


def _standardized(x):
    """:func:`per_image_standardization` of a tensor or of row shards."""
    if isinstance(x, torch.Tensor):
        return per_image_standardization(x)
    return x.standardized()


def _each(fn, *xs):
    """``fn`` on tensors, or on each row shard of ``RowShards`` (``fn`` then
    takes the shards of the same rows, one from each argument)."""
    if isinstance(xs[0], torch.Tensor):
        return fn(*xs)
    return xs[0].each(fn, *xs[1:])


def _same_pads(k: int) -> Tuple[int, int]:
    return (k - 1) // 2, k - 1 - (k - 1) // 2


def _deconv_padding(k: int, s: int) -> int:
    """The ``F.conv_transpose2d`` padding of ``lax.conv_transpose(padding=
    "SAME")`` (see :class:`_Deconv`)."""
    pad_a = k - 1 if s > k - 1 else int(np.ceil((k + s - 2) / 2))
    return k - 1 - pad_a


def _deconv_halo(k: int, s: int) -> Tuple[int, int]:
    """(above, below): the input rows beyond its own that a stride-``s``
    transposed conv needs for the ``s`` output rows of each input row
    (``F.conv_transpose2d``: out[y] = sum_i in[i] w[y + padding - s i])."""
    padding = _deconv_padding(k, s)
    return (k - 1 - padding) // s, max(0, (padding - 1) // s + 1)


class _Conv(nn.Module):
    """SAME conv + bias + activation (flax ``_Conv``). ``weight`` is OIHW."""

    def __init__(self, cin: int, features: int, kernel: int,
                 act: Optional[str]):
        super().__init__()
        self.kernel, self.act = kernel, act
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.full((features,), 0.1))
        self.use_k1 = kernel == 3 and features in COUT_SUPPORTED and cin >= 8
        self.init_std = float(np.sqrt(2.0 / (kernel * kernel * cin + features)))

    def forward(self, x):
        if not isinstance(x, torch.Tensor):
            return x.with_halo(self, *_same_pads(self.kernel))
        return self.rows(x, self.weight, self.bias)

    def rows(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             above: Optional[torch.Tensor] = None,
             below: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The layer on the rows ``x``; ``above`` / ``below`` (row shards)
        are the neighbouring shards' rows that take the place of the SAME
        padding's zero rows, None at the page's edges. K1 runs on the rows
        with their neighbours' and its output is cropped back to ``x``'s."""
        n, top = x.shape[1], 0 if above is None else above.shape[1]
        if above is not None or below is not None:
            x = torch.cat([r for r in (above, x, below) if r is not None], dim=1)
        if self.use_k1:
            y = conv3x3(x, weight, bias, relu=self.act == "relu")
            if y.shape[1] != n:
                y = y[:, top:top + n]
            if self.act not in (None, "relu"):
                y = _ACTIVATIONS[self.act](y)
            return y
        lo, hi = _same_pads(self.kernel)
        pads = (lo, hi, 0 if above is not None else lo, 0 if below is not None else hi)
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), weight, bias)
        if self.act is not None:
            y = _ACTIVATIONS[self.act](y)
        return y.permute(0, 2, 3, 1)


class _ResBlock(nn.Module):
    """identity conv -> relu -> res_depth convs (last identity) -> +skip -> act."""

    def __init__(self, cin: int, features: int, res_depth: int,
                 filter_size: int, act: str):
        super().__init__()
        self.res_depth, self.act = res_depth, act
        self.conv1 = _Conv(cin, features, filter_size, None)
        for i in range(res_depth):
            setattr(self, f"convR_{i}", _Conv(
                features, features, filter_size,
                act if i < res_depth - 1 else None))

    def forward(self, x):
        x = self.conv1(x)
        orig = x
        x = _each(F.relu, x)
        if self.res_depth == 0:
            return x
        for i in range(self.res_depth):
            x = getattr(self, f"convR_{i}")(x)
        return _each(lambda a, b: _ACTIVATIONS[self.act](a + b), x, orig)


class _PlainBlock(nn.Module):
    """Two plain convs (U variant)."""

    def __init__(self, cin: int, features: int, filter_size: int, act: str):
        super().__init__()
        self.conv1 = _Conv(cin, features, filter_size, act)
        self.conv2 = _Conv(features, features, filter_size, act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class _Deconv(nn.Module):
    """Stride-s transposed conv + bias + act, cropped to ``target``: an
    (h, w), or the skip tensor whose (h, w) it is (row shards: each
    shard's).

    ``weight`` is [Cin, Cout, k, k] holding the flax HWIO kernel spatially
    flipped: then ``F.conv_transpose2d`` with padding k-1-pad_a computes
    ``lax.conv_transpose(padding="SAME")`` (zero insertion, pads
    (pad_a, pad_b), correlation with the unflipped kernel) from its first
    output onward."""

    def __init__(self, cin: int, features: int, filter_size: int,
                 stride: int, act: str):
        super().__init__()
        self.stride, self.act = stride, act
        k, s = filter_size, stride
        self.padding = _deconv_padding(k, s)
        self.halo = _deconv_halo(k, s)
        self.weight = nn.Parameter(torch.empty(cin, features, k, k))
        self.bias = nn.Parameter(torch.full((features,), 0.1))
        self.init_std = float(np.sqrt(2.0 / (k * k * features + cin)))

    def forward(self, x, target):
        if not isinstance(x, torch.Tensor):
            return x.with_halo(self, *self.halo, target)
        return self.rows(x, self.weight, self.bias, target)

    def rows(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             target, above: Optional[torch.Tensor] = None,
             below: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The layer on the rows ``x`` (``above`` / ``below`` as
        ``_Conv.rows``): the output of ``above``'s rows is cropped away."""
        h, w = target.shape[1:3] if isinstance(target, torch.Tensor) else target
        top = 0 if above is None else above.shape[1]
        if above is not None or below is not None:
            x = torch.cat([r for r in (above, x, below) if r is not None], dim=1)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias,
                               stride=self.stride, padding=self.padding)
        y0 = self.stride * top
        y = y[:, :, y0:y0 + h, :w]
        return _ACTIVATIONS[self.act](y).permute(0, 2, 3, 1)


def _same_pool_pads(n: int, k: int) -> Tuple[int, int]:
    total = max((-(-n // k) - 1) * k + k - n, 0)
    return total // 2, total - total // 2


def _pool(x: torch.Tensor, k: int, pool, pad_value: float) -> torch.Tensor:
    (t, b), (l, r) = (_same_pool_pads(x.shape[1], k),
                      _same_pool_pads(x.shape[2], k))
    y = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), value=pad_value)
    return pool(y, k, k).permute(0, 2, 3, 1)


def _max_pool(x, k: int):
    """SAME max pool: padding never wins (-inf)."""
    return _pool(x, k, F.max_pool2d, -math.inf)


def _avg_pool(x, k: int):
    """SAME avg pool counting padded zeros (flax ``count_include_pad``)."""
    return _pool(x, k, F.avg_pool2d, 0.0)


def _upsample_sum(x: torch.Tensor, up: int, out_hw: Tuple[int, int],
                  out_channels: int) -> torch.Tensor:
    """conv2d_transpose with an all-ones [up, up, C, C] filter: sum input
    channels, repeat the sum up x up, crop to ``out_hw``, broadcast to
    ``out_channels``."""
    summed = torch.sum(x, dim=-1, keepdim=True)
    y = summed.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2)
    y = y[:, :out_hw[0], :out_hw[1], :]
    return y.expand(y.shape[:3] + (out_channels,))


class _DetCNN(nn.Module):
    """Residual U-Net; returns the featRoot-channel map."""

    def __init__(self, gp: Dict[str, Any], cin: int = 1):
        super().__init__()
        self.n_scales, self.pool = gp["scale_space_num"], gp["pool_size"]
        act, fs = gp["activation_name"], gp["filter_size"]
        use_residual = "RU" in gp["graph"]

        def block(cin_, feat_):
            if use_residual:
                return _ResBlock(cin_, feat_, gp["res_depth"], fs, act)
            return _PlainBlock(cin_, feat_, fs, act)

        feats, feat, ch = [], gp["featRoot"], cin
        for layer in range(self.n_scales):
            setattr(self, f"unet_down_{layer}", block(ch, feat))
            feats.append(feat)
            ch = feat
            feat *= self.pool
        for layer in range(self.n_scales - 2, -1, -1):
            setattr(self, f"unet_up_{layer}_deconv",
                    _Deconv(ch, feats[layer], fs, self.pool, act))
            setattr(self, f"unet_up_{layer}", block(2 * feats[layer], feats[layer]))
            ch = feats[layer]

    def forward(self, x, end_points: Optional[Dict[str, torch.Tensor]] = None,
                sc: int = 0):
        """``end_points`` (optional) collects the activations under the JAX
        package's names (``scale_<sc>_unet_down_<layer>_conv`` ...)."""
        skips = []
        for layer in range(self.n_scales):
            x = getattr(self, f"unet_down_{layer}")(x)
            if end_points is not None:
                end_points[f"scale_{sc}_unet_down_{layer}_conv"] = x
            skips.append(x)
            if layer < self.n_scales - 1:
                x = _each(lambda t: _max_pool(t, self.pool), x)
                if end_points is not None:
                    end_points[f"scale_{sc}_unet_down_{layer}_maxpool"] = x
        for layer in range(self.n_scales - 2, -1, -1):
            skip = skips[layer]
            deconv = getattr(self, f"unet_up_{layer}_deconv")(x, skip)
            if end_points is not None:
                end_points[f"scale_{sc}_unet_up_{layer}_deconv"] = deconv
            x = _each(lambda a, b: torch.cat([a, b], dim=3), skip, deconv)
            x = getattr(self, f"unet_up_{layer}")(x)
            if end_points is not None:
                end_points[f"scale_{sc}_unet_up_{layer}_conv"] = x
        return x


class _AttCNN(nn.Module):
    """4x [4x4 conv + 2x2 pool] down to a 1-channel score map at 1/8."""

    def __init__(self, gp: Dict[str, Any]):
        super().__init__()
        act = gp["activation_name"]
        self.conv1 = _Conv(1, 12, 4, act)
        self.conv2 = _Conv(12, 16, 4, act)
        self.conv3 = _Conv(16, 32, 4, act)
        self.conv4 = _Conv(32, 1, 4, act)

    def forward(self, x):
        for conv in (self.conv1, self.conv2, self.conv3):
            x = _each(lambda t: _max_pool(t, 2), conv(x))
        return self.conv4(x)


def init_convs(module: nn.Module, seed: int = 0) -> nn.Module:
    """Normal(0, sqrt(2 / (kh*kw*cin + cout))) kernels and 0.1 biases for
    every conv and transposed conv of ``module`` (the flax initializers),
    drawn from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (_Conv, _Deconv)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * m.init_std)
                m.bias.fill_(0.1)
    return module


class ARUNet(nn.Module):
    """ARU / RU / U pixel labeler. Call with NHWC input in [0, 1]; returns
    float32 logits [B, H, W, n_classes].

    Compute runs in the parameters' dtype (inference: ``model.to(
    torch.bfloat16)``) unless ``compute_dtype`` is set and differs from it.
    Then each forward casts every parameter to ``compute_dtype`` once
    (``torch.func.functional_call``) and computes in it; the gradients land
    in the parameters' dtype. That is the counterpart of the JAX package's
    ``ARUNet(dtype=bfloat16)`` with float32 params, which the segmentation
    trainer uses: flax casts each kernel at use. One cast per forward, not
    per conv, serves the three scales of the shared detCNN, so K1 packs
    each of its 23 weights once per forward."""

    def __init__(self, n_classes: int = 2,
                 graph_params: Optional[Dict[str, Any]] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        gp = dict(DEFAULT_GRAPH_PARAMS)
        if graph_params:
            gp.update(graph_params)
        self.gp = gp
        self.compute_dtype = compute_dtype
        self.featMapG = _DetCNN(gp)
        self.use_attention = "ARU" in gp["graph"]
        if self.use_attention:
            self.attMapG = _AttCNN(gp)
        self.logit = _Conv(gp["featRoot"], n_classes, 4, None)

    def init_random(self, seed: int = 0) -> "ARUNet":
        """The flax initializers from a seeded generator (:func:`init_convs`)."""
        return init_convs(self, seed)

    def endpoint_channels(self, name: str) -> int:
        """Channels of the end point ``scale_<sc>_unet_down_<layer>_conv``
        (the ones the visual GNN reads)."""
        layer = int(name.split("_unet_down_")[1].split("_")[0])
        return self.gp["featRoot"] * self.gp["pool_size"] ** layer

    def forward(self, inputs: torch.Tensor,
                end_points: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """``end_points`` (optional) collects the detCNN's activations of
        every scale under the JAX package's names. ``inputs`` may be a
        ``parallel/spatial.py::RowShards``; the logits are then row shards
        too."""
        dtype = self.logit.weight.dtype
        if self.compute_dtype is not None and self.compute_dtype != dtype:
            cast = {name: p.to(self.compute_dtype)
                    for name, p in self.named_parameters()}
            return torch.func.functional_call(self, cast, (inputs, end_points))
        gp = self.gp
        x = _each(lambda t: t.to(dtype), inputs)
        if gp["mvn"]:
            x = _standardized(x)
        fmap = self.featMapG(x, end_points, 0)
        if self.use_attention:
            n_att = gp["num_scales_att"]
            inp_scale = [x]
            for _ in range(1, n_att):
                inp_scale.append(_each(lambda t: _avg_pool(t, 2), inp_scale[-1]))

            def upsampled(y, up, channels):
                # to the page's (h, w), or to each row shard's
                return _each(lambda a, ref: _upsample_sum(a, up, ref.shape[1:3], channels),
                             y, x)
            out_att = [upsampled(self.attMapG(inp_scale[sc]), 8 * 2 ** sc, 1)
                       for sc in range(n_att)]
            out_det = [fmap] + [
                upsampled(self.featMapG(inp_scale[sc], end_points, sc), 2 ** sc,
                          gp["featRoot"]) for sc in range(1, n_att)]

            def weighted(*maps):
                att_w = torch.softmax(torch.cat(maps[:n_att], dim=3), dim=3)
                det = maps[n_att:]
                out = det[0] * att_w[..., 0:1]
                for sc in range(1, n_att):
                    out = out + det[sc] * att_w[..., sc:sc + 1]
                return out
            fmap = _each(weighted, *out_att, *out_det)
        return _each(lambda t: t.to(torch.float32), self.logit(fmap))

    def predict(self, inputs: torch.Tensor) -> torch.Tensor:
        """Probability maps [B, H, W, n_classes], float32: the softmax over
        the class axis of :meth:`forward`'s logits (the JAX package's
        ``ARUNet.predict``, the ``output:0`` contract)."""
        return torch.softmax(self(inputs), dim=-1)


def row_alignment(gp: Dict[str, Any]) -> int:
    """The row multiple ``A`` on which the shards of a height-sharded
    forward begin (``parallel/spatial.py``), from the graph parameters.

    Every shard but the last then holds a multiple of ``A`` rows, so each
    pool of every scale splits at the shards' boundaries (the SAME padding
    of an odd count falls at the page's bottom, in the last shard), and at
    every level each shard holds the rows its neighbours' convs need: one
    for a 3 x 3 conv and the transposed conv's input, two below for the
    4 x 4 convs (flax's SAME (1, 2)) of the logit and the attention net.
    2^(scale_space_num - 1 + num_scales_att - 1) for an ARU graph of 3
    input scales (64 for the committed nets), 2^(scale_space_num - 1) for a
    U or RU graph."""
    pool, fs = gp["pool_size"], gp["filter_size"]
    scales = 2 ** (gp["num_scales_att"] - 1) if "ARU" in gp["graph"] else 1
    deepest = scales * pool ** (gp["scale_space_num"] - 1)
    # (level, rows each shard has to hold at it)
    needs = [(deepest, max(fs // 2, *_deconv_halo(fs, pool))), (1, 2)]
    levels = [deepest]
    if "ARU" in gp["graph"]:
        levels.append(scales * 8)      # the attention net's three 2 x 2 pools
        needs.append((scales * 8, 2))  # and its last 4 x 4 conv there
    align = math.lcm(*levels)
    while any(align // level < rows for level, rows in needs):
        align *= 2
    return align


ARU_CUTTED_GRAPH_PARAMS: Dict[str, Any] = {
    "mvn": True,
    "featRoot": 12,
    "scale_space_num": 6,
    "res_depth": 0,
    "filter_size": 3,
    "pool_size": 2,
    "activation_name": "relu",
}


class ARUCutted(nn.Module):
    """Down-path-only ARU feature extractor (ARU_cutted_v1.py:7-73), the
    visual GNN's ``ARU_cutted_v1`` backbone: per scale one residual block
    then a 2x2 max pool, features doubling per scale; no attention, no up
    path. ``forward`` returns (deepest map, end points) with
    ``end_points['res_block_<i>']`` each scale's pre-pool activation."""

    def __init__(self, graph_params: Optional[Dict[str, Any]] = None, cin: int = 1):
        super().__init__()
        gp = dict(ARU_CUTTED_GRAPH_PARAMS)
        if graph_params:
            gp.update(graph_params)
        self.gp = gp
        feat, ch = gp["featRoot"], cin
        for layer in range(gp["scale_space_num"]):
            setattr(self, f"res_block_{layer}", _ResBlock(
                ch, feat, gp["res_depth"], gp["filter_size"], gp["activation_name"]))
            ch = feat
            feat *= gp["pool_size"]

    def init_random(self, seed: int = 0) -> "ARUCutted":
        """The flax initializers from a seeded generator (:func:`init_convs`)."""
        return init_convs(self, seed)

    def endpoint_channels(self, name: str) -> int:
        """Channels of the end point ``res_block_<i>``."""
        return self.gp["featRoot"] * self.gp["pool_size"] ** int(name.rsplit("_", 1)[1])

    def forward(self, x: torch.Tensor):
        gp = self.gp
        x = x.to(self.res_block_0.conv1.weight.dtype)
        if gp["mvn"]:
            x = per_image_standardization(x)
        end_points: Dict[str, torch.Tensor] = {}
        for layer in range(gp["scale_space_num"]):
            x = getattr(self, f"res_block_{layer}")(x)
            end_points[f"res_block_{layer}"] = x
            if layer < gp["scale_space_num"] - 1:
                x = _max_pool(x, gp["pool_size"])
        return x, end_points


def pad_to_multiple(image: torch.Tensor, multiple: int = 16):
    """Zero-pad H/W of an NHWC batch up to a multiple; returns the padded
    batch and the original (h, w)."""
    h, w = image.shape[1], image.shape[2]
    ph, pw = -h % multiple, -w % multiple
    if ph or pw:
        image = F.pad(image, (0, 0, 0, pw, 0, ph))
    return image, (h, w)
