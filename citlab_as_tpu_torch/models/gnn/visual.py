"""Visual features for the relation GNN, the 'v' nets (port of
``citlab_as_tpu/models/gnn/visual.py``).

A visual backbone (``inception_v3``, the default:
``models/inception_v3.py::InceptionV3``; ``ARU_cutted_v1``:
``models/arunet.py::ARUCutted``; ``ARU_v1``: the full ``ARUNet``) gives
multi-resolution feature maps; per region the map cells inside the
region's bounding box are max-pooled and compressed to 16 values per map;
the concatenated vector is appended to the node (or edge) features.

The JAX package leaves the masked max to XLA, which fuses the ``where`` into
the reduction. Eager PyTorch would build the [B, N, H, W, C] intermediate
(about 450 MB for 4 pages, 64 regions and a 96 x 96 x 48 map), so
:func:`region_max_pool` masks a chunk of regions at a time. A max is exact:
the result equals the JAX one bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: elements of one chunk's masked [B, n, H, W, C] intermediate
_POOL_CHUNK_ELEMENTS = 1 << 24


def normalize_visual_regions(visual_regions: torch.Tensor,
                             pad_image_height: int,
                             pad_image_width: int) -> torch.Tensor:
    """Region coords [B, N, 2, P] (row 0 = x, row 1 = y, absolute pixels of
    the true image) -> relative to the padded image's extent."""
    scale = torch.tensor([1.0 / pad_image_width, 1.0 / pad_image_height],
                         dtype=torch.float32, device=visual_regions.device)
    return visual_regions * scale[None, None, :, None]


def _bbox_from_regions(regions: torch.Tensor, num_points: torch.Tensor):
    """[B, N, 2, P] + valid point counts [B, N] -> (xmin, xmax, ymin, ymax)
    each [B, N], padded points masked."""
    p = regions.shape[-1]
    valid = torch.arange(p, device=regions.device)[None, None, :] < num_points[..., None]
    x, y = regions[:, :, 0, :], regions[:, :, 1, :]
    big = torch.tensor(1e9, dtype=torch.float32, device=regions.device)
    xmin = torch.where(valid, x, big).amin(dim=-1)
    xmax = torch.where(valid, x, -big).amax(dim=-1)
    ymin = torch.where(valid, y, big).amin(dim=-1)
    ymax = torch.where(valid, y, -big).amax(dim=-1)
    return xmin, xmax, ymin, ymax


def region_max_pool(feature_map: torch.Tensor, xmin, xmax, ymin, ymax) -> torch.Tensor:
    """Max of the feature-map cells inside each region's bbox.

    ``feature_map`` [B, H, W, C]; bounds [B, N] relative coords. The cell
    range is the reference's: floor(coord * dim) clipped to [0, dim - 1],
    inclusive, never empty. Returns [B, N, C]."""
    b, h, w, c = feature_map.shape
    fx0 = torch.clamp(torch.floor(xmin * w), 0, w - 1)
    fx1 = torch.maximum(torch.clamp(torch.floor(xmax * w), 0, w - 1), fx0)
    fy0 = torch.clamp(torch.floor(ymin * h), 0, h - 1)
    fy1 = torch.maximum(torch.clamp(torch.floor(ymax * h), 0, h - 1), fy0)
    cols = torch.arange(w, device=feature_map.device)[None, None, :]
    rows = torch.arange(h, device=feature_map.device)[None, None, :]
    col_mask = (cols >= fx0[..., None]) & (cols <= fx1[..., None])   # [B, N, W]
    row_mask = (rows >= fy0[..., None]) & (rows <= fy1[..., None])   # [B, N, H]
    neg = torch.tensor(-1e30, dtype=feature_map.dtype, device=feature_map.device)
    step = max(1, _POOL_CHUNK_ELEMENTS // max(1, b * h * w * c))
    out = []
    for s in range(0, col_mask.shape[1], step):
        masked = torch.where(col_mask[:, s:s + step, None, :, None],
                             feature_map[:, None], neg)              # [B, n, H, W, C]
        row_max = masked.amax(dim=3)                                 # [B, n, H, C]
        out.append(torch.where(row_mask[:, s:s + step, :, None], row_max, neg).amax(dim=2))
    return torch.cat(out, dim=1)


def _same_pads_strided(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _NHWCConv(nn.Module):
    """flax ``nn.Conv(padding="SAME")`` + ReLU on NHWC maps."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        (t, b), (l, r) = (_same_pads_strided(x.shape[1], self.kernel, self.stride),
                          _same_pads_strided(x.shape[2], self.kernel, self.stride))
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (l, r, t, b)), self.weight,
                     self.bias, stride=self.stride)
        return F.relu(y).permute(0, 2, 3, 1)


class MultiResolutionFeatureMaps(nn.Module):
    """SSD-style multi-resolution maps from backbone end points
    (feature_map_generators.py:72-197).

    ``from_layers[i]`` names an end point; ``layer_depths[i]`` == -1 passes
    it through, > 0 projects it with a 1x1 conv. An empty ``from_layers[i]``
    builds a new map from the previous one: a 1x1 conv to depth // 2
    (``insert_1x1_conv``) then a stride-2 3x3 conv. Every conv is
    ReLU-activated. ``channels`` gives the end points' widths."""

    def __init__(self, channels: Dict[str, int],
                 from_layers: Sequence[str] = ("Mixed_5d", "Mixed_6e", "Mixed_7c"),
                 layer_depths: Sequence[int] = (-1, -1, -1),
                 insert_1x1_conv: bool = True, min_depth: int = 16):
        super().__init__()
        self.steps = []
        self.out_channels: List[int] = []
        prev = None
        for i, (name, depth) in enumerate(zip(from_layers, layer_depths)):
            if name:
                prev = channels[name]
                if depth > 0:
                    setattr(self, f"proj_{i}_{name}", _NHWCConv(prev, max(depth, min_depth), 1))
                    prev = max(depth, min_depth)
                self.steps.append((name, depth > 0))
            else:
                if prev is None:
                    raise ValueError("empty from_layer needs a previous feature map")
                depth = max(depth, min_depth)
                if insert_1x1_conv:
                    setattr(self, f"reduce_{i}", _NHWCConv(prev, max(depth // 2, min_depth), 1))
                    prev = max(depth // 2, min_depth)
                setattr(self, f"down_{i}", _NHWCConv(prev, depth, 3, stride=2))
                prev = depth
                self.steps.append(("", insert_1x1_conv))
            self.out_channels.append(prev)

    def forward(self, end_points: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        maps: List[torch.Tensor] = []
        for i, (name, conv) in enumerate(self.steps):
            if name:
                fm = end_points[name]
                if conv:
                    fm = getattr(self, f"proj_{i}_{name}")(fm)
            else:
                fm = maps[-1]
                if conv:
                    fm = getattr(self, f"reduce_{i}")(fm)
                fm = getattr(self, f"down_{i}")(fm)
            maps.append(fm)
        return maps


class VisualFeatureExtractor(nn.Module):
    """Backbone end points -> per-region compressed visual features
    (graph_relation.py:84-172). Module names mirror the flax scopes:
    ``backbone``, ``feature_maps``, ``visual_{node,edge}_compress_fm_<i>``."""

    def __init__(self, backbone: str = "inception_v3",
                 from_layers: Sequence[str] = ("Mixed_5d", "Mixed_6e", "Mixed_7c"),
                 layer_depths: Sequence[int] = (-1, -1, -1),
                 layer_compressed_dims: Sequence[int] = (16, 16, 16),
                 nodes: bool = True, edges: bool = False):
        super().__init__()
        if backbone == "ARU_cutted_v1":
            from citlab_as_tpu_torch.models.arunet import ARUCutted
            self.backbone = ARUCutted()
        elif backbone == "ARU_v1":
            from citlab_as_tpu_torch.models.arunet import ARUNet
            self.backbone = ARUNet(n_classes=2)
        elif backbone == "inception_v3":
            from citlab_as_tpu_torch.models.inception_v3 import InceptionV3
            self.backbone = InceptionV3()
        else:
            raise ValueError(f"Unknown visual backbone '{backbone}'")
        self.backbone_name = backbone
        channels = {n: self.backbone.endpoint_channels(n) for n in from_layers if n}
        self.feature_maps = MultiResolutionFeatureMaps(channels, from_layers, layer_depths)
        self.scopes = [s for s, on in (("visual_node", nodes), ("visual_edge", edges)) if on]
        for scope in self.scopes:
            for i, (cin, dim) in enumerate(zip(self.feature_maps.out_channels,
                                               layer_compressed_dims)):
                setattr(self, f"{scope}_compress_fm_{i}", nn.Linear(cin, dim))
        self.out_dim = sum(layer_compressed_dims)

    def _end_points(self, image: torch.Tensor, train: bool) -> Dict[str, torch.Tensor]:
        if self.backbone_name == "inception_v3":
            return self.backbone(image, train)[1]
        if self.backbone_name == "ARU_cutted_v1":
            return self.backbone(image)[1]
        end_points: Dict[str, torch.Tensor] = {}
        self.backbone(image, end_points)
        return end_points

    def forward(self, image: torch.Tensor,
                visual_regions_nodes: Optional[torch.Tensor] = None,
                num_points_nodes: Optional[torch.Tensor] = None,
                visual_regions_edges: Optional[torch.Tensor] = None,
                num_points_edges: Optional[torch.Tensor] = None,
                train: bool = False):
        """``image`` [B, H, W, 1]; regions [B, N, 2, P] in absolute pixels of
        the padded image's frame. Returns (node_feats, edge_feats), each
        [B, N, out_dim] or None. ``train`` reaches the backbone as in the
        JAX package: the Inception v3 backbone refuses it."""
        feature_maps = self.feature_maps(self._end_points(image, train))
        pad_h, pad_w = image.shape[1], image.shape[2]

        def pooled(regions, num_points, scope):
            norm = normalize_visual_regions(regions, pad_h, pad_w)
            bounds = _bbox_from_regions(norm, num_points)
            feats = []
            for i, fm in enumerate(feature_maps):
                compress = getattr(self, f"{scope}_compress_fm_{i}")
                feats.append(F.relu(compress(region_max_pool(fm.float(), *bounds))))
            return torch.cat(feats, dim=-1)

        node_feats = edge_feats = None
        if visual_regions_nodes is not None and "visual_node" in self.scopes:
            node_feats = pooled(visual_regions_nodes, num_points_nodes, "visual_node")
        if visual_regions_edges is not None and "visual_edge" in self.scopes:
            edge_feats = pooled(visual_regions_edges, num_points_edges, "visual_edge")
        return node_feats, edge_feats
