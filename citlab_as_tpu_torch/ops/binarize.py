"""Gaussian blur + Otsu binarization (port of ``citlab_as_tpu/ops/binarize.py``).

cv2.GaussianBlur(5x5) then THRESH_BINARY+THRESH_OTSU: the Gaussian kernel
is cv2.getGaussianKernel's for the kernel size; Otsu maximizes the
between-class variance over the 256-bin histogram, with cv2's convention
(foreground = pixel > threshold).

Images are batched [B, H, W] with an explicit leading dimension. The blur,
the rounding, the histogram and the final comparison run on the tensor's
device. The threshold itself is chosen on the host, from the 256 counts, in
float32 with one fixed order of additions (:func:`otsu_threshold_from_hist`):
the class sums of a full page pass 2^24, where a float32 prefix sum depends
on the order in which it adds, and a near tie between two thresholds would
then fall differently on the CPU, on the card and in the JAX package. One
definition serves all three.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# cv2.getGaussianKernel with sigma<=0 uses these fixed binomial kernels for
# ksize 1/3/5/7 (small_gaussian_tab in OpenCV), not the sigma formula.
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125], np.float32),
}

# block length of the float32 prefix sums in :func:`otsu_threshold_from_hist`
_SCAN_BLOCK = 16


def _gaussian_kernel_1d(ksize: int) -> np.ndarray:
    if ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize]
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W] with replicate border, as shifted
    multiply-adds in float32, rows first, taps in ascending order. (The 3-,
    5- and 7-tap kernels are dyadic, so the blur of a uint8-valued page is
    exact in float32 whatever the order.)"""
    k = _gaussian_kernel_1d(ksize)
    img = image.to(torch.float32)
    h, w = img.shape[-2:]
    pad = ksize // 2
    x = F.pad(img[:, None], (0, 0, pad, pad), mode="replicate")[:, 0]
    acc = float(k[0]) * x[:, 0:h, :]
    for i in range(1, ksize):
        acc = acc + float(k[i]) * x[:, i:i + h, :]
    x = F.pad(acc[:, None], (pad, pad, 0, 0), mode="replicate")[:, 0]
    acc = float(k[0]) * x[:, :, 0:w]
    for i in range(1, ksize):
        acc = acc + float(k[i]) * x[:, :, i:i + w]
    return acc


def _blocked_cumsum_f32(x: np.ndarray) -> np.ndarray:
    """Float32 prefix sum of [..., 256] in the order the JAX package's
    ``jnp.cumsum`` takes on the CPU: a sequential scan inside blocks of 16,
    a sequential scan of the 16 block totals, and one addition of a block's
    offset to each of its elements."""
    blocks = x.astype(np.float32).reshape(x.shape[:-1] + (-1, _SCAN_BLOCK))
    inner = np.cumsum(blocks, axis=-1, dtype=np.float32)
    totals = np.cumsum(inner[..., -1], axis=-1, dtype=np.float32)
    offset = np.concatenate(
        [np.zeros_like(totals[..., :1]), totals[..., :-1]], axis=-1)
    return (inner + offset[..., None]).reshape(x.shape)


def otsu_threshold_from_hist(hist: np.ndarray) -> np.ndarray:
    """[..., 256] pixel counts -> int64 thresholds [...]: argmax of the
    between-class variance, all in float32 (class 0 = pixels <= t)."""
    hist = np.asarray(hist).astype(np.float32)
    bins = np.arange(256, dtype=np.float32)
    total = hist.sum(axis=-1, keepdims=True, dtype=np.float32)
    w0 = _blocked_cumsum_f32(hist)
    sum0 = _blocked_cumsum_f32(hist * bins)
    sum_all = sum0[..., -1:]
    w1 = total - w0
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = np.where(w0 > 0, sum0 / w0, np.float32(0.0))
        mu1 = np.where(w1 > 0, (sum_all - sum0) / w1, np.float32(0.0))
    diff = mu0 - mu1
    between = w0 * w1 * (diff * diff)
    between = np.where((w0 > 0) & (w1 > 0), between, np.float32(-1.0))
    return np.argmax(between, axis=-1)


def otsu_threshold(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Otsu threshold of uint8-range images [B, H, W]. Returns (thresholds
    [B] float32, binary [B, H, W] uint8 in {0, 255}) on the image's device.
    One host round trip: the [B, 256] histogram goes down, the thresholds
    come back."""
    img = torch.clamp(torch.round(image.to(torch.float32)), 0, 255).to(torch.int64)
    b = img.shape[0]
    offsets = torch.arange(b, device=img.device)[:, None] * 256
    hist = torch.bincount((img.reshape(b, -1) + offsets).reshape(-1),
                          minlength=b * 256).reshape(b, 256)
    t = torch.from_numpy(otsu_threshold_from_hist(hist.cpu().numpy()))
    t = t.to(img.device)
    binary = torch.where(img > t[:, None, None], 255, 0).to(torch.uint8)
    return t.to(torch.float32), binary


def otsu_binarize(image: torch.Tensor, blur_ksize: int = 5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blur, then Otsu, of [B, H, W]."""
    return otsu_threshold(gaussian_blur(image, blur_ksize))


def otsu_binarize_host(image: np.ndarray, blur_ksize: int = 5):
    """Numpy/scipy version for one [H, W] page on the host (same kernels,
    same edge padding; the Otsu sums in float64)."""
    from scipy.ndimage import correlate1d

    k = _gaussian_kernel_1d(blur_ksize).astype(np.float32)
    img = np.asarray(image, np.float32)
    x = correlate1d(img, k, axis=0, mode="nearest")
    x = correlate1d(x, k, axis=1, mode="nearest")

    q = np.clip(np.round(x), 0, 255).astype(np.int32)
    hist = np.bincount(q.ravel(), minlength=256).astype(np.float64)
    bins = np.arange(256, dtype=np.float64)
    w0 = np.cumsum(hist)
    sum0 = np.cumsum(hist * bins)
    total, sum_all = w0[-1], sum0[-1]
    w1 = total - w0
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = np.where(w0 > 0, sum0 / w0, 0.0)
        mu1 = np.where(w1 > 0, (sum_all - sum0) / w1, 0.0)
    between = np.where((w0 > 0) & (w1 > 0), w0 * w1 * (mu0 - mu1) ** 2, -1.0)
    t = int(np.argmax(between))
    binary = np.where(q > t, 255, 0).astype(np.uint8)
    return float(t), binary
