"""Input pipeline for ARU-Net segmentation training (port of
``citlab_as_tpu/train/seg_input_pipeline.py``).

Consumes the GT layout written by the generators (grayscale image copy +
C3/<name>_GT{i}.png channel masks + info.txt): random crops with class
labels from the channel argmax, a random horizontal flip, a fixed crop
shape. The same ``random.Random`` and ``np.random.RandomState`` calls in
the same order as the JAX package, so the same seed gives the same crops
bit for bit. Images decode through the port's ``utils/io.py::load_image``.
"""
from __future__ import annotations

import os
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.utils.io import load_image


def find_gt_examples(gt_dir: str) -> List[Tuple[str, List[str]]]:
    """(grey image, [GT channel paths]) pairs from a generator output dir."""
    c3 = os.path.join(gt_dir, "C3")
    if not os.path.isdir(c3):
        raise FileNotFoundError(f"No C3 folder in {gt_dir}")
    by_base = {}
    for f in sorted(os.listdir(c3)):
        if "_GT" not in f:
            continue
        base = f.split("_GT")[0]
        by_base.setdefault(base, []).append(os.path.join(c3, f))
    out = []
    for base, channels in by_base.items():
        for ext in (".jpg", ".png", ".tif"):
            grey = os.path.join(gt_dir, base + ext)
            if os.path.exists(grey):
                out.append((grey, sorted(channels)))
                break
    return out


class SegmentationDataset:
    """Random-crop batches for segmentation training.

    Labels: argmax over GT channels (the trailing channel is 'other' =
    background, matching the generators' channel order)."""

    def __init__(self, examples: Sequence[Tuple[str, List[str]]],
                 crop_size: Tuple[int, int] = (512, 512),
                 augment: bool = True, seed: Optional[int] = None):
        self.examples = list(examples)
        self.crop_h, self.crop_w = crop_size
        self.augment = augment
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        self._cache = {}

    def _load(self, idx: int):
        if idx not in self._cache:
            grey_path, channel_paths = self.examples[idx]
            grey = load_image(grey_path, mode="L").astype(np.float32) / 255.0
            channels = np.stack(
                [np.asarray(load_image(p, mode="L")) for p in channel_paths],
                axis=-1)
            label = np.argmax(channels, axis=-1).astype(np.int32)
            # where no channel fires, fall back to the last ('other') class
            none_fired = channels.max(axis=-1) == 0
            label[none_fired] = channels.shape[-1] - 1
            self._cache[idx] = (grey, label)
        return self._cache[idx]

    def _random_crop(self, grey: np.ndarray, label: np.ndarray):
        h, w = grey.shape
        ch, cw = self.crop_h, self.crop_w
        img = np.zeros((ch, cw), np.float32)
        lab = np.full((ch, cw), -1, np.int32)  # -1 = padded, masked in loss
        y0 = self._rng.randint(0, max(0, h - ch)) if h > ch else 0
        x0 = self._rng.randint(0, max(0, w - cw)) if w > cw else 0
        crop_h = min(ch, h)
        crop_w = min(cw, w)
        img[:crop_h, :crop_w] = grey[y0:y0 + crop_h, x0:x0 + crop_w]
        lab[:crop_h, :crop_w] = label[y0:y0 + crop_h, x0:x0 + crop_w]
        if self.augment and self._rng.random() < 0.5:
            img = img[:, ::-1].copy()
            lab = lab[:, ::-1].copy()
        return img, lab

    def batches(self, batch_size: int, steps: int) -> Iterator[dict]:
        for _ in range(steps):
            imgs, labels = [], []
            for _ in range(batch_size):
                idx = self._rng.randrange(len(self.examples))
                grey, label = self._load(idx)
                img, lab = self._random_crop(grey, label)
                imgs.append(img)
                labels.append(lab)
            image = np.stack(imgs)[..., None]
            label = np.stack(labels)
            yield {"image": image,
                   "label": np.maximum(label, 0),
                   "mask": (label >= 0).astype(np.float32)}
