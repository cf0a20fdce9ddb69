"""Geometric node-feature augmentation (port copy of
``citlab_as_tpu/train/augmentation.py``, numpy on the same
``RandomState`` draws; reference: gnn/input/
feature_augmentation.py:5-134). Feature indices are hard-wired to the 15-d
layout: region size (0, 1), region center (2, 3), baseline sizes/centers
(4..11), stroke width 12? — NOTE the reference's height index 15 assumes the
16-d external-feature layout; we keep its exact index arithmetic. Each
module (scaling / rotation / translation) applies with probability 0.5.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def augment_geometric_features(node_features: np.ndarray, config: Sequence[str],
                               rng: np.random.RandomState) -> np.ndarray:
    if "scaling" in config and rng.uniform(0, 1) < 0.5:
        node_features = scaling_noise(node_features, rng)
    if "rotation" in config and rng.uniform(0, 1) < 0.5:
        node_features = rotation_noise(node_features, rng)
    if "translation" in config and rng.uniform(0, 1) < 0.5:
        node_features = translation_noise(node_features, rng)
    return node_features


def scaling_noise(node_features, rng, mean=1.0, std=0.04):
    num_nodes = node_features.shape[0]
    h = np.ones(num_nodes) * rng.normal(loc=mean, scale=std)
    v = np.ones(num_nodes) * rng.normal(loc=mean, scale=std)
    node_features = horizontal_scaling(node_features, h)
    node_features = vertical_scaling(node_features, v)
    return node_features


def horizontal_scaling(node_features, scaling):
    scaling = np.expand_dims(scaling, axis=1)
    node_features[:, (0, 2)] *= scaling
    if node_features.shape[1] >= 12:
        node_features[:, (4, 6, 8, 10)] *= scaling
    return node_features


def vertical_scaling(node_features, scaling):
    scaling = np.expand_dims(scaling, axis=1)
    node_features[:, (1, 3)] *= scaling
    if node_features.shape[1] >= 12:
        node_features[:, (5, 7, 9, 11)] *= scaling
        if node_features.shape[1] >= 16:
            node_features[:, 15] *= np.squeeze(scaling)
    return node_features


def rotation_noise(node_features, rng, mean=0.0, std=0.052):
    angle = rng.normal(loc=mean, scale=std)
    return coherent_rotation(node_features, angle)


def coherent_rotation(node_features, angle):
    cx = np.mean(node_features[:, 2])
    cy = np.mean(node_features[:, 3])
    x = node_features[:, 2] - cx
    y = node_features[:, 3] - cy
    node_features[:, 2] = np.cos(angle) * x - np.sin(angle) * y + cx
    node_features[:, 3] = np.sin(angle) * x + np.cos(angle) * y + cy
    if node_features.shape[1] >= 12:
        bx = node_features[:, (6, 10)] - cx
        by = node_features[:, (7, 11)] - cy
        node_features[:, (6, 10)] = np.cos(angle) * bx - np.sin(angle) * by + cx
        node_features[:, (7, 11)] = np.sin(angle) * bx + np.cos(angle) * by + cy
    return node_features


def translation_noise(node_features, rng, mean_coherent=0.0, std_coherent=0.01,
                      mean_incoherent=0.0, std_incoherent=0.005):
    num_nodes = node_features.shape[0]
    dx = rng.normal(loc=mean_incoherent, scale=std_incoherent, size=num_nodes)
    dy = rng.normal(loc=mean_incoherent, scale=std_incoherent, size=num_nodes)
    dx = dx + rng.normal(loc=mean_coherent, scale=std_coherent)
    dy = dy + rng.normal(loc=mean_coherent, scale=std_coherent)
    node_features[:, 2] += dx
    node_features[:, 3] += dy
    if node_features.shape[1] >= 12:
        node_features[:, (6, 10)] += np.expand_dims(dx, axis=1)
        node_features[:, (7, 11)] += np.expand_dims(dy, axis=1)
    return node_features
