"""Softmax cross-entropy with integer labels, as optax computes it
(``optax.softmax_cross_entropy_with_integer_labels``): the row maximum is
subtracted without gradient before the log-sum-exp. Shared by the
segmentation loss and the relation loss."""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., C], integer labels [...] -> per-item CE [...]."""
    logits = logits - logits.detach().amax(dim=-1, keepdim=True)
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.log(torch.exp(logits).sum(dim=-1)) - label_logits
