"""Loss functions (torch counterparts of ``mmt_tpu/train/losses.py``).

Both are Sum(w * pos_w * CE) / Sum(w) with divide-no-nan semantics: 0
when the weights sum to 0.  Logits are cast to float32 first.  Given
``denominator``, the sum of the weights over a larger batch (a
data-parallel step's global micro-batch), they divide by it instead: the
rank's share of that batch's loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _weighted_mean(per_example: torch.Tensor, label_weights: torch.Tensor,
                   pos_weights: Optional[torch.Tensor],
                   denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    if pos_weights is not None:
        per_example = per_example * pos_weights.to(per_example.dtype)
    w = label_weights.to(per_example.dtype)
    numerator = torch.sum(per_example * w)
    if denominator is None:
        denominator = torch.sum(w)
    return torch.where(denominator > 0, numerator / torch.clamp(denominator, min=1e-30),
                       torch.zeros_like(numerator))


def weighted_sparse_categorical_crossentropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_weights: torch.Tensor,
    pos_weights: Optional[torch.Tensor] = None,
    denominator: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax CE against integer labels; logits [..., C], labels [...]."""
    logits = logits.float()
    per_example = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(), reduction="none"
    ).reshape(labels.shape)
    return _weighted_mean(per_example, label_weights, pos_weights, denominator)


def weighted_binary_crossentropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_weights: torch.Tensor,
    pos_weights: Optional[torch.Tensor] = None,
    denominator: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sigmoid CE for single-logit heads."""
    logits = logits.float().reshape(labels.shape)
    per_example = F.binary_cross_entropy_with_logits(logits, labels.float(), reduction="none")
    return _weighted_mean(per_example, label_weights, pos_weights, denominator)
