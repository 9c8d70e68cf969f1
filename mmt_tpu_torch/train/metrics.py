"""Accumulating metrics as (total, count) pairs of tensors
(torch counterpart of ``mmt_tpu/train/metrics.py``).

The pairs stay on the device between loop boundaries; ``finalize`` is
the one place that reads them back.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MetricState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # name -> (total, count)


def zeros_like_metrics(names, device=None) -> MetricState:
    return {n: (torch.zeros((), device=device), torch.zeros((), device=device)) for n in names}


def update_mean(state: MetricState, name: str, value, weight=1.0) -> MetricState:
    total, count = state[name]
    new = dict(state)
    new[name] = (total + value * weight, count + weight)
    return new


def update_weighted_accuracy(state: MetricState, name: str, labels, logits,
                             weights) -> MetricState:
    """Weighted sparse categorical accuracy (Keras semantics)."""
    correct, w = weighted_accuracy(labels, logits, weights)
    total, count = state[name]
    new = dict(state)
    new[name] = (total + correct, count + w)
    return new


def weighted_accuracy(labels, logits, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of weights of correct argmax predictions, sum of weights)."""
    correct = (torch.argmax(logits, -1) == labels).float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=correct.device)
    return torch.sum(correct * w), torch.sum(w)


def finalize(state: MetricState) -> Dict[str, float]:
    out = {}
    for n, (total, count) in state.items():
        total, count = float(total), float(count)
        out[n] = total / count if count else 0.0
    return out


def merge(a: MetricState, b: MetricState) -> MetricState:
    out = dict(a)
    for n, (t, c) in b.items():
        out[n] = (out[n][0] + t, out[n][1] + c) if n in out else (t, c)
    return out
