"""Numerics shared by the model modules, matching the JAX package's Flax layers.

* Dense layers compute in the compute dtype from float32 parameters
  (Flax ``nn.Dense(dtype=...)``).
* LayerNorm runs in float32 with the given epsilon (Flax
  ``nn.LayerNorm(dtype=float32)``).
* GELU is the tanh approximation.
* Parameters start as Flax's initializers would set them: truncated
  normal for kernels and tables, zeros for biases, ones for LayerNorm
  scales; drawn from a numpy seed, so one seed gives one model on any
  device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "gelu": gelu,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r}")
    return _ACTIVATIONS[name]


def _truncated_normal(rng: np.random.Generator, shape, stddev: float) -> np.ndarray:
    """Flax ``truncated_normal(stddev)``: a unit normal truncated to
    [-2, 2], scaled so that the truncated distribution has ``stddev``."""
    n = int(np.prod(shape))
    x = rng.standard_normal(n, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return (x * np.float32(stddev / 0.87962566103423978)).reshape(shape)


@torch.no_grad()
def init_params(module: nn.Module, seed: int, stddev: float) -> None:
    """Fills every parameter of ``module`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    layer_norm_params = {
        id(p) for m in module.modules() if isinstance(m, nn.LayerNorm)
        for p in m.parameters()
    }
    for name, p in module.named_parameters():
        if id(p) in layer_norm_params:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.from_numpy(_truncated_normal(rng, tuple(p.shape), stddev)))
