"""Seeded weights made on the device in one call: every matrix, table and
kernel from a normal truncated to two standard deviations (scaled so that
the truncated law has the configuration's ``initializer_range``), LayerNorm
scales 1, biases 0.  Both the program and the reference take them."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from mmtbench.generate import seed_of

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, stddev: float,
                 device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(seed_of(seed, 0))
    lo, hi = 0.5 * math.erfc(2 / math.sqrt(2)), 0.5 * math.erfc(-2 / math.sqrt(2))
    flat = torch.rand(total, generator=gen, device=device).mul_(hi - lo).add_(lo)
    flat = flat.mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2) * stddev / _TRUNC_STD)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[offset:offset + n].view(shape)
        offset += n
        if name.endswith("bias"):
            w.zero_()
        elif "layer_norm" in name:
            w.fill_(1.0)
        out[name] = w
    return out
