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
* Dropout (``DropoutRngs``) is active in ``model.train()`` and off in
  ``model.eval()``, standing in for Flax's ``deterministic`` flag; the
  models start in ``eval()``, as ``deterministic`` defaults to True.
  Each transformer layer call draws all of its randomness from two seeds
  (``LayerSeeds``) taken before it runs, so that a recomputed layer
  (remat) replays the same masks.  A data-parallel rank draws each mask
  over its whole global micro-batch (``batch_rows``) and keeps its own
  rows, so its masks are the one-process step's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmt_tpu_torch.ops.quant import Int8Linear


class LayerSeeds(NamedTuple):
    """The randomness of one transformer layer call: the int32 seed of the
    in-kernel attention dropout and the seed of a generator, on the layer's
    device, for its two hidden-dropout masks.  A layer called again with
    the same seeds draws the same masks.  ``batch_start`` and
    ``batch_rows`` place the call's rows in its global micro-batch, as
    ``DropoutRngs``'s do."""

    attention: int
    hidden: int
    batch_start: int = 0
    batch_rows: Optional[int] = None


@dataclasses.dataclass
class DropoutRngs:
    """Random streams of a training call (Flax's ``rngs={"dropout": ...}``).

    ``host`` is a CPU generator: the transformer layers' seeds
    (``layer_seeds``, two int32 per layer per call) are drawn from it on
    the host, so drawing them never waits for the card.  ``device`` is a
    generator on the model's device: the embedding and head dropout masks
    are drawn from it.  A stream left None draws from torch's default
    generator of that device.
    """

    host: Optional[torch.Generator] = None
    device: Optional[torch.Generator] = None
    # Where the batch's rows lie in its global micro-batch: a data-parallel
    # rank's rows are [batch_start, batch_start + B) of batch_rows.  The
    # attention dropout hashes each row's global index; the other masks are
    # drawn over all batch_rows rows (the batch's own rows when None) and
    # sliced, so every rank keeps the one-process step's mask rows.
    batch_start: int = 0
    batch_rows: Optional[int] = None

    @classmethod
    def for_step(cls, seed: int, step: int, device) -> "DropoutRngs":
        """The streams of training step ``step`` of a run seeded ``seed``,
        made from the pair alone (JAX's ``fold_in(rng, step)``): a run
        resumed at step k draws the masks the uninterrupted run drew."""
        host, dev = np.random.SeedSequence([seed, step]).generate_state(2)
        return cls(host=torch.Generator().manual_seed(int(host)),
                   device=torch.Generator(device).manual_seed(int(dev)))

    def seed(self) -> int:
        """An int32 seed from the host stream."""
        return int(torch.randint(-(1 << 31), 1 << 31, (), generator=self.host))

    def split(self, k: int) -> list:
        """k streams, one per micro-batch of a step (JAX's
        ``random.split(rng, k)``), drawn from this one's host stream; itself
        when k is 1.  Every data-parallel rank splits alike, so micro-batch m
        draws the same seeds on every rank."""
        if k == 1:
            return [self]
        out = []
        for _ in range(k):
            host, dev = (int(x) for x in torch.randint(0, 1 << 62, (2,), generator=self.host))
            out.append(DropoutRngs(
                host=torch.Generator().manual_seed(host),
                device=(torch.Generator(self.device.device).manual_seed(dev)
                        if self.device is not None else None)))
        return out

    def layer_seeds(self) -> LayerSeeds:
        """The seeds of one transformer layer call."""
        return LayerSeeds(self.seed(), self.seed(), self.batch_start, self.batch_rows)

    def dropout(self, x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
        """Flax ``nn.Dropout``: zero each element with probability ``rate``
        and divide the kept ones by ``1 - rate``; the identity when not
        training or at rate 0."""
        if not training or rate == 0.0:
            return x
        if self.batch_rows is None:
            keep = torch.rand(x.shape, generator=self.device, device=x.device)
        else:
            keep = torch.rand((self.batch_rows, *x.shape[1:]), generator=self.device,
                              device=x.device)[self.batch_start:self.batch_start + x.shape[0]]
        keep = keep >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` in the compute dtype, from float32 parameters; an
    ``Int8Linear`` quantizes ``x`` as given (JAX's ``Int8Dense`` does not
    cast its input) and returns ``dtype``."""
    if isinstance(layer, Int8Linear):
        return layer(x, dtype)
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


def _glorot_uniform(rng: np.random.Generator, shape) -> np.ndarray:
    """Flax ``glorot_uniform`` for a torch ``[out, in]`` weight."""
    fan_out, fan_in = shape
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


@torch.no_grad()
def init_params(module: nn.Module, seed: int, stddev: float) -> None:
    """Fills every parameter of ``module`` from a numpy seed.

    Linear layers whose module sets ``glorot_init = True`` (the MLM and
    MPP transforms) take Flax's ``glorot_uniform``.
    """
    rng = np.random.default_rng(seed)
    layer_norm_params = {
        id(p) for m in module.modules() if isinstance(m, nn.LayerNorm)
        for p in m.parameters()
    }
    glorot_params = {
        id(m.weight) for m in module.modules()
        if isinstance(m, nn.Linear) and getattr(m, "glorot_init", False)
    }
    for name, p in module.named_parameters():
        if id(p) in layer_norm_params:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        elif id(p) in glorot_params:
            p.copy_(torch.from_numpy(_glorot_uniform(rng, tuple(p.shape))))
        else:
            p.copy_(torch.from_numpy(_truncated_normal(rng, tuple(p.shape), stddev)))
