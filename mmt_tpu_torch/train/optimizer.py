"""AdamW + polynomial decay / warmup with weight-decay exclusions.

Torch counterpart of ``mmt_tpu/train/optimizer.py``, which chains optax
transforms; the same arithmetic is written out here in float32:

* optional global-norm clipping (``global_clipnorm > 0``):
  g <- g if |g| < c else g / |g| * c, |g| over all parameters;
* Adam moments mu <- (1-b1) g + b1 mu, nu <- (1-b2) g^2 + b2 nu, and the
  bias-corrected update mu_hat / (sqrt(nu_hat) + eps) at count n + 1;
* decoupled weight decay: + wd * p on the parameters of ``decay_mask``;
* p <- p - lr(n) * update, with ``lr`` from ``create_learning_rate_fn``
  at the optimizer's own step count n (0 for the first update).

The learning rate is computed on the host, in float32, so a step never
waits for the card.  ``state_dict`` / ``load_state_dict`` carry the count
and the moments, which a checkpoint saves beside the parameters.

Under ZeRO-1 (``parallel/zero.py``'s ``shard_opt_state`` sets ``zero``)
this rank keeps and updates only its slice of each moment whose leading
dimension divides by the group's size, all-gathers the updated parameter
slices, and ``state_dict`` / ``load_state_dict`` still carry the full
(global) moments.  A parameter that holds one slice of a sharded tensor
(``parallel/param_sharding.py``) carries ``norm_sum``, which the global
norm of the clipping calls to sum its slices' squares over their group.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from mmt_tpu_torch.configs.optimization import OptimizationConfig
from mmt_tpu_torch.convert import flax_paths

_F32 = np.float32
# Substrings of the Flax path that exclude a parameter from weight decay.
DECAY_EXCLUDED = ("layer_norm", "layernorm", "bias", "scale")


def create_learning_rate_fn(config: OptimizationConfig,
                            train_steps: int) -> Callable[[int], float]:
    """TFM polynomial decay over the global step, after a polynomial
    warmup that ramps to the decayed value at ``warmup_steps``
    (``optax.polynomial_schedule`` arithmetic, in float32)."""
    lr_cfg = config.polynomial
    decay_steps = lr_cfg.decay_steps or train_steps

    def base(step) -> np.float32:
        count = _F32(min(max(step, 0), decay_steps))
        frac = _F32(1) - count / _F32(decay_steps)
        return (_F32(lr_cfg.initial_learning_rate - lr_cfg.end_learning_rate)
                * frac ** _F32(lr_cfg.power) + _F32(lr_cfg.end_learning_rate))

    warmup_steps = config.warmup.warmup_steps
    if not warmup_steps:
        return lambda step: float(base(step))
    warmup_power = _F32(config.warmup.power)

    def schedule(step) -> float:
        step_f = _F32(step)
        if step_f < warmup_steps:
            return float(base(warmup_steps) * (step_f / _F32(warmup_steps)) ** warmup_power)
        return float(base(step))

    return schedule


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for the parameters that get weight decay, decided on the Flax
    path each one maps to (``convert.flax_paths``), as the JAX package's
    ``_decay_mask`` decides it: a path containing ``layer_norm``,
    ``layernorm``, ``bias`` or ``scale`` (lowercased) is excluded."""
    return {name: not any(e in path.lower() for e in DECAY_EXCLUDED)
            for name, path in flax_paths(model).items()}


class AdamW:
    """AdamW over a model's named parameters, reading each ``p.grad``
    (None counts as a zero gradient).  Moments are float32."""

    def __init__(self, model: nn.Module, learning_rate: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, mask: Optional[Dict[str, bool]] = None,
                 global_clipnorm: float = 0.0):
        self.params = dict(model.named_parameters())
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask if mask is not None else decay_mask(model)
        self.global_clipnorm = global_clipnorm
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
        self.zero = None  # a parallel.zero.Zero1 under ZeRO-1

    @property
    def slices(self) -> Dict[str, slice]:
        """This rank's rows of each sharded moment (none when replicated)."""
        return self.zero.slices if self.zero is not None else {}

    def state_dict(self) -> Dict:
        """The update count and the float32 moments by parameter name: the
        tensors themselves, or under ZeRO-1 the full moments gathered from
        the group (a collective: every rank calls it)."""
        mu, nu = dict(self.mu), dict(self.nu)
        for name in self.slices:
            for m in (mu, nu):
                m[name] = self.zero.gather(m[name], m[name].new_empty(self.params[name].shape))
        return {"count": self.count, "mu": mu, "nu": nu}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copies a ``state_dict`` of an AdamW over the same parameters in
        (full moments; under ZeRO-1 this rank keeps its slices)."""
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.params):
                raise ValueError(f"optimizer state {key!r} names other parameters: "
                                 f"{sorted(set(state[key]) ^ set(self.params))[:5]}")
            for name, t in getattr(self, key).items():
                value = state[key][name]
                if value.shape != self.params[name].shape:
                    raise ValueError(f"optimizer state {key}[{name!r}] has shape "
                                     f"{tuple(value.shape)}, expected "
                                     f"{tuple(self.params[name].shape)}")
                rows = self.slices.get(name)
                t.copy_(value[rows] if rows is not None else value)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _grads(self) -> Dict[str, torch.Tensor]:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for n, p in self.params.items()}
        if self.global_clipnorm > 0:
            norm = torch.sqrt(self._squared_norm(grads))
            clip = norm >= self.global_clipnorm
            grads = {n: torch.where(clip, g / norm * self.global_clipnorm, g)
                     for n, g in grads.items()}
        return grads

    def _squared_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """|g|^2 over the whole model: the squares of the parameters that
        carry a ``norm_sum`` are summed by it (module docstring)."""
        parts: Dict = {}
        for n, g in grads.items():
            parts.setdefault(getattr(self.params[n], "norm_sum", None), []).append(
                torch.sum(g * g))
        return sum(sum(v) if f is None else f(sum(v)) for f, v in parts.items())

    @torch.no_grad()
    def step(self) -> None:
        grads = self._grads()
        lr = self.learning_rate(self.count)
        self.count += 1
        c1 = float(_F32(1) - _F32(self.b1) ** _F32(self.count))
        c2 = float(_F32(1) - _F32(self.b2) ** _F32(self.count))
        for name, p in self.params.items():
            g, target = grads[name], p
            rows = self.slices.get(name)
            if rows is not None:  # ZeRO-1: this rank's slice, the same arithmetic
                g, target = g[rows], p[rows]
            mu = self.mu[name].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[name].mul_(self.b2).add_((1 - self.b2) * (g * g))
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and self.mask[name]:
                update = update + self.weight_decay * target
            target.add_((-lr) * update)
            if rows is not None:
                self.zero.gather(target.clone(), p)


def create_optimizer(config: OptimizationConfig, train_steps: int, model: nn.Module) -> AdamW:
    if config.optimizer_type != "adamw":
        raise ValueError(f"Unsupported optimizer {config.optimizer_type!r}")
    adamw_cfg = config.adamw
    return AdamW(
        model, create_learning_rate_fn(config, train_steps),
        b1=adamw_cfg.beta_1, b2=adamw_cfg.beta_2, eps=adamw_cfg.epsilon,
        weight_decay=adamw_cfg.weight_decay_rate, global_clipnorm=adamw_cfg.global_clipnorm,
    )
