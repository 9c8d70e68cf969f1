"""Plain float32 training steps: the loss over micro-batches, the summed
gradients, and AdamW with the polynomial warm-up schedule, written out from
the configuration's values.

AdamW as the configuration states it: moments mu <- b1 mu + (1 - b1) g,
nu <- b2 nu + (1 - b2) g^2, the update mu_hat / (sqrt(nu_hat) + eps) at
count n + 1, plus weight decay on every leaf but LayerNorm parameters and
biases, scaled by the learning rate of count n (0 for the first update).
The learning rate ramps linearly from 0 to the decayed rate at the end of
the warm-up, then decays linearly to ``end_learning_rate``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from mmtbench.reference.model import FP32, Geometry, Precision, StepDropout

_F32 = np.float32
BLOCK = 64  # rows of one forward and backward of the reference


def learning_rate(opt: dict) -> Callable[[int], float]:
    """The learning rate of update count n, in float32 as the schedule
    states it (``opt``: the configuration's optimizer block with its
    defaults filled in)."""
    poly, warm = opt["polynomial"], opt["warmup"]
    decay_steps = poly["decay_steps"]

    def base(step):
        frac = _F32(1) - _F32(min(max(step, 0), decay_steps)) / _F32(decay_steps)
        return (_F32(poly["initial_learning_rate"] - poly["end_learning_rate"])
                * frac ** _F32(poly["power"]) + _F32(poly["end_learning_rate"]))

    def rate(step):
        if warm["warmup_steps"] and _F32(step) < warm["warmup_steps"]:
            return float(base(warm["warmup_steps"])
                         * (_F32(step) / _F32(warm["warmup_steps"])) ** _F32(warm["power"]))
        return float(base(step))

    return rate


def decays(name: str) -> bool:
    """Whether AdamW's weight decay applies to the leaf ``name``."""
    return "layer_norm" not in name and not name.endswith("bias")


class ReferenceTrainer:
    """Training steps of the plain model from the benchmark's weights.

    ``loss_fn(params, batch, geometry, precision, dropout, rows)`` is the
    share of one micro-batch's loss that its rows ``rows`` give; a step sums
    the gradients of loss / k over its k micro-batches, each in blocks of at
    most ``BLOCK`` rows, and then updates every leaf."""

    def __init__(self, weights: Dict[str, torch.Tensor], geometry: Geometry, opt: dict,
                 loss_fn, micro_batch: int, precision: Precision = FP32):
        self.params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
        self.g, self.loss_fn, self.prec = geometry, loss_fn, precision
        self.micro_batch = micro_batch
        self.lr = learning_rate(opt)
        adamw = opt["adamw"]
        self.b1, self.b2, self.eps = adamw["beta_1"], adamw["beta_2"], adamw["epsilon"]
        self.wd = adamw["weight_decay_rate"]
        if adamw["global_clipnorm"]:
            raise ValueError("the reference covers AdamW without clipping")
        self.mu = {n: torch.zeros_like(w) for n, w in self.params.items()}
        self.nu = {n: torch.zeros_like(w) for n, w in self.params.items()}
        self.count = 0

    def step(self, batch: Dict[str, torch.Tensor], dropout_seed: int, step: int):
        """One optimizer step on ``batch`` with the dropout of (seed, step):
        returns (the loss, each leaf's gradient norm)."""
        rows = batch["word_ids"].shape[0]
        k = max(1, rows // self.micro_batch) if self.micro_batch else 1
        size = rows // k
        drop = StepDropout(dropout_seed, step, k, self.g.hidden_dropout)
        total = 0.0
        for m in range(k):
            micro = {key: v[m * size:(m + 1) * size] for key, v in batch.items()}
            masks = drop.micro_batch(m, self.g.layers)
            for lo in range(0, size, BLOCK):
                loss = self.loss_fn(self.params, micro, self.g, self.prec, masks,
                                    slice(lo, lo + BLOCK))
                (loss / k).backward()
                total += float(loss.detach()) / k
        norms = self.apply()
        return total, norms

    @torch.no_grad()
    def apply(self) -> Dict[str, float]:
        lr = self.lr(self.count)
        self.count += 1
        c1 = float(_F32(1) - _F32(self.b1) ** _F32(self.count))
        c2 = float(_F32(1) - _F32(self.b2) ** _F32(self.count))
        norms = {}
        for name, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            norms[name] = float(torch.linalg.vector_norm(g))
            self.mu[name].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[name].mul_(self.b2).add_((1 - self.b2) * g * g)
            update = (self.mu[name] / c1) / (torch.sqrt(self.nu[name] / c2) + self.eps)
            if self.wd and decays(name):
                update = update + self.wd * p
            p.add_(-lr * update)
            p.grad = None
        return norms

    def change_norms(self, weights: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Each leaf's ||p - p0|| against the starting ``weights``."""
        return {n: float(torch.linalg.vector_norm(p.detach() - weights[n]))
                for n, p in self.params.items()}


def follow(weights, geometry, opt, loss_fn, micro_batch, batches: List[Dict], dropout_seed: int,
           precision: Precision = FP32) -> dict:
    """The reference's readings over ``batches``, one step each: the losses,
    the first step's gradient norms and the change of every leaf."""
    trainer = ReferenceTrainer(weights, geometry, opt, loss_fn, micro_batch, precision)
    losses, first = [], None
    for step, batch in enumerate(batches):
        loss, norms = trainer.step(batch, dropout_seed, step)
        losses.append(loss)
        first = norms if first is None else first
    return {"losses": losses, "grad_norms": first, "change_norms": trainer.change_norms(weights)}
