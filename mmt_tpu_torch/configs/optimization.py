"""Optimizer / learning-rate configurations (fields of ``mmt_tpu/configs/optimization.py``).

AdamW with weight-decay exclusions for LayerNorm/bias, polynomial decay,
polynomial warmup: the TFM optimization blocks of the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List

from mmt_tpu_torch.configs.base import Config


@dataclasses.dataclass
class AdamWConfig(Config):
    weight_decay_rate: float = 0.01
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-6
    # Kept for yaml compatibility.  As in the JAX package, the decay mask
    # is fixed: see mmt_tpu_torch.train.optimizer.decay_mask.
    exclude_from_weight_decay: List[str] = dataclasses.field(
        default_factory=lambda: ["LayerNorm", "layer_norm", "bias"]
    )
    # Global-norm gradient clipping (0 disables).
    global_clipnorm: float = 0.0


@dataclasses.dataclass
class PolynomialLrConfig(Config):
    initial_learning_rate: float = 1e-4
    end_learning_rate: float = 0.0
    power: float = 1.0
    # 0 => use trainer.train_steps.
    decay_steps: int = 0


@dataclasses.dataclass
class PolynomialWarmupConfig(Config):
    warmup_steps: int = 0
    power: float = 1.0


@dataclasses.dataclass
class OptimizationConfig(Config):
    optimizer_type: str = "adamw"
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    lr_type: str = "polynomial"
    polynomial: PolynomialLrConfig = dataclasses.field(default_factory=PolynomialLrConfig)
    warmup_type: str = "polynomial"
    warmup: PolynomialWarmupConfig = dataclasses.field(
        default_factory=PolynomialWarmupConfig
    )
