"""Train state: step, model (the parameters) and optimizer
(torch counterpart of ``mmt_tpu/train/train_state.py``).

Unlike the JAX state, this one is updated in place: the parameters and
the Adam moments are the model's and the optimizer's own tensors.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from mmt_tpu_torch.train.optimizer import AdamW


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: AdamW

    @classmethod
    def create(cls, model: nn.Module, optimizer: AdamW) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``, which it
        then clears."""
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        return self
