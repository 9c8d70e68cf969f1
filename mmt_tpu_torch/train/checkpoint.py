"""Checkpoints of a model's parameters, one directory per step.

Counterpart of ``mmt_tpu/train/checkpoint.py:CheckpointManager`` for what
prediction needs: ``<directory>/<step>/model.pt`` holds the model's
``state_dict`` (written with ``torch.save``, tensors on the CPU);
``save(step, model)``, ``latest_step()`` and ``restore(step=None)``, which
raises ``FileNotFoundError`` naming the directory when it holds no
checkpoint.  Optimizer state, ``max_to_keep``, the best-checkpoint export
and the pretrain -> finetune partial restore are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

_FILE = "model.pt"


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def save(self, step: int, model: torch.nn.Module) -> None:
        """Writes the model's parameters and buffers as step ``step``."""
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = [int(name) for name in os.listdir(self.directory)
                 if name.isdigit() and os.path.exists(self._path(int(name)))]
        return max(steps, default=None)

    def restore(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The ``state_dict`` of ``step`` (default the latest), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
