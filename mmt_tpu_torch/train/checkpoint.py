"""Checkpoints, one directory per step, best-metric export and the
pretrain -> finetune partial restore.

Counterpart of ``mmt_tpu/train/checkpoint.py`` with ``torch.save`` files in
place of Orbax (tensors on the CPU):

* ``CheckpointManager``: ``<directory>/<step>/model.pt`` holds the model's
  ``state_dict`` and, for a training checkpoint, ``optimizer.pt`` the
  optimizer's (``AdamW.state_dict``: the count and the moments).  ``save``
  prunes to the newest ``max_to_keep`` steps; ``restore`` reads the
  parameters only (prediction and warm starts read a training checkpoint
  so), ``restore_train_state`` the parameters and the optimizer state.
  Both raise ``FileNotFoundError`` naming the directory when it holds no
  checkpoint.
* ``BestCheckpointExporter``: keeps the parameters of the best step by an
  eval metric (``higher`` or ``lower``) as a one-step checkpoint directory
  ``<export_dir>/best_ckpt`` and writes ``<export_dir>/best_info.json``.
* ``restore_encoder_and_heads`` / ``count_restored``: the ``encoder.*``
  tensors and the ``cls_heads.<name>.*`` tensors whose names match,
  between two ``state_dict`` s (``src/tasks/classification.py:229-253``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional

import torch
from torch import nn

_MODEL_FILE = "model.pt"
_OPTIMIZER_FILE = "optimizer.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _save(obj, path: str) -> None:
    torch.save(_to_cpu(obj), path + ".tmp")
    os.replace(path + ".tmp", path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 32):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _path(self, step: int, name: str = _MODEL_FILE) -> str:
        return os.path.join(self.directory, str(step), name)

    def steps(self):
        """The steps with a complete checkpoint, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(self._path(int(name))))

    def save(self, step: int, model: nn.Module, optimizer=None) -> None:
        """Writes the model's parameters and buffers (and the optimizer's
        state) as step ``step``, then drops all but the newest
        ``max_to_keep`` steps.  ``model.pt`` is written last: a step
        counts once it is there."""
        os.makedirs(os.path.dirname(self._path(step)), exist_ok=True)
        if optimizer is not None:
            _save(optimizer.state_dict(), self._path(step, _OPTIMIZER_FILE))
        _save(model.state_dict(), self._path(step))
        steps = self.steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        return max(self.steps(), default=None)

    def _step(self, step: Optional[int]) -> int:
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    def restore(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The model ``state_dict`` of ``step`` (default the latest), on the CPU."""
        return torch.load(self._path(self._step(step)), map_location="cpu", weights_only=True)

    def restore_train_state(self, state, step: Optional[int] = None):
        """Loads the parameters and the optimizer state of ``step`` (default
        the latest) into ``state`` (a ``TrainState``) in place and sets its
        step; returns it."""
        step = self._step(step)
        opt_path = self._path(step, _OPTIMIZER_FILE)
        if not os.path.exists(opt_path):
            raise FileNotFoundError(f"checkpoint {step} in {self.directory} holds no "
                                    f"optimizer state")
        state.model.load_state_dict(self.restore(step))
        state.optimizer.load_state_dict(
            torch.load(opt_path, map_location="cpu", weights_only=True))
        state.step = step
        return state


class BestCheckpointExporter:
    """Keeps the best checkpoint by an eval metric."""

    def __init__(self, export_dir: str, metric_name: str, comp: str = "higher"):
        self.export_dir = os.path.abspath(export_dir)
        self.metric_name = metric_name
        self.comp = comp
        os.makedirs(self.export_dir, exist_ok=True)
        self._info_path = os.path.join(self.export_dir, "best_info.json")
        self.checkpoints = CheckpointManager(os.path.join(self.export_dir, "best_ckpt"),
                                             max_to_keep=1)

    def _best_so_far(self) -> Optional[float]:
        if os.path.exists(self._info_path):
            with open(self._info_path) as f:
                return json.load(f)["metric_value"]
        return None

    def maybe_export(self, step: int, metrics: Dict[str, float], model: nn.Module) -> bool:
        value = metrics.get(self.metric_name)
        if value is None:
            return False
        best = self._best_so_far()
        better = (
            best is None
            or (self.comp == "higher" and value > best)
            or (self.comp == "lower" and value < best)
        )
        if not better:
            return False
        self.checkpoints.save(step, model)
        with open(self._info_path, "w") as f:
            json.dump({"step": step, "metric_name": self.metric_name,
                       "metric_value": float(value)}, f)
        return True


def _restorable(name: str) -> bool:
    return name.startswith(("encoder.", "cls_heads."))


def restore_encoder_and_heads(target: Mapping[str, torch.Tensor],
                              pretrain: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Pretrain -> finetune partial restore on ``state_dict`` s.

    Takes the ``encoder.*`` tensors and the ``cls_heads.<name>.*`` tensors
    of ``pretrain`` whose names are in ``target``; every other tensor keeps
    the target's (fresh) value.  A shape mismatch raises ValueError.
    """
    out = {}
    for name, value in target.items():
        if _restorable(name) and name in pretrain:
            if tuple(pretrain[name].shape) != tuple(value.shape):
                raise ValueError(f"shape mismatch restoring {name}: "
                                 f"{tuple(pretrain[name].shape)} vs {tuple(value.shape)}")
            out[name] = pretrain[name]
        else:
            out[name] = value
    return out


def count_restored(target: Mapping[str, torch.Tensor],
                   pretrain: Mapping[str, torch.Tensor]) -> int:
    return sum(1 for name in target if _restorable(name) and name in pretrain)
