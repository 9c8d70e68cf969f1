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
  checkpoint.  With ``async_save`` (the JAX package's Orbax option),
  ``save`` copies the state to host memory and returns; one background
  thread writes the files and prunes, so the write overlaps the next
  steps.  At most one save is in flight (a second waits for the first), a
  writer's exception is raised again by the next ``save`` or by
  ``wait_until_finished``, which a caller runs before it reads the
  checkpoint back or exits.
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
import threading
from typing import Dict, Mapping, Optional

import torch
from torch import nn

_MODEL_FILE = "model.pt"
_OPTIMIZER_FILE = "optimizer.pt"


def _to_cpu(tree, copy: bool = False):
    """``tree`` with its tensors on the CPU; ``copy`` copies those already
    there too (a snapshot that later in-place updates leave alone)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy)
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v, copy) for k, v in tree.items()}
    return tree


def _save(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 32, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

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
        counts once it is there.  With ``async_save`` the state is copied
        to host memory before this returns (the card is synchronised by the
        copy) and written by a background thread."""
        self.wait_until_finished()
        model_state = _to_cpu(model.state_dict(), copy=self.async_save)
        opt_state = None if optimizer is None else _to_cpu(optimizer.state_dict(),
                                                           copy=self.async_save)
        if not self.async_save:
            self._write(step, model_state, opt_state)
            return
        self._writer = threading.Thread(target=self._write_in_background,
                                        args=(step, model_state, opt_state),
                                        name=f"checkpoint-{step}")
        self._writer.start()

    def _write(self, step: int, model_state, opt_state) -> None:
        os.makedirs(os.path.dirname(self._path(step)), exist_ok=True)
        if opt_state is not None:
            _save(opt_state, self._path(step, _OPTIMIZER_FILE))
        _save(model_state, self._path(step))
        steps = self.steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def _write_in_background(self, step: int, model_state, opt_state) -> None:
        try:
            self._write(step, model_state, opt_state)
        except Exception as e:  # raised again by the caller's next call
            self._error = e

    def wait_until_finished(self) -> None:
        """Returns once the save in flight (if any) is durable; raises the
        writer's exception if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

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
