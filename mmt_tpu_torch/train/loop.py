"""Training loop (torch counterpart of ``mmt_tpu/train/loop.py:run_training``).

Runs ``train_step`` from ``state.step`` to ``trainer.train_steps``; metric
pairs stay on the device within a window of ``steps_per_loop`` steps and
are read back once at its end, where the window's means and
``steps_per_sec`` are logged and, at ``summary_interval``, appended to
``<model_dir>/train_summaries.jsonl`` as the JAX ``SummaryWriter`` writes
it (one ``{"step": ..., <metric>: ...}`` object per line).

Not in this slice: validation during training (it needs the record
loaders), checkpoints, resume, preemption and best-checkpoint export.  The loop takes no checkpoint manager; a run starts from the
state it is given and its result lives only in the returned state.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterator, Optional

from mmt_tpu_torch.configs.experiments import TrainerConfig
from mmt_tpu_torch.models import DropoutRngs
from mmt_tpu_torch.train.metrics import finalize
from mmt_tpu_torch.train.train_state import TrainState

logger = logging.getLogger("mmt_tpu_torch")


class SummaryWriter:
    """Scalar summaries as jsonl: ``<log_dir>/<name>_summaries.jsonl``."""

    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_summaries.jsonl")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")


def run_training(
    *,
    train_step: Callable,
    state: TrainState,
    train_iter: Iterator,
    trainer: TrainerConfig,
    model_dir: str,
    rngs: Optional[DropoutRngs] = None,
    place_batch: Callable = lambda b: b,
) -> TrainState:
    """Runs the training loop; returns the final state.

    Args:
      train_step: (state, batch, rngs) -> (state, metric pairs).
      train_iter: yields host batches; ``place_batch`` moves one to the
        device.
      rngs: the dropout streams of the whole run.
    """
    writer = SummaryWriter(model_dir, "train")
    window: Dict = {}
    t_loop = time.perf_counter()
    for step_idx in range(state.step, trainer.train_steps):
        batch = place_batch(next(train_iter))
        state, metric_sums = train_step(state, batch, rngs)
        for name, pair in metric_sums.items():
            prev = window.get(name)
            window[name] = pair if prev is None else (prev[0] + pair[0], prev[1] + pair[1])

        step = step_idx + 1
        if step % trainer.steps_per_loop == 0 or step == trainer.train_steps:
            finalized = finalize(window)  # the window's one device->host read
            finalized["steps_per_sec"] = trainer.steps_per_loop / (time.perf_counter() - t_loop)
            logger.info("step %d: %s", step, finalized)
            window = {}
            if step % trainer.summary_interval == 0 or step == trainer.train_steps:
                writer.write(step, finalized)
            t_loop = time.perf_counter()
    return state
