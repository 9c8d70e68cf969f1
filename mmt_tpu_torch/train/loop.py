"""Training loop (torch counterpart of ``mmt_tpu/train/loop.py:run_training``).

Runs ``train_step`` from ``state.step`` to ``trainer.train_steps``:

* step ``i`` draws its dropout streams from (``seed``, ``i``) alone
  (``DropoutRngs.for_step``, JAX's ``fold_in(rng, step_idx)``);
* metric pairs stay on the device within a window of ``steps_per_loop``
  steps and are read back once at its end, where the window's means and
  ``steps_per_sec`` are logged and, at ``summary_interval``, appended to
  ``<model_dir>/train_summaries.jsonl`` (one ``{"step": ..., <metric>:
  ...}`` object per line, as the JAX ``SummaryWriter`` writes it); the
  window's clock restarts after the step's checkpoint and validation, so
  ``steps_per_sec`` times training steps only; ``input_seconds`` (not in
  the JAX summaries) is the mean time a step of the window waited in
  ``next(train_iter)`` for its host batch, the loader's share of the step;
* at ``checkpoint_interval`` and at the last step the parameters and the
  optimizer state go to ``<model_dir>/<step>/`` (``CheckpointManager``,
  pruned to ``max_to_keep``), and the input stream's snapshot, where the
  iterator has ``state()``, to ``<model_dir>/data_stream/`` (the two
  newest kept);
* a run whose ``model_dir`` holds a checkpoint newer than ``state.step``
  resumes from it: parameters, optimizer state and the input stream;
* at ``validation_interval`` and at the last step ``eval_fn(state)`` runs,
  its metrics are appended to ``validation_summaries.jsonl``, and
  ``BestCheckpointExporter`` keeps the best step's parameters.

* ``trainer.tensorboard_summaries``: both summary streams also go to
  TensorBoard event files, ``<model_dir>/summaries/{train,validation}/
  events.out.tfevents.*`` (``utils/tb_events.py``), closed at the end of
  the run and before a preemption exit;
* ``trainer.async_checkpointing``: checkpoints are written by a
  background thread (``CheckpointManager(async_save=True)``) after the
  state is copied to host memory; the loop waits for the last one before
  it returns or exits;
* ``trainer.save_on_preemption`` (or an injected ``preemption_watcher``):
  after a step other than the last, a SIGTERM seen by the watcher saves
  the checkpoint and the stream's snapshot (unless this step just saved
  them), waits until they are durable, closes the summary writers and
  raises ``TrainingPreempted(step)``; the same command resumes there.

With several ranks (a ``torch.distributed`` group, data parallelism) every
rank runs the loop, its steps, its saves (a ZeRO-1 optimizer gathers its
moments) and its validation together; rank 0 alone writes the summaries,
the event files, the checkpoints and the best export, and each rank keeps
its own input stream's snapshot (``data_stream/rank_<r>/``).

On the CPU, with ``torch.use_deterministic_algorithms(True)`` (the
embedding gathers' backward sums in a run-dependent order otherwise), a
resumed run equals the uninterrupted one bit for bit.  On the card the
backward kernel sums dq and dRel with fp32 reductions in a run-dependent
order, so two runs, resumed or not, differ by that spread.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
import time
from typing import Callable, Dict, Iterator, Optional

import torch.distributed as dist

from mmt_tpu_torch.configs.experiments import TrainerConfig
from mmt_tpu_torch.models import DropoutRngs
from mmt_tpu_torch.parallel.mesh import rank_and_world
from mmt_tpu_torch.train.checkpoint import BestCheckpointExporter, CheckpointManager
from mmt_tpu_torch.train.metrics import finalize
from mmt_tpu_torch.train.preemption import PreemptionWatcher, TrainingPreempted
from mmt_tpu_torch.train.train_state import TrainState

logger = logging.getLogger("mmt_tpu_torch")


class SummaryWriter:
    """Scalar summaries as jsonl, ``<log_dir>/<name>_summaries.jsonl``, and
    with ``tensorboard`` as TensorBoard scalars in
    ``<log_dir>/summaries/<name>/events.out.tfevents.*``."""

    def __init__(self, log_dir: str, name: str, tensorboard: bool = False):
        self.path = os.path.join(log_dir, f"{name}_summaries.jsonl")
        self.enabled = rank_and_world()[0] == 0  # rank 0 alone writes
        self._tb = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        if tensorboard:
            from mmt_tpu_torch.utils.tb_events import TBEventWriter

            self._tb = TBEventWriter(os.path.join(log_dir, "summaries", name))

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")
        if self._tb is not None:
            self._tb.scalars(step, metrics)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _stream_state_path(model_dir: str, step: int) -> str:
    rank, world = rank_and_world()
    directory = (os.path.join(model_dir, "data_stream") if world == 1
                 else os.path.join(model_dir, "data_stream", f"rank_{rank}"))
    return os.path.join(directory, f"step_{step}.pkl")


def _save_stream_state(model_dir: str, step: int, train_iter) -> None:
    """Writes the input stream's position beside the checkpoint and keeps
    the two newest snapshots; iterators without ``state()`` (dummy
    batches) have none."""
    if not hasattr(train_iter, "state"):
        return
    path = _stream_state_path(model_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(train_iter.state(), f)
    os.replace(path + ".tmp", path)
    steps = sorted(int(name[len("step_"):-len(".pkl")])
                   for name in os.listdir(os.path.dirname(path))
                   if name.startswith("step_") and name.endswith(".pkl"))
    for old in steps[:-2]:
        os.remove(_stream_state_path(model_dir, old))


def _restore_stream_state(model_dir: str, step: int, train_iter) -> None:
    """Moves ``train_iter`` to where it was at ``step``'s save; without a
    snapshot the stream restarts at epoch 0 (its early batches replay)."""
    if not hasattr(train_iter, "restore"):
        return
    path = _stream_state_path(model_dir, step)
    if not os.path.exists(path):
        logger.warning("no input-stream snapshot for step %d: the stream restarts "
                       "from epoch 0 (early batches replay)", step)
        return
    with open(path, "rb") as f:  # written by _save_stream_state
        train_iter.restore(pickle.load(f))
    logger.info("input stream resumed at step %d (no replay)", step)


def run_training(
    *,
    train_step: Callable,
    state: TrainState,
    train_iter: Iterator,
    trainer: TrainerConfig,
    model_dir: str,
    eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
    seed: int = 0,
    place_batch: Callable = lambda b: b,
    preemption_watcher: Optional[PreemptionWatcher] = None,
) -> TrainState:
    """Runs the training loop; returns the final state.

    Args:
      train_step: (state, batch, rngs) -> (state, metric pairs).
      train_iter: yields host batches; ``place_batch`` moves one to the
        device.
      eval_fn: validation, state -> metrics.
      seed: the run's seed, from which each step's dropout streams come.
      preemption_watcher: an injected watcher (tests, embedding runtimes);
        without one, one is made when ``trainer.save_on_preemption`` is set.

    Raises:
      TrainingPreempted: a preemption signal arrived and the state was
        checkpointed; a rerun resumes from ``exc.step``.
    """
    rank, world = rank_and_world()
    ckpt = CheckpointManager(model_dir, max_to_keep=trainer.max_to_keep,
                             async_save=trainer.async_checkpointing)
    writer = SummaryWriter(model_dir, "train", tensorboard=trainer.tensorboard_summaries)
    val_writer = None
    best = None

    def durable():
        """Every rank returns once rank 0's checkpoint is on disk."""
        ckpt.wait_until_finished()
        if world > 1:
            dist.barrier()

    if rank == 0 and trainer.best_checkpoint_export_subdir and trainer.best_checkpoint_eval_metric:
        best = BestCheckpointExporter(
            os.path.join(model_dir, trainer.best_checkpoint_export_subdir),
            trainer.best_checkpoint_eval_metric, trainer.best_checkpoint_metric_comp)

    def close_writers():
        writer.close()
        if val_writer is not None:
            val_writer.close()

    latest = ckpt.latest_step()
    if latest is not None and latest > state.step:
        state = ckpt.restore_train_state(state, latest)
        logger.info("resumed from checkpoint at step %d", latest)
        _restore_stream_state(model_dir, latest, train_iter)

    watcher = preemption_watcher
    if watcher is None and trainer.save_on_preemption:
        watcher = PreemptionWatcher()
    device = next(state.model.parameters()).device
    window: Dict = {}
    window_steps, input_s = 0, 0.0
    with watcher if watcher is not None else contextlib.nullcontext():
        t_loop = time.perf_counter()
        for step_idx in range(state.step, trainer.train_steps):
            t_input = time.perf_counter()
            host_batch = next(train_iter)
            input_s += time.perf_counter() - t_input
            window_steps += 1
            batch = place_batch(host_batch)
            del host_batch
            state, metric_sums = train_step(state, batch,
                                            DropoutRngs.for_step(seed, step_idx, device))
            for name, pair in metric_sums.items():
                prev = window.get(name)
                window[name] = pair if prev is None else (prev[0] + pair[0], prev[1] + pair[1])

            step = step_idx + 1
            last = step == trainer.train_steps
            at_boundary = step % trainer.steps_per_loop == 0 or last
            if at_boundary:
                finalized = finalize(window)  # the window's one device->host read
                finalized["steps_per_sec"] = (trainer.steps_per_loop
                                              / (time.perf_counter() - t_loop))
                finalized["input_seconds"] = input_s / window_steps
                logger.info("step %d: %s", step, finalized)
                window, window_steps, input_s = {}, 0, 0.0
                if step % trainer.summary_interval == 0 or last:
                    writer.write(step, finalized)

            saved = step % trainer.checkpoint_interval == 0 or last
            if saved:
                ckpt.save(step, state.model, state.optimizer)
                _save_stream_state(model_dir, step, train_iter)

            if eval_fn is not None and (step % trainer.validation_interval == 0 or last):
                eval_metrics = eval_fn(state)
                if val_writer is None:
                    val_writer = SummaryWriter(model_dir, "validation",
                                               tensorboard=trainer.tensorboard_summaries)
                val_writer.write(step, eval_metrics)
                logger.info("eval @ %d: %s", step, eval_metrics)
                if best is not None:
                    best.maybe_export(step, eval_metrics, state.model)

            if watcher is not None and not last and watcher.should_save(at_boundary):
                if not saved:
                    ckpt.save(step, state.model, state.optimizer)
                    _save_stream_state(model_dir, step, train_iter)
                durable()
                close_writers()
                logger.warning("preempted at step %d: checkpoint durable, exiting "
                               "(a rerun resumes here)", step)
                raise TrainingPreempted(step)

            if at_boundary:
                t_loop = time.perf_counter()
    durable()
    close_writers()
    return state
