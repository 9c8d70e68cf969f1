"""Preemption-safe training: SIGTERM -> one final checkpoint -> clean exit.

The port's counterpart of ``mmt_tpu/train/preemption.py``.  A spot or
preemptible machine gets a SIGTERM some seconds before it is reclaimed;
the watcher turns it into a flag that the training loop reads after each
step, where it saves the checkpoint (and the input stream's position),
waits until the save is durable and raises ``TrainingPreempted``, so that
the same command run again resumes at that step.

The handler only sets the flag: a signal that lands inside a kernel or a
cuBLAS call is handled at the next Python bytecode, and the card is
synchronised by the loop's own save, never in the handler.

In one process ``should_save`` returns the local flag at every step, as
the JAX package does when ``process_count() == 1``.  With a process group
of several ranks it is the OR of every rank's flag, taken by an
all-reduce at a ``steps_per_loop`` boundary only, where every rank calls
it together (``mmt_tpu/train/preemption.py:90-108``): one signalled rank
checkpoints the whole group at the same step.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable

import torch
import torch.distributed as dist

logger = logging.getLogger("mmt_tpu_torch")


class TrainingPreempted(Exception):
    """Raised by the training loop after the preemption checkpoint is
    durable; ``step`` is the step a rerun resumes at."""

    def __init__(self, step: int):
        super().__init__(f"training preempted; checkpoint saved at step {step}")
        self.step = step


class PreemptionWatcher:
    """Context manager whose signal handlers set a flag.

    The handlers are installed on ``__enter__`` and the previous ones
    restored on ``__exit__``.  Off the main thread, where Python forbids
    ``signal.signal``, it installs none and warns; ``trigger`` still sets
    the flag.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev = {}
        self._flag = False
        self._installed = False

    def __enter__(self) -> "PreemptionWatcher":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
            self._installed = True
        else:
            logger.warning("PreemptionWatcher: not on the main thread; signal handlers not "
                           "installed (programmatic trigger() only)")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._prev.clear()
            self._installed = False

    def _handle(self, signum, frame) -> None:
        logger.warning("received signal %s: will checkpoint and exit at the next safe point",
                       signal.Signals(signum).name)
        self._flag = True

    def trigger(self) -> None:
        """Programmatic preemption (tests, embedding runtimes)."""
        self._flag = True

    @property
    def flagged_locally(self) -> bool:
        return self._flag

    def should_save(self, at_boundary: bool) -> bool:
        """True when the group agreed to save the final checkpoint now.

        ``at_boundary`` must be computed identically on every rank (e.g.
        ``step % steps_per_loop == 0``): with several ranks this runs a
        collective, which every rank must reach together."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self._flag
        if not at_boundary:
            return False
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(self._flag)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())
