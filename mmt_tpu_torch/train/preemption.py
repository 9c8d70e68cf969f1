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

The port trains in one process, so ``should_save`` returns the local flag
at every step, as the JAX package does when ``process_count() == 1``.  The
multi-process rule (the OR of every process's flag, taken only at a
``steps_per_loop`` boundary where every process calls it together) waits
for the parallel runtimes.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable

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
        """True when the final checkpoint should be saved now: in one
        process, whenever the flag is set (``at_boundary`` matters only
        to the multi-process rule)."""
        return self._flag
