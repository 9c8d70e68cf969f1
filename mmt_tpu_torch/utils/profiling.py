"""Profiling hooks: a trace around a block and a step timer.

The port's counterpart of ``mmt_tpu/utils/profiling.py``, both opt-in:

    with trace_if("/tmp/profile", enabled=step in (10, 11)):
        state, metrics = train_step(state, batch, rngs)

``trace_if`` runs ``torch.profiler.profile`` over the block (CPU activity,
and CUDA activity when a card is present) and writes a Chrome trace,
``<log_dir>/trace_<pid>_<time ns>.json``, which ``chrome://tracing`` or
Perfetto open.  ``StepTimer`` gives the JAX package's steps/s and
examples/s.  ``start_server`` (``jax.profiler.start_server``, on-demand
capture from TensorBoard) has no PyTorch counterpart and raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool = True):
    """Profiles the enclosed block when ``enabled``; yields the profiler
    (None when disabled).  The trace's path is the profiler's
    ``trace_path`` attribute after the block."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def start_server(port: int = 9999):
    """``jax.profiler.start_server`` lets TensorBoard capture a trace on
    demand from a running process; PyTorch has no such server."""
    raise NotImplementedError(
        "start_server: PyTorch has no on-demand profiler server; wrap the steps to "
        "trace in trace_if(log_dir) instead")


class StepTimer:
    """Tracks steps/sec and examples/sec over a window."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._steps = 0
        self._examples = 0

    def update(self, batch_size: int) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._steps += 1
        self._examples += batch_size

    def snapshot(self) -> Dict[str, float]:
        """The window's rates since its first ``update``; starts a new
        window.  Empty before any update."""
        if self._t0 is None or self._steps == 0:
            return {}
        dt = time.perf_counter() - self._t0
        out = {"steps_per_sec": self._steps / dt, "examples_per_sec": self._examples / dt}
        self._t0 = time.perf_counter()
        self._steps = self._examples = 0
        return out
