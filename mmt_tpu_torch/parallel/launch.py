"""Runs a function on n local processes joined in one process group.

``run_local(fn, n, *args)`` spawns n processes (``spawn`` start method),
sets each one's launcher environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR=localhost``, a free ``MASTER_PORT``), calls
``fn(*args)`` there and returns the n results in rank order (each must
pickle).  A process that raises or dies fails the call with its traceback.
``fn`` must be importable by name (a module-level function).  The
processes join no group themselves: ``fn`` calls
``parallel.mesh.init_distributed``.  Used by the dry run
(``parallel/dryrun.py``) and the multi-process CPU tests (``gloo``).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import traceback
from typing import Callable, List

DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(fn, rank: int, world: int, port: int, results, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable, nprocs: int, *args, timeout: float = DEFAULT_TIMEOUT_S) -> List:
    """``fn(*args)`` on ``nprocs`` ranks; returns their results by rank."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(fn, r, nprocs, port, results, args),
                         daemon=True) for r in range(nprocs)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        while len(out) + len(errors) < nprocs:
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if not p.is_alive()]
                raise RuntimeError(f"no result within {timeout} s (dead ranks: {dead})")
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break  # the other ranks may wait on it forever
        if errors:
            raise RuntimeError("a rank failed\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(nprocs)]
