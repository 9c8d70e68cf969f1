"""Multiprocess input pipeline: shard loaders across worker processes.

The port's counterpart of ``mmt_tpu/data/prefetch.py``.  The host pipeline
is numpy / PIL Python, so parallelism comes from worker *processes*: each
worker runs the same loader over a disjoint file / record shard, and the
parent takes its batches round-robin (deterministic given the worker count
and the per-shard seeds).

    batches = multiprocess_batches(
        LoaderShard(MmtPretrainLoader, cfg, batch_size), num_workers=8)

Workers are started with the ``spawn`` method: the parent may have
initialised CUDA, after which ``fork`` is unsafe.  A spawned worker imports
the port afresh and runs only the numpy / PIL loader; it never touches
CUDA.  The port has no gin-style bindings, so a worker re-applies none
(the JAX package's workers re-apply the parent's ``--gin_*`` bindings).

Unlike the JAX package's workers, which pickle each batch through the
queue's pipe, a worker copies a batch's arrays into one shared-memory block
(``/dev/shm``) and sends only its name and layout; the parent maps the
block, unlinks its name at once and yields numpy arrays that view it (the
memory is freed with the last of them).  At the WIT yaml's batch of 4096
(2.47 GB of patch vectors) a pickled batch costs the worker and the parent
tens of seconds of CPU on the card's host (``PERF.md``).  The arrays
are the loader's, byte for byte.

A worker whose loader raises sends its traceback and the parent raises
RuntimeError with it; so does a worker that dies or stays silent for
WORKER_TIMEOUT_S (a JAX worker's stream just ends, or the parent waits).

The stream has no ``state()``: a run resumed from a checkpoint restarts it
at its beginning, as the JAX package's does.  Each worker runs up to
``prefetch_per_worker`` batches ahead, so the host memory in flight is
about ``num_workers x (prefetch_per_worker + 5)`` batches: the queued
blocks, and in each worker the ~3 matched batches its stream's shuffle
buffer still views, the batch being stacked and the one being copied out.
"""

from __future__ import annotations

import mmap
import multiprocessing as mp
import os
import queue as queue_lib
import secrets
import time
import traceback
from multiprocessing import resource_tracker, shared_memory
from typing import Callable, Dict, Iterator, Optional

import numpy as np

_STOP = "__stop__"
_ERROR = "__error__"
# Seconds a worker may stay silent before the parent gives up on it, and
# the interval at which the parent checks that a silent worker still lives.
WORKER_TIMEOUT_S = 300.0
_POLL_S = 1.0
_SHM_DIR = "/dev/shm"
_ALIGN = 64


class LoaderShard:
    """Picklable ``loader_fn``: ``(shard, num_shards) ->`` the batches of a
    fresh ``loader_cls(config)``.  Configs are plain dataclasses and loader
    classes pickle by module path; each worker builds its own loader."""

    def __init__(self, loader_cls, config, batch_size: Optional[int] = None):
        self.loader_cls = loader_cls
        self.config = config
        self.batch_size = batch_size

    def __call__(self, shard: int, num_shards: int) -> Iterator[dict]:
        return self.loader_cls(self.config).load(shard, num_shards, batch_size=self.batch_size)


def _share(batch: Dict[str, np.ndarray], name: str):
    """Copies a batch's arrays into a new shared-memory block ``name``;
    returns the layout ``[(key, shape, dtype, offset)]``."""
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    layout, size = [], 0
    for key, a in arrays.items():
        size = -(-size // _ALIGN) * _ALIGN
        layout.append((key, a.shape, a.dtype.str, size))
        size += a.nbytes
    block = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
    try:
        for (key, shape, dtype, offset), a in zip(layout, arrays.values()):
            np.ndarray(shape, dtype, buffer=block.buf, offset=offset)[...] = a
    finally:
        block.close()
    return layout


def _attach(name: str, layout) -> Dict[str, np.ndarray]:
    """The batch in block ``name`` as arrays viewing one mapping of it; the
    name is unlinked at once, the memory lives until the arrays are gone."""
    fd = os.open(os.path.join(_SHM_DIR, name), os.O_RDWR)
    try:
        mapping = mmap.mmap(fd, os.fstat(fd).st_size)
    finally:
        os.close(fd)
        _unlink(name)
    return {key: np.frombuffer(mapping, np.dtype(dtype), count=int(np.prod(shape)),
                               offset=offset).reshape(shape)
            for key, shape, dtype, offset in layout}


def _unlink(name: str) -> None:
    """Removes a block's name; the worker registered it with the resource
    tracker (shared with the parent under spawn), which forgets it here."""
    try:
        os.unlink(os.path.join(_SHM_DIR, name))
    finally:
        resource_tracker.unregister("/" + name, "shared_memory")


def _worker(loader_fn, shard, num_shards, out_queue, prefix):
    try:
        for i, batch in enumerate(loader_fn(shard, num_shards)):
            name = f"{prefix}_{shard}_{i}"
            out_queue.put((name, _share(batch, name)))
            del batch
    except Exception:
        out_queue.put((_ERROR, traceback.format_exc()))
    finally:
        out_queue.put(_STOP)


def _get(q, proc, index: int, timeout_s: float):
    """The next item of worker ``index``; RuntimeError if it ended without
    its stop marker or sent nothing for ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return q.get(timeout=max(0.0, min(_POLL_S, deadline - time.monotonic())))
        except queue_lib.Empty:
            if not proc.is_alive():
                # A worker flushes its queue before it exits: what is not
                # in the pipe now never comes.
                try:
                    return q.get(timeout=_POLL_S)
                except queue_lib.Empty:
                    raise RuntimeError(f"input worker {index} exited with code "
                                       f"{proc.exitcode} before the end of its stream") from None
            if time.monotonic() >= deadline:
                raise RuntimeError(f"input worker {index} sent nothing for {timeout_s} s") \
                    from None


def multiprocess_batches(
    loader_fn: Callable[[int, int], Iterator[dict]],
    num_workers: int,
    prefetch_per_worker: int = 4,
    base_shard: int = 0,
    total_shards: int = 1,
) -> Iterator[dict]:
    """Yields batches from ``num_workers`` processes, round-robin.

    ``loader_fn(shard_index, num_shards)`` must return a fresh batch
    iterator and pickle (``LoaderShard``); workers get shards
    ``base_shard * num_workers + i`` of ``total_shards * num_workers``
    (host-level sharding composed with worker-level sharding).  With
    ``num_workers <= 0`` the loader runs in this process.  A worker that
    sends nothing for WORKER_TIMEOUT_S, fails or dies raises RuntimeError.
    Closing the generator stops the workers and frees their blocks.
    """
    if num_workers <= 0:
        yield from loader_fn(base_shard, total_shards)
        return

    ctx = mp.get_context("spawn")
    prefix = f"mmt_{os.getpid()}_{secrets.token_hex(4)}"
    queues, procs = [], []
    try:
        for i in range(num_workers):
            q = ctx.Queue(maxsize=prefetch_per_worker)
            p = ctx.Process(
                target=_worker,
                args=(loader_fn, base_shard * num_workers + i,
                      total_shards * num_workers, q, prefix),
                daemon=True,
            )
            p.start()
            queues.append(q)
            procs.append(p)

        live = [True] * num_workers
        while any(live):
            for i, q in enumerate(queues):
                if not live[i]:
                    continue
                item = _get(q, procs[i], i, WORKER_TIMEOUT_S)
                if isinstance(item, str) and item == _STOP:
                    live[i] = False
                    continue
                if item[0] == _ERROR:
                    raise RuntimeError(f"input worker {i} failed:\n{item[1]}")
                yield _attach(*item)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)
        for q in queues:
            q.cancel_join_thread()
            q.close()
        # Blocks made but never taken: queued, or cut short by terminate.
        for name in os.listdir(_SHM_DIR):
            if name.startswith(prefix + "_"):
                _unlink(name)
