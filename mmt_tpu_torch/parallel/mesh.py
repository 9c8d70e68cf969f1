"""Process groups over (data, model) and per-rank batches.

Counterpart of ``mmt_tpu/parallel/mesh.py``.  JAX builds one ``Mesh`` of
devices and lets GSPMD place the collectives; here one process drives one
device (a rank), and the mesh is a pair of process-group families:

* ``init_distributed(device)`` starts the process group from the usual
  launcher environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``; ``torchrun`` sets them): ``nccl`` for
  ``cuda`` (each rank on ``cuda:LOCAL_RANK``), ``gloo`` for ``cpu``.  A
  ``cuda`` run without NCCL or without a card raises; it never carries on
  with ``gloo`` or on the CPU.
* ``create_mesh(num_data, num_model)`` lays the world out as JAX's
  ``create_mesh`` lays its devices out: a (data, model) grid in rank
  order, ``num_data = 0`` meaning world / num_model.  Rank r sits at
  (r // num_model, r % num_model); ``data_group`` holds the ranks of its
  column (one model index, every data index: gradients are summed there),
  ``model_group`` the ranks of its row (one data index).
* ``create_pipe_mesh(num_data, num_pipe)`` lays the world out as JAX's
  train CLI lays its ('data', 'pipe') mesh out (``mmt_tpu/cli/train.py:
  174-185``): rank r at (r // num_pipe, r % num_pipe), ``num_data = 0``
  meaning world / num_pipe; ``pipe_group`` holds the ranks of its row (the
  stages of one pipeline, ``parallel/pipeline.py``), ``data_group`` those
  of its column; the stages of a pipeline hold the same rows.
* a rank holds its own slice of the global batch, which is process-major
  (data rank d holds global rows ``[d b, (d + 1) b)`` for a local batch of
  b rows), as ``make_array_from_process_local_data`` assembles it; ranks
  of one model group hold the same rows (parameters are replicated over
  ``model``, as the JAX CLI replicates them).  ``data_slice`` cuts a global
  batch to a rank's rows, ``shard_batch`` puts them on the device.

Without a process group (one process, no launcher), ``create_mesh`` gives
a 1 x 1 mesh whose groups are None, and every collective of the port's
parallel code is skipped.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """The process group's backend for ``device``: nccl for cuda, gloo for
    cpu; raises when a cuda group cannot be made."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda process group needs a CUDA device; none is available "
                               "(pass device='cpu' for a gloo group on the CPU)")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda process group needs NCCL, which this torch lacks")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device!r}")


def launched() -> bool:
    """Whether a launcher (``torchrun``, ``parallel.launch``) set this
    process's rank."""
    return all(k in os.environ for k in LAUNCH_ENV)


def rank_and_world() -> tuple:
    """(rank, world size) of this process's group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device="cuda") -> torch.device:
    """Joins the process group of the launcher's environment (once per
    process) and returns this rank's device: ``cuda:LOCAL_RANK`` or cpu.
    Raises when the environment names no rank."""
    backend = backend_for(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group is {dist.get_backend()}, {device} "
                               f"needs {backend}")
        return dev
    if not launched():
        raise RuntimeError(f"no process group: set {', '.join(LAUNCH_ENV)} (torchrun does)")
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid, or in the (data, pipe)
    grid of a pipeline mesh, and its groups."""

    num_data: int
    num_model: int
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    num_pipe: int = 1
    pipe_group: Optional[object] = None
    axis_names: tuple = ("data", "model")

    @property
    def data_rank(self) -> int:
        return self.rank // (self.num_model * self.num_pipe)

    @property
    def model_rank(self) -> int:
        return self.rank % self.num_model

    @property
    def pipe_rank(self) -> int:
        return self.rank % self.num_pipe

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    @property
    def is_chief(self) -> bool:
        """Rank 0: the one that writes the run's files."""
        return self.rank == 0


def _grid(num_data: int, num_other: int, name: str):
    """(num_data, rank, data group, group of the second axis) of a
    num_data x num_other grid over the world; rank r at (r // num_other, r
    % num_other), groups None without a process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_other < 1:
        raise ValueError(f"{name} must be >= 1, got {num_other}")
    if num_data <= 0:
        if world % num_other:
            raise ValueError(f"{world} ranks not divisible by {name}={num_other}")
        num_data = world // num_other
    if num_data * num_other != world:
        raise ValueError(f"a {num_data} x {num_other} mesh needs {num_data * num_other} ranks, "
                         f"the world has {world}")
    if not dist.is_initialized():
        return num_data, 0, None, None
    rank = dist.get_rank()
    data_group = row_group = None
    for j in range(num_other):  # every rank creates every group, in one order
        g = dist.new_group([i * num_other + j for i in range(num_data)])
        if rank % num_other == j:
            data_group = g
    for i in range(num_data):
        g = dist.new_group([i * num_other + j for j in range(num_other)])
        if rank // num_other == i:
            row_group = g
    return num_data, rank, data_group, row_group


def create_mesh(num_data: int = 0, num_model: int = 1) -> Mesh:
    """The (data, model) mesh over the world (``mmt_tpu/parallel/mesh.py:
    create_mesh``).  Every rank must call it, in the same order as its other
    group creations."""
    num_data, rank, data_group, model_group = _grid(num_data, num_model, "num_model")
    return Mesh(num_data, num_model, rank, data_group, model_group)


def create_pipe_mesh(num_data: int = 0, num_pipe: int = 1) -> Mesh:
    """The ('data', 'pipe') mesh of a pipelined run (module docstring).
    Every rank must call it, in the same order as its other group
    creations."""
    num_data, rank, data_group, pipe_group = _grid(num_data, num_pipe, "num_pipe")
    return Mesh(num_data, 1, rank, data_group, None, num_pipe, pipe_group, ("data", "pipe"))


def local_batch_size(mesh: Mesh, global_batch_size: int) -> int:
    """Rows per rank of a global batch; raises when they do not divide."""
    if global_batch_size % mesh.num_data:
        raise ValueError(f"global batch {global_batch_size} not divisible by the "
                         f"{mesh.num_data} data-parallel ranks")
    return global_batch_size // mesh.num_data


def data_slice(mesh: Mesh, batch: Mapping[str, np.ndarray]) -> dict:
    """This rank's rows of a global batch (process-major)."""
    local = local_batch_size(mesh, len(next(iter(batch.values()))))
    lo = mesh.data_rank * local
    return {k: v[lo:lo + local] for k, v in batch.items()}


def shard_batch(mesh: Mesh, batch: Mapping, device) -> dict:
    """This rank's rows of a global host batch (``data_slice``) as tensors
    on ``device`` (``mmt_tpu/parallel/mesh.py:shard_batch``; a loader
    sharded by data rank yields the rank's rows directly)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in data_slice(mesh, batch).items()}


def all_gather_rows(mesh: Mesh, array: np.ndarray, group=None) -> np.ndarray:
    """[n_ranks, *array.shape]: every rank's ``array`` over ``group``
    (default the data group), in rank order."""
    group = mesh.data_group if group is None else group
    if group is None:
        return np.asarray(array)[None]
    t = torch.as_tensor(np.ascontiguousarray(array))
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    n = dist.get_world_size(group)
    t = t.reshape(1, -1)
    out = torch.empty((n, t.shape[1]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.cpu().numpy().reshape(n, *np.shape(array))
