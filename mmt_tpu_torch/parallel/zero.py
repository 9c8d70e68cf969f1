"""ZeRO-1: the AdamW moments sharded over the mesh's ``data`` group.

Counterpart of ``mmt_tpu/parallel/zero.py``.  Each rank stores and updates
the slice ``[r n0 / n, (r + 1) n0 / n)`` of every moment whose leading
dimension n0 divides by the group's size n (``_spec`` there); the other
moments stay replicated.  The gradients are the all-reduced ones, every
rank updates its slice of the parameter, and the updated slices are
all-gathered, so the parameters stay replicated and bit-equal to the
replicated optimizer's (the same float32 arithmetic per element).  A
checkpoint holds the global state: ``AdamW.state_dict`` gathers the
moments and ``load_state_dict`` takes a full state and keeps this rank's
slices, so a ZeRO-1 checkpoint restores in one process and the reverse.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist

from mmt_tpu_torch.parallel.mesh import Mesh


def sharded(shape, n: int) -> bool:
    """Whether ZeRO-1 over n ranks shards a moment of ``shape``: its
    leading dimension divides by n (``mmt_tpu/parallel/zero.py:_spec``)."""
    return len(shape) >= 1 and shape[0] > 0 and shape[0] % n == 0


class Zero1:
    """A rank's share of ZeRO-1 over ``group`` (n ranks, this one
    ``rank``): ``slices``, its rows of each parameter whose moments are
    ``sharded`` over n."""

    def __init__(self, group, rank: int, n: int, params: Mapping[str, torch.Tensor]):
        self.group = group
        self.slices: Dict[str, slice] = {}
        for name, p in params.items():
            if sharded(p.shape, n):
                rows = p.shape[0] // n
                self.slices[name] = slice(rank * rows, (rank + 1) * rows)

    def gather(self, local: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Every rank's ``local`` slice, in rank order, into ``out`` (a
        collective)."""
        dist.all_gather_into_tensor(out, local.contiguous(), group=self.group)
        return out


@torch.no_grad()
def shard_opt_state(mesh: Mesh, optimizer):
    """Shards an ``AdamW``'s moments over ``mesh.data_group`` in place
    (nothing to do without a process group); returns it."""
    if mesh.data_group is not None:
        zero = Zero1(mesh.data_group, mesh.data_rank, mesh.num_data, optimizer.params)
        for name, rows in zero.slices.items():
            optimizer.mu[name] = optimizer.mu[name][rows].clone()
            optimizer.nu[name] = optimizer.nu[name][rows].clone()
        optimizer.zero = zero
    return optimizer
