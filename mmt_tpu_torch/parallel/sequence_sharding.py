"""Sequence sharding of token arrays over the mesh's ``model`` axis.

Counterpart of ``mmt_tpu/parallel/sequence_sharding.py``.  JAX annotates
[B, S, ...] activations as sharded (batch over ``data``, sequence over
``model``) and lets GSPMD place the collectives.  In the port a rank holds
its own chunk: ``shard_token_batch`` cuts a global host batch to this
rank's part, the token arrays (``word_ids``, ``segment_ids``) over both
axes and everything else over ``data`` only, as JAX's placement does.
JAX's ``constrain_tokens`` (a sharding annotation on an activation) has no
counterpart: a rank holds its own chunk by construction.
No encoder path of the JAX package runs the sharded attention wrappers,
so none here does either: the fused kernels run sequence-sharded through
``ops/sharded_attention.py``, called directly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from mmt_tpu_torch.parallel.mesh import Mesh, data_slice

TOKEN_KEYS = ("word_ids", "segment_ids")


def sequence_slice(mesh: Mesh, x: np.ndarray) -> np.ndarray:
    """This rank's [B / num_data, S / num_model, ...] chunk of a global
    [B, S, ...] array (``P('data', 'model')``)."""
    batch, seq = x.shape[:2]
    if batch % mesh.num_data or seq % mesh.num_model:
        raise ValueError(f"[{batch}, {seq}] does not split over a {mesh.num_data} x "
                         f"{mesh.num_model} mesh")
    b, s = batch // mesh.num_data, seq // mesh.num_model
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b, mesh.model_rank * s:(mesh.model_rank + 1) * s]


def shard_token_batch(mesh: Mesh, batch: Mapping[str, np.ndarray]) -> dict:
    """A global host batch -> this rank's part: [B, S] / [B, S, ...] token
    arrays over (data, model), everything else over data."""
    rows = data_slice(mesh, batch)
    return {k: (sequence_slice(mesh, np.asarray(batch[k]))
                if k in TOKEN_KEYS and np.ndim(batch[k]) >= 2 else rows[k])
            for k in batch}
