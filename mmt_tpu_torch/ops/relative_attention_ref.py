"""Dense reference ops for relative attention and position gathers.

Torch counterpart of ``mmt_tpu/ops/relative_attention_ref.py``: the
dense oracle that the fused kernel's plain version is built on.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def relative_attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    relative_att_ids: Optional[torch.Tensor],
) -> torch.Tensor:
    """Scaled attention logits with additive relative bias, in float32.

    score(b,h,q,k) = (q.k + q.R[id(q,k), h]) / sqrt(head_dim)

    The bias is a small projection ``qr[b,h,q,v] = q . R[v,h]`` (R cast
    to the compute dtype first) gathered along v.  Ids >= V give zero
    bias.  Products of the compute dtype are summed in float32.

    Args:
      q, k: <float>[B, S, num_heads, head_dim].
      rel_table: <float32>[V, num_heads, head_dim] or None.
      relative_att_ids: <int>[S, S] or [B, S, S] or None.

    Returns:
      <float32>[B, num_heads, S, S] logits.
    """
    head_dim = q.shape[-1]
    qf = q.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())

    if rel_table is not None and relative_att_ids is not None:
        vocab = rel_table.shape[0]
        qr = torch.einsum(
            "bqhd,vhd->bhqv", qf, rel_table.to(q.dtype).float()
        )  # [B, H, Q, V]
        ids = relative_att_ids.long()
        if ids.ndim == 2:
            ids = ids[None]
        valid = ids < vocab
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids))  # [B|1, Q, K]
        index = safe_ids[:, None].expand(qr.shape[0], qr.shape[1], -1, -1)
        gathered = torch.gather(qr, -1, index)  # [B, H, Q, K]
        logits = logits + torch.where(valid[:, None], gathered, torch.zeros_like(gathered))

    return logits / math.sqrt(head_dim)


def gather_indexes(sequence: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Gathers hidden vectors at ``positions`` per batch row.

    Args:
      sequence: <float>[B, S, H].
      positions: <int>[B, M].

    Returns:
      <float>[B, M, H].
    """
    index = positions.long()[..., None].expand(-1, -1, sequence.shape[-1])
    return torch.gather(sequence, 1, index)
