"""Embedding lookup with optional factorized projection and one-hot mode.

Torch counterpart of ``mmt_tpu/models/embeddings.py``: a
``[vocab, embedding_size]`` table (float32, looked up in the compute
dtype) and an optional Dense projection to ``projection_size``.

* One-hot mode: out-of-vocabulary ids give a **zero** embedding.
* Clip mode: out-of-range ids clamp to the first / last row.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmt_tpu_torch.models.common import dense


class EmbeddingLookup(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        embedding_size: int,
        projection_size: Optional[int] = None,
        use_one_hot_lookup: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.use_one_hot_lookup = use_one_hot_lookup
        self.dtype = dtype
        self.embedding_table = nn.Parameter(
            torch.empty(vocab_size, embedding_size, device=device))
        self.embedding_projection = None
        if projection_size is not None and projection_size != embedding_size:
            self.embedding_projection = nn.Linear(
                embedding_size, projection_size, device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embedding_table.to(self.dtype)
        ids = ids.long()
        out = table[ids.clamp(0, self.vocab_size - 1)]
        if self.use_one_hot_lookup:
            valid = (ids >= 0) & (ids < self.vocab_size)
            out = out * valid[..., None].to(out.dtype)
        if self.embedding_projection is not None:
            out = dense(out, self.embedding_projection, self.dtype)
        return out
