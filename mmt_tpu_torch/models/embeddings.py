"""Embedding lookup with optional factorized projection and one-hot mode.

Torch counterpart of ``mmt_tpu/models/embeddings.py``: a
``[vocab, embedding_size]`` table (float32; the rows are gathered in
float32 and then cast to the compute dtype, the same values as a lookup in
a cast table, so that the backward sums each row's gradient in float32: a
segment row sums one term per token of the batch) and an optional Dense
projection to ``projection_size``.

* One-hot mode: out-of-vocabulary ids give a **zero** embedding.
* Clip mode: out-of-range ids clamp to the first / last row.
* Vocabulary-parallel (``parallel/param_sharding.py`` sets ``tp``): the
  table holds the rows of the ranks this module runs; the ids are clamped
  first, each rank looks up the ids in its row range (zero elsewhere) and
  the lookups are summed over the model axis.  ``attend`` (the tied MLM
  projection) then gives each rank's logits over its rows, gathered over
  the model axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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
        self.tp = None  # a parallel.param_sharding.TensorParallel once sharded

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        clipped = ids.clamp(0, self.vocab_size - 1)
        if self.tp is None:
            out = self.embedding_table[clipped].to(self.dtype)
        else:
            tp, rows = self.tp, self.vocab_size // self.tp.size
            parts = []
            for i, rank in enumerate(tp.ranks):
                local = clipped - rank * rows
                inside = (local >= 0) & (local < rows)
                rows_i = tp.piece(self.embedding_table, i)[local.clamp(0, rows - 1)]
                parts.append(rows_i.to(self.dtype) * inside[..., None].to(self.dtype))
            out = tp.reduce(parts).to(self.dtype)
        if self.use_one_hot_lookup:
            valid = (ids >= 0) & (ids < self.vocab_size)
            out = out * valid[..., None].to(out.dtype)
        if self.embedding_projection is not None:
            out = dense(out, self.embedding_projection, self.dtype)
        return out

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., E] against the table -> logits [..., vocab] in x's dtype
        (the tied MLM projection); vocabulary-sharded, each rank's columns
        gathered over the model axis."""
        tp = self.tp
        if tp is None:
            return attend_table(self.embedding_table, x)
        x = tp.copy(x)
        return tp.gather([F.linear(x, tp.piece(self.embedding_table, i).to(x.dtype))
                          for i in range(len(tp.ranks))])


def attend_table(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [..., E] against a [vocab, E] table -> logits [..., vocab] in x's
    dtype."""
    return torch.matmul(x, table.to(x.dtype).t())
