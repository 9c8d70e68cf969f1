"""Task heads: torch counterparts of ``mmt_tpu/models/heads.py``.

* ``MaskedLMHead``: gather the masked positions, dense(embedding width) +
  activation, LayerNorm, logits = x . table^T + output bias, with the
  (tied or untied) table handed in by the model.
* ``MaskedPPHead``: gather, LayerNorm, dense(num_classes), then the
  configured activation on the class projection (the reference's quirk,
  kept) and an extra output bias.
* ``ClassificationHead``: cls-token slice, dense(inner_dim) + activation,
  dropout (``train()`` mode), dense(num_classes).

All logits are float32.  The products run in the compute dtype; the MLM
logits are the compute-dtype product cast to float32 (the JAX head
accumulates that product into float32 without rounding it; in float32
compute the two are the same).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from mmt_tpu_torch.models.common import DropoutRngs, activation, dense, layer_norm
from mmt_tpu_torch.ops.relative_attention_ref import gather_indexes


class MaskedLMHead(nn.Module):
    """MLM head -> [B, M, vocab] logits against a table whose projection is
    handed in at call time."""

    def __init__(self, hidden_size: int, embedding_size: int, vocab_size: int,
                 activation_name: Optional[str] = "gelu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.activation = activation(activation_name)
        self.transform_dense = nn.Linear(hidden_size, embedding_size, device=device)
        self.transform_dense.glorot_init = True
        self.transform_layer_norm = nn.LayerNorm(embedding_size, eps=1e-12, device=device)
        self.output_bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, sequence: torch.Tensor, positions: torch.Tensor,
                attend: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``attend``: x [..., E] -> its logits against the output table
        (``EmbeddingLookup.attend``, or ``embeddings.attend_table``)."""
        x = self.activation(dense(gather_indexes(sequence, positions), self.transform_dense,
                                  self.dtype))
        x = layer_norm(x, self.transform_layer_norm)
        return attend(x.to(self.dtype)).float() + self.output_bias


class MaskedPPHead(nn.Module):
    """Masked patch prediction head -> [B, M, num_classes] logits."""

    def __init__(self, hidden_size: int, num_classes: int,
                 activation_name: Optional[str] = "gelu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.activation = activation(activation_name)
        self.transform_layer_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.transform_dense = nn.Linear(hidden_size, num_classes, device=device)
        self.transform_dense.glorot_init = True
        self.output_bias = nn.Parameter(torch.zeros(num_classes, device=device))

    def forward(self, sequence: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = layer_norm(gather_indexes(sequence, positions), self.transform_layer_norm)
        x = self.activation(dense(x, self.transform_dense, self.dtype))
        return x.float() + self.output_bias


class ClassificationHead(nn.Module):
    def __init__(self, hidden_size: int, inner_dim: int, num_classes: int,
                 activation_name: Optional[str] = "tanh", cls_token_idx: int = 0,
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.cls_token_idx = cls_token_idx
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.activation = activation(activation_name)
        self.pooler_dense = None
        if inner_dim:
            self.pooler_dense = nn.Linear(hidden_size, inner_dim, device=device)
        self.out_proj = nn.Linear(inner_dim or hidden_size, num_classes, device=device)

    def forward(self, sequence: torch.Tensor,
                rngs: Optional[DropoutRngs] = None) -> torch.Tensor:
        x = sequence[:, self.cls_token_idx]
        if self.pooler_dense is not None:
            x = self.activation(dense(x, self.pooler_dense, self.dtype))
        x = (rngs or DropoutRngs()).dropout(x, self.dropout_rate, self.training)
        return dense(x, self.out_proj, self.dtype).float()
