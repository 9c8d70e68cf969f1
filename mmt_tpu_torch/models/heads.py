"""ClassificationHead: torch counterpart of ``mmt_tpu/models/heads.py:ClassificationHead``.

Cls-token slice, dense(inner_dim) + activation, dense(num_classes);
float32 logits.  Inference only: the head's dropout is not applied.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmt_tpu_torch.models.common import activation, dense


class ClassificationHead(nn.Module):
    def __init__(self, hidden_size: int, inner_dim: int, num_classes: int,
                 activation_name: Optional[str] = "tanh", cls_token_idx: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cls_token_idx = cls_token_idx
        self.dtype = dtype
        self.activation = activation(activation_name)
        self.pooler_dense = None
        if inner_dim:
            self.pooler_dense = nn.Linear(hidden_size, inner_dim, device=device)
        self.out_proj = nn.Linear(inner_dim or hidden_size, num_classes, device=device)

    def forward(self, sequence: torch.Tensor) -> torch.Tensor:
        x = sequence[:, self.cls_token_idx]
        if self.pooler_dense is not None:
            x = self.activation(dense(x, self.pooler_dense, self.dtype))
        return dense(x, self.out_proj, self.dtype).float()
