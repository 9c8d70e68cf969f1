"""Classification model: encoder + classification heads.

Torch counterpart of ``mmt_tpu/models/classification_model.py``: returns
``sequence_output`` plus ``<head>_logits`` per head.  The encoder comes
from ``configs.encoder.build_encoder`` (``MmtEncoder``, or the
``encoder_cls`` of a binding or of the config).  The model is built
on ``device`` (default ``"cuda"``, which raises when no GPU is present)
with parameters drawn from a numpy ``seed``; load converted Flax
parameters with ``convert.params_from_flax`` + ``load_state_dict``.
Dropout runs in ``train()`` mode from ``rngs`` (see ``DropoutRngs``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mmt_tpu_torch.configs.encoder import build_encoder
from mmt_tpu_torch.configs.model import ClassificationModelConfig
from mmt_tpu_torch.device import resolve_device
from mmt_tpu_torch.models.common import DropoutRngs, init_params
from mmt_tpu_torch.models.encoder import compute_dtype
from mmt_tpu_torch.models.heads import ClassificationHead


class MmtClassificationModel(nn.Module):
    def __init__(self, config: ClassificationModelConfig, num_patch_per_row: int = 14,
                 patch_dim: int = 768, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        encoder_cfg = config.encoder.get()
        names = [h.name for h in config.cls_heads]
        if len(set(names)) != len(names):
            raise ValueError("Classification heads should have unique names.")
        self.config = config
        self.encoder = build_encoder(config.encoder, num_patch_per_row, patch_dim, device=dev)
        self.cls_heads = nn.ModuleDict({
            str(h.name): ClassificationHead(
                encoder_cfg.hidden_size, h.inner_dim, h.num_classes, h.activation,
                h.cls_token_idx, dtype=compute_dtype(encoder_cfg), dropout_rate=h.dropout_rate,
                device=dev)
            for h in config.cls_heads
        })
        init_params(self, seed, encoder_cfg.initializer_range)
        self.eval()  # dropout off until train(), as JAX's deterministic=True default

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(
        self,
        word_ids: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
        patch_embeddings: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        rngs: Optional[DropoutRngs] = None,
        images: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        outputs = self.encoder(word_ids, segment_ids, patch_embeddings, lengths, rngs,
                               images=images)
        outputs.update(self.head_outputs(outputs["sequence_output"], rngs))
        return outputs

    def encoder_inputs(self, *args, **kwargs):
        """The encoder's ``transformer_inputs`` (embeddings and lengths), for
        a scheduler that runs the layer stack itself
        (``parallel/pipeline.py``)."""
        return self.encoder.transformer_inputs(*args, **kwargs)

    def head_outputs(self, sequence: torch.Tensor,
                     rngs: Optional[DropoutRngs] = None) -> Dict[str, torch.Tensor]:
        """The classification heads' logits over a ready float32 [B, S, H]
        sequence output."""
        return {f"{name}_logits": head(sequence, rngs) for name, head in self.cls_heads.items()}
