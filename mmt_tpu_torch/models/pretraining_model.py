"""Pretraining model: encoder + MLM + MPP + classification heads.

Torch counterpart of ``mmt_tpu/models/pretraining_model.py``: returns
``sequence_output``, ``mlm_logits`` (with ``mlm_positions``),
``mpp_logits`` (with ``mpp_positions``) and ``<head>_logits`` per
classification head.  The encoder comes from ``configs.encoder.build_encoder``
(``MmtEncoder``, or the ``encoder_cls`` of a binding or of the config).  The image comes as ``patch_embeddings`` or as
``images`` (raw, at the model's image size) with MPP's ``patch_mask``; see
``MmtEncoder``.  The MLM output projection uses the encoder's word
embedding table when ``bind_word_embedding_table`` is set (the default),
else an untied ``mlm_embedding_table`` of the same shape.  Built on
``device`` (default ``"cuda"``, which raises without a GPU) with
parameters drawn from a numpy ``seed``; load converted Flax parameters
with ``convert.params_from_flax`` + ``load_state_dict``.  Dropout runs in
``train()`` mode from ``rngs``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from mmt_tpu_torch.configs.encoder import build_encoder
from mmt_tpu_torch.configs.model import PretrainModelConfig
from mmt_tpu_torch.device import resolve_device
from mmt_tpu_torch.models.common import DropoutRngs, init_params
from mmt_tpu_torch.models.embeddings import EmbeddingLookup, attend_table
from mmt_tpu_torch.models.encoder import compute_dtype
from mmt_tpu_torch.models.heads import ClassificationHead, MaskedLMHead, MaskedPPHead


class MmtPretrainingModel(nn.Module):
    def __init__(self, config: PretrainModelConfig, mpp_output_num_classes: int = 512,
                 num_patch_per_row: int = 14, patch_dim: int = 768, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        encoder_cfg = config.encoder.get()
        names = [h.name for h in config.cls_heads]
        if len(set(names)) != len(names):
            raise ValueError("Classification heads should have unique names.")
        self.config = config
        self.encoder = build_encoder(config.encoder, num_patch_per_row, patch_dim, device=dev)
        if config.bind_word_embedding_table and not hasattr(
                getattr(self.encoder, "word_embeddings", None), "embedding_table"):
            raise ValueError("bind_word_embedding_table: the encoder has no "
                             "word_embeddings.embedding_table for the MLM head to share")
        dtype = compute_dtype(encoder_cfg)
        emb_size = encoder_cfg.embedding_size or encoder_cfg.hidden_size
        self.mlm_embedding_table = None
        if not config.bind_word_embedding_table:
            self.mlm_embedding_table = nn.Parameter(
                torch.empty(encoder_cfg.vocab_size, emb_size, device=dev))
        self.masked_lm = MaskedLMHead(encoder_cfg.hidden_size, emb_size, encoder_cfg.vocab_size,
                                      config.mlm_activation, dtype=dtype, device=dev)
        self.masked_pp = MaskedPPHead(encoder_cfg.hidden_size, mpp_output_num_classes,
                                      config.mpp_activation, dtype=dtype, device=dev)
        self.cls_heads = nn.ModuleDict({
            str(h.name): ClassificationHead(
                encoder_cfg.hidden_size, h.inner_dim, h.num_classes, h.activation,
                h.cls_token_idx, dtype=dtype, dropout_rate=h.dropout_rate, device=dev)
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
        mlm_positions: Optional[torch.Tensor] = None,
        mpp_positions: Optional[torch.Tensor] = None,
        rngs: Optional[DropoutRngs] = None,
        images: Optional[torch.Tensor] = None,
        patch_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        outputs = self.encoder(word_ids, segment_ids, patch_embeddings, lengths, rngs,
                               images=images, patch_mask=patch_mask)
        outputs.update(self.head_outputs(outputs["sequence_output"], mlm_positions,
                                         mpp_positions, rngs))
        return outputs

    def _mlm_attend(self):
        """The MLM output projection: the word table's ``attend`` (which a
        tensor-parallel model runs vocabulary-sharded), or the untied table,
        or a custom encoder's shared ``embedding_table``."""
        words = self.encoder.word_embeddings if self.mlm_embedding_table is None else None
        if isinstance(words, EmbeddingLookup):
            return words.attend
        table = self.mlm_embedding_table if words is None else words.embedding_table
        return functools.partial(attend_table, table)

    def encoder_inputs(self, *args, **kwargs):
        """The encoder's ``transformer_inputs`` (embeddings and lengths), for
        a scheduler that runs the layer stack itself
        (``parallel/pipeline.py``)."""
        return self.encoder.transformer_inputs(*args, **kwargs)

    def head_outputs(self, sequence: torch.Tensor, mlm_positions: Optional[torch.Tensor] = None,
                     mpp_positions: Optional[torch.Tensor] = None,
                     rngs: Optional[DropoutRngs] = None) -> Dict[str, torch.Tensor]:
        """Everything after the encoder: the MLM, MPP and classification
        logits over a ready float32 [B, S, H] sequence output."""
        outputs = {}
        if mlm_positions is not None:
            outputs["mlm_logits"] = self.masked_lm(sequence, mlm_positions, self._mlm_attend())
        if mpp_positions is not None:
            outputs["mpp_logits"] = self.masked_pp(sequence, mpp_positions)
        for name, head in self.cls_heads.items():
            outputs[f"{name}_logits"] = head(sequence, rngs)
        return outputs
