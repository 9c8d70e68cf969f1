"""MmtEncoder: the multimodal relative-attention encoder.

Torch counterpart of ``mmt_tpu/models/encoder.py``, with its semantics:

* LayerNorm (eps 1e-12, float32) is applied to the **word embeddings
  only**; segment, absolute-position and projected-patch embeddings are
  added after it.
* Patch embeddings are projected ``patch_dim -> hidden`` and added in
  sequence slots ``[2, 2 + N)`` ([CLS] and [PATCH] occupy 0 and 1), while
  the 2D relative ids cover positions ``[0, P**2)``: the reference's
  misalignment, kept.
* ``segment_ids=None`` defaults to all ones; ``lengths=None`` means every
  position is real.
* Dropout in ``train()`` mode: on the layer-normed word embeddings (the
  JAX encoder's ``embedding_dropout``, before the segment, position and
  patch embeddings are added), and inside every layer (see
  ``relative_attention``), from the streams of ``DropoutRngs``.
* The pooler output, when enabled, is returned as ``"pooled_output"``.

The attention id map, padding mask and sliding-window pattern are
derived from the static geometry and ``lengths`` inside the attention op.
``attention_window > 0`` lets text attend within the window; the first
``attention_num_global`` slots (-1: the image part, ``2 + P**2``, as in
the JAX encoder) attend and are attended everywhere.  ``remat`` recomputes
each layer's forward in the backward (see ``relative_attention``).
Unlike the JAX encoder, there is no gate requiring the image block to fit
one kernel tile: the Hopper kernel applies the 2D ids on every tile that
meets it.  ``images`` (raw uint8 or [0, 1] float, already at the model's
image size) takes the place of ``patch_embeddings``: /255, normalisation and
patch extraction then run here, on the model's device, and ``patch_mask``
(<float>[B, N], MPP's masked patches from a ``ship_raw_images`` batch)
zeroes those patches' features before the projection, as the host
pipeline zeroes them in ``patch_embeddings``.  ``quantize="int8_dynamic"``
runs the layers' projections and FFN in dynamic int8 (``ops/quant.py``;
inference only, as in JAX).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmt_tpu_torch.configs.encoder import MmtEncoderConfig
from mmt_tpu_torch.features.patches import extract_patches, normalize_image
from mmt_tpu_torch.models.common import DropoutRngs, dense, layer_norm
from mmt_tpu_torch.models.embeddings import EmbeddingLookup
from mmt_tpu_torch.models.relative_attention import RelativeTransformerLayers
from mmt_tpu_torch.ops.fused_attention import RelGeometry

_NUM_OTHER_RELATIVE_IDS = 3
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(config: MmtEncoderConfig) -> torch.dtype:
    """The torch dtype of ``config.compute_dtype``; ValueError for others."""
    if config.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    return _DTYPES[config.compute_dtype]


def encoder_geometry(config: MmtEncoderConfig, num_patch_per_row: int) -> Optional[RelGeometry]:
    """The relative-id and attention-pattern geometry of a config, or None
    when it has no bias.

    ``attention_num_global < 0`` means the whole image part is global:
    [CLS] [PATCH] and the P**2 patches, slots [0, 2 + P**2)
    (``mmt_tpu/models/encoder.py:145-153``), while the 2D ids cover
    [0, P**2): the reference's misalignment, kept.
    """
    num_global = config.attention_num_global
    if num_global < 0:
        num_global = 2 + num_patch_per_row**2
    if not (config.relative_vocab_size and config.relative_pos_max_distance):
        if config.attention_window > 0:
            raise ValueError("attention_window > 0 requires the relative-bias geometry")
        return None
    return RelGeometry(
        text_max_distance=config.relative_pos_max_distance,
        num_patch_per_row=num_patch_per_row,
        num_core_layers=config.relative_att_num_core_layers,
        window=config.attention_window,
        num_global=num_global,
    )


class MmtEncoder(nn.Module):
    def __init__(self, config: MmtEncoderConfig, num_patch_per_row: int = 14,
                 patch_dim: int = 768, device=None):
        super().__init__()
        cfg = config
        if cfg.relative_vocab_size is None:
            if cfg.relative_pos_max_distance != 0:
                raise ValueError(
                    "`relative_pos_max_distance` must be 0 when "
                    "`relative_vocab_size` is None.")
        elif cfg.relative_vocab_size < (
            2 * cfg.relative_pos_max_distance + 1 + _NUM_OTHER_RELATIVE_IDS
        ):
            raise ValueError(
                f"`relative_vocab_size` ({cfg.relative_vocab_size}) too small for "
                f"`relative_pos_max_distance` ({cfg.relative_pos_max_distance})")
        self.config = cfg
        self.num_patch_per_row = num_patch_per_row
        self.dtype = compute_dtype(cfg)
        emb_size = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = EmbeddingLookup(
            cfg.vocab_size, emb_size, cfg.hidden_size, use_one_hot_lookup=False,
            dtype=self.dtype, device=device)
        self.segment_embeddings = EmbeddingLookup(
            cfg.segment_vocab_size, emb_size, cfg.hidden_size,
            use_one_hot_lookup=cfg.use_one_hot_lookup, dtype=self.dtype, device=device)
        self.absolute_position_embeddings = None
        if cfg.max_absolute_position_embeddings:
            self.absolute_position_embeddings = nn.Parameter(torch.empty(
                cfg.max_absolute_position_embeddings, cfg.hidden_size, device=device))
        self.patch_embedding_projection = nn.Linear(patch_dim, cfg.hidden_size, device=device)
        self.embeddings_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-12, device=device)
        self.transformer = RelativeTransformerLayers(
            cfg.num_hidden_layers,
            hidden_size=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            relative_vocab_size=cfg.relative_vocab_size,
            geometry=encoder_geometry(cfg, num_patch_per_row),
            dtype=self.dtype,
            use_pre_activation_order=cfg.use_pre_activation_order,
            attention_impl=cfg.attention_impl,
            hidden_dropout=cfg.hidden_dropout_prob,
            attention_dropout=cfg.attention_probs_dropout_prob,
            remat=cfg.remat,
            quantize=cfg.quantize,
            device=device,
        )
        self.pooler_transform = None
        if cfg.use_pooler_layer:
            self.pooler_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(
        self,
        word_ids: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
        patch_embeddings: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        rngs: Optional[DropoutRngs] = None,
        images: Optional[torch.Tensor] = None,
        patch_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Returns ``sequence_output`` [B, S, H] (float32) and, with the
        pooler on, ``pooled_output`` [B, H].  ``rngs`` feeds the dropout
        in ``train()`` mode (torch's default generators when None).
        ``images`` (<uint8|float>[B, size, size, 3]) is used when
        ``patch_embeddings`` is None, and ``patch_mask`` (<float>[B, N], 1
        where MPP masked a patch) zeroes masked patches of ``images``."""
        rngs = rngs or DropoutRngs()
        emb, lengths = self.transformer_inputs(word_ids, segment_ids, patch_embeddings, lengths,
                                               rngs, images, patch_mask)
        x = self.transformer(emb, lengths, rngs).float()
        outputs = {"sequence_output": x}
        if self.pooler_transform is not None:
            outputs["pooled_output"] = torch.tanh(
                dense(x[:, 0], self.pooler_transform, self.dtype).float())
        return outputs

    def transformer_inputs(
        self,
        word_ids: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
        patch_embeddings: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        rngs: Optional[DropoutRngs] = None,
        images: Optional[torch.Tensor] = None,
        patch_mask: Optional[torch.Tensor] = None,
    ):
        """Everything before the layer stack (``mmt_tpu/models/encoder.py:
        transformer_inputs``): (embeddings in the compute dtype [B, S, H],
        lengths <int>[B]), exactly what ``forward`` feeds
        ``self.transformer``, so that another scheduler of the layers
        (``parallel/pipeline.py``) can run the stack itself.  Arguments as
        in ``forward``."""
        batch, seq_len = word_ids.shape
        if patch_embeddings is None and images is not None:
            im = images
            if im.dtype != torch.float32:
                im = im.to(torch.float32) / 255.0
            patch_size = im.shape[1] // self.num_patch_per_row
            patch_embeddings = extract_patches(normalize_image(im), patch_size)
            if patch_mask is not None:
                # The host pipeline's zeroing, in its order: after /255,
                # normalisation and extraction, before the projection's cast.
                patch_embeddings = patch_embeddings * (
                    1.0 - patch_mask[..., None].to(patch_embeddings.dtype))
        if segment_ids is None:
            segment_ids = torch.ones_like(word_ids)
        if lengths is None:
            lengths = torch.full((batch,), seq_len, dtype=torch.int32, device=word_ids.device)

        rngs = rngs or DropoutRngs()
        emb = layer_norm(self.word_embeddings(word_ids), self.embeddings_layer_norm)
        emb = rngs.dropout(emb, self.config.hidden_dropout_prob, self.training)
        emb = emb + self.segment_embeddings(segment_ids)
        if self.absolute_position_embeddings is not None:
            emb = emb + self.absolute_position_embeddings[None, :seq_len]
        if patch_embeddings is not None:
            num_patches = patch_embeddings.shape[1]
            projected = dense(patch_embeddings, self.patch_embedding_projection, self.dtype)
            emb = emb + F.pad(projected, (0, 0, 2, seq_len - 2 - num_patches))

        return emb.to(self.dtype), lengths
