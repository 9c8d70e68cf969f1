"""Encoder configuration: the fields and defaults of ``mmt_tpu/configs/encoder.py``.

The field names and values are kept so that yaml written for the JAX
package loads here unchanged.  ``attention_impl`` keeps its two values:
``"xla"`` selects the dense PyTorch attention and ``"pallas"`` the fused
Hopper kernel (``mmt_tpu_torch.ops.fused_attention``).  ``build_encoder``
is the ``encoder_cls`` injection point of both models, bindable as
``build_encoder.encoder_cls = @pkg.Encoder`` (``utils/bindings.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mmt_tpu_torch.configs.base import Config
from mmt_tpu_torch.utils.bindings import configurable, resolve_reference


@dataclasses.dataclass
class MmtEncoderConfig(Config):
    """Mmt encoder hyperparameters (same fields as the JAX package)."""

    vocab_size: int = 30522
    segment_vocab_size: int = 16
    # None => equal to hidden_size (BERT); smaller => ALBERT-style
    # factorized embeddings.
    embedding_size: Optional[int] = None
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    # 1D text relative position clipping distance.
    relative_pos_max_distance: int = 12
    # Learned relative-bias vocabulary.  IDs >= relative_vocab_size get a
    # zero bias (one-hot lookup semantics).
    relative_vocab_size: int = 32
    # > 0 => 2D image + 1D text ids with this core radius; 0 => 1D ids.
    relative_att_num_core_layers: int = 0
    max_absolute_position_embeddings: Optional[int] = None
    intermediate_size: int = 3072
    hidden_activation: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    use_pre_activation_order: bool = True
    use_one_hot_lookup: bool = True
    use_pooler_layer: bool = False

    # Computation dtype for matmuls/attention ("bfloat16" or "float32").
    # Parameters are always stored float32.
    compute_dtype: str = "bfloat16"
    # "xla" (dense attention) or "pallas" (fused relative-attention kernel).
    attention_impl: str = "xla"
    # Recompute each transformer layer's forward in the backward
    # (activation checkpointing per layer, as the JAX package's nn.remat).
    remat: bool = False
    # Tile sizes of the JAX package's TPU kernel.  Kept for yaml
    # compatibility; the Hopper kernel picks its own tiles.
    attention_block_q: int = 256
    attention_block_k: int = 512
    # Sliding-window pattern (0 = dense): text attends within +-window and
    # to the first attention_num_global slots (-1 = the image part, 2+P^2).
    attention_window: int = 0
    attention_num_global: int = -1
    # "none" or "int8_dynamic" (inference only; see mmt_tpu_torch/ops/quant.py).
    quantize: str = "none"


@dataclasses.dataclass
class EncoderConfig(Config):
    """OneOf-style wrapper (same fields as the JAX package)."""

    type: str = "mmt"
    mmt: MmtEncoderConfig = dataclasses.field(default_factory=MmtEncoderConfig)
    # Dotted import path ("pkg.mod.Class" or "pkg.mod:Class") of a custom
    # encoder class that build_encoder instantiates in place of MmtEncoder.
    encoder_cls: str = ""

    def get(self) -> MmtEncoderConfig:
        if self.type != "mmt":
            raise ValueError(f"Only 'mmt' encoders are supported, got {self.type!r}.")
        return self.mmt


@configurable
def build_encoder(config: EncoderConfig, num_patch_per_row: int, patch_dim: int,
                  device=None, encoder_cls=None):
    """The encoder of both models, with the ``encoder_cls`` injection point
    (``src/configs/encoders.py:112-158``).

    The class comes from the argument, else from a binding
    ``build_encoder.encoder_cls = @pkg.Encoder``, else from the config's
    dotted ``encoder_cls``, else it is ``MmtEncoder``.  A custom class is
    built as ``cls(config=<MmtEncoderConfig>, num_patch_per_row=...,
    patch_dim=..., device=...)``: an ``nn.Module`` whose forward takes
    ``MmtEncoder.forward``'s arguments and returns ``{"sequence_output":
    <float32>[B, S, H]}`` (and ``"pooled_output"``).  The model's
    ``init_params`` then fills its parameters with the rest.
    """
    cls = encoder_cls
    if cls is None and config.encoder_cls:
        cls = resolve_reference(config.encoder_cls)
    if cls is None:
        from mmt_tpu_torch.models.encoder import MmtEncoder  # deferred: models import configs

        cls = MmtEncoder
    return cls(config=config.get(), num_patch_per_row=num_patch_per_row, patch_dim=patch_dim,
               device=device)
