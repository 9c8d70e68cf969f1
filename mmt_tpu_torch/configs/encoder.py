"""Encoder configuration: the fields and defaults of ``mmt_tpu/configs/encoder.py``.

The field names and values are kept so that yaml written for the JAX
package loads here unchanged.  ``attention_impl`` keeps its two values:
``"xla"`` selects the dense PyTorch attention and ``"pallas"`` the fused
Hopper kernel (``mmt_tpu_torch.ops.fused_attention``).  The
``encoder_cls`` injection point is kept as a field for yaml
compatibility; the port's encoder raises when it is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mmt_tpu_torch.configs.base import Config


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
    # "none" only in the port; "int8_dynamic" raises.
    quantize: str = "none"


@dataclasses.dataclass
class EncoderConfig(Config):
    """OneOf-style wrapper (same fields as the JAX package)."""

    type: str = "mmt"
    mmt: MmtEncoderConfig = dataclasses.field(default_factory=MmtEncoderConfig)
    # Dotted import path of a custom encoder class; not supported by the
    # port yet (the encoder raises when it is set).
    encoder_cls: str = ""

    def get(self) -> MmtEncoderConfig:
        if self.type != "mmt":
            raise ValueError(f"Only 'mmt' encoders are supported, got {self.type!r}.")
        return self.mmt
