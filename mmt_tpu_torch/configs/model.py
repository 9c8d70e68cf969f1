"""Classification-model configurations (fields of ``mmt_tpu/configs/model.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from mmt_tpu_torch.configs.base import Config
from mmt_tpu_torch.configs.encoder import EncoderConfig


@dataclasses.dataclass
class ClsHeadConfig(Config):
    """Classification head: cls-token slice, dense + activation, dense."""

    inner_dim: int = 0
    num_classes: int = 2
    activation: Optional[str] = "tanh"
    dropout_rate: float = 0.0
    cls_token_idx: int = 0
    name: Optional[str] = None


@dataclasses.dataclass
class ClassificationModelConfig(Config):
    """Encoder plus classification heads."""

    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    num_classes: int = 0
    cls_heads: List[ClsHeadConfig] = dataclasses.field(default_factory=list)
