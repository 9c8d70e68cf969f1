"""Data configurations, with the fields and defaults of
``mmt_tpu/configs/data.py`` so that the JAX package's yaml loads here to
the same values.

Record loaders: pretraining, classification and retrieval
(``mmt_tpu_torch.data.loaders``); pretraining also runs on ``input_path:
dummy`` (``mmt_tpu_torch.data.dummy``).  ``num_workers > 0`` runs the
training loader in that many processes (``mmt_tpu_torch.data.prefetch``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mmt_tpu_torch.configs.base import Config


@dataclasses.dataclass
class MmtDataConfig(Config):
    """Shared data config (same fields and defaults as the JAX package)."""

    seed: int = 128
    input_path: str = ""
    num_examples: int = 0
    vocab_filename: str = ""
    is_training: bool = True
    global_batch_size: int = 256
    cycle_length: int = 8
    deterministic: bool = True

    image_data_field: str = "image_data"
    text_special_token_field_dict: str = (
        '{"caption_attribution_description": "[ATT]",'
        ' "caption_reference_description":"[REF]"}'
    )
    image_key_field: str = "image_key"
    tasks: str = ""
    patch_size: int = 16
    image_size: int = 224
    patch_order: str = "raster_scan"
    max_pixel_val: int = 256
    max_seq_len: int = 512
    input_channels: int = 3

    relative_pos_max_distance: int = 12
    relative_att_num_core_layers: int = 0

    label_field: Optional[str] = None
    label_weights_field: Optional[str] = None
    logits_field: Optional[str] = None
    pos_weights_field: Optional[str] = None

    min_shift: int = 5
    shuffle_buffer_size: int = 4096
    use_rand_aug: bool = False
    drop_remainder: bool = True
    num_workers: int = 0
    device_side_inputs: bool = True
    ship_raw_images: bool = False

    @property
    def num_patch_per_row(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patch_per_row**2


@dataclasses.dataclass
class MmtPretrainDataConfig(MmtDataConfig):
    """Pretraining data (same fields and defaults as the JAX package)."""

    is_training: bool = True
    mlm_use_whole_word: bool = True
    mlm_fraction_to_mask: float = 0.15
    mpp_fraction_to_mask: float = 0.5
    mlm_max_selections_per_seq: int = 256
    mpp_max_selections_per_seq: int = 98
    output_channel_bits: int = 3
    use_patch_mask_token_id: bool = False
    min_text_wordpieces: int = 6


@dataclasses.dataclass
class MmtClassificationDataConfig(MmtDataConfig):
    """Classification data (same fields and defaults as the JAX package)."""

    negative_positive_ratio: int = 1
    pos_weight: float = 1.0


@dataclasses.dataclass
class MmtRetrievalDataConfig(MmtDataConfig):
    """Retrieval data (same fields and defaults as the JAX package)."""

    is_training: bool = False
    drop_remainder: bool = False
    include_image_text_index: bool = True
    pos_weight: float = 1.0
    # Either paired records (input_path) or an on-the-fly cross product of
    # separate image x text record files.
    image_input_path: str = ""
    text_input_path: str = ""
    num_image_examples: int = 0
    num_text_examples: int = 0
    # Cross-product RAM bound: decoded text features beyond this count
    # are re-streamed from disk per image instead of cached.
    max_cached_text_examples: int = 200_000
