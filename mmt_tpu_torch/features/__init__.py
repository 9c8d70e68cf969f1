"""Feature functions: relative-position ids and attention masks."""

from mmt_tpu_torch.features.attention_mask import (  # noqa: F401
    make_att_mask_from_length,
    make_segmented_att_mask,
)
from mmt_tpu_torch.features.relative_position import (  # noqa: F401
    MmtRelativePositionGenerator,
    RelativePositionGenerator,
)
