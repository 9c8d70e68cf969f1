"""Feature functions: relative-position ids, attention masks, image patches."""

from mmt_tpu_torch.features.attention_mask import (  # noqa: F401
    make_att_mask_from_length,
    make_segment_ids,
    make_segmented_att_mask,
)
from mmt_tpu_torch.features.patches import extract_patches, normalize_image  # noqa: F401
from mmt_tpu_torch.features.relative_position import (  # noqa: F401
    MmtRelativePositionGenerator,
    RelativePositionGenerator,
)
