"""Feature functions: relative-position ids, attention masks, image patches,
MPP labels."""

from mmt_tpu_torch.features.attention_mask import (  # noqa: F401
    make_att_mask_from_length,
    make_segment_ids,
    make_segmented_att_mask,
)
from mmt_tpu_torch.features.patches import (  # noqa: F401
    extract_patches,
    make_mpp_label_ids,
    normalize_image,
)
from mmt_tpu_torch.features.relative_position import (  # noqa: F401
    MmtRelativePositionGenerator,
    RelativePositionGenerator,
)
