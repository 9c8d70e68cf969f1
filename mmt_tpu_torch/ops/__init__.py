"""Attention ops: the dense reference and the fused Hopper kernel."""

from mmt_tpu_torch.ops.fused_attention import (  # noqa: F401
    RelGeometry,
    relative_attention_forward,
    relative_attention_plain,
)
from mmt_tpu_torch.ops.relative_attention_ref import (  # noqa: F401
    gather_indexes,
    relative_attention_scores,
)
