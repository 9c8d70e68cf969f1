"""The MMT model family in PyTorch (inference)."""

from mmt_tpu_torch.models.classification_model import MmtClassificationModel  # noqa: F401
from mmt_tpu_torch.models.embeddings import EmbeddingLookup  # noqa: F401
from mmt_tpu_torch.models.encoder import MmtEncoder  # noqa: F401
from mmt_tpu_torch.models.heads import ClassificationHead  # noqa: F401
from mmt_tpu_torch.models.relative_attention import (  # noqa: F401
    RelativeAttention,
    RelativeTransformerLayer,
    RelativeTransformerLayers,
)
