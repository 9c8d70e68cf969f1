"""Text processing: BERT-compatible WordPiece tokenization + trimming."""

from mmt_tpu_torch.text.trimmer import round_robin_trim  # noqa: F401
from mmt_tpu_torch.text.wordpiece import (  # noqa: F401
    BasicTokenizer,
    BertTokenizer,
    WordpieceTokenizer,
    load_vocab,
)
