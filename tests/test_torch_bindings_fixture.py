"""Binding targets for ``tests/test_torch_bindings.py`` (no tests here).

A module of its own because pytest imports test files under another
module name than the dotted path the bindings resolve through importlib,
so an attribute of the test module itself would be bound in the other
copy (as ``tests/fixtures_bindings.py`` explains for the JAX package).

* ``TUNABLE``: a module attribute to bind;
* ``TinyTorchEncoder``: a custom encoder for the ``encoder_cls`` injection
  point, with the port's contract; ``NoWordTableEncoder``: one the
  pretraining model's tied MLM head cannot use;
* ``TunableLoader``: a picklable ``loader_fn`` for ``multiprocess_batches``
  whose batch carries ``TUNABLE`` as a loader process sees it;
* ``slow_classification_load``: ``MmtClassificationLoader.load`` taking
  0.5 s more a batch, bound in place of it to keep a training process
  waiting on its loader processes (``tests/test_torch_preemption_cli.py``).
"""

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmt_tpu_torch.data.loaders import MmtClassificationLoader

TUNABLE = 1.0
_CLASSIFICATION_LOAD = MmtClassificationLoader.load


class _WordTable(nn.Module):
    def __init__(self, vocab_size, dim, device):
        super().__init__()
        self.embedding_table = nn.Parameter(torch.empty(vocab_size, dim, device=device))


class TinyTorchEncoder(nn.Module):
    """A word table (shared with the pretraining model's MLM head), a patch
    projection into slots [2, 2 + N) and one dense layer; returns the
    encoder output contract."""

    def __init__(self, config, num_patch_per_row=14, patch_dim=768, device=None):
        super().__init__()
        self.config = config
        self.num_patch_per_row = num_patch_per_row
        self.word_embeddings = _WordTable(config.vocab_size, config.hidden_size, device)
        self.patch_proj = nn.Linear(patch_dim, config.hidden_size, device=device)
        self.mix = nn.Linear(config.hidden_size, config.hidden_size, device=device)

    def forward(self, word_ids, segment_ids=None, patch_embeddings=None, lengths=None,
                rngs=None, images=None, patch_mask=None):
        emb = self.word_embeddings.embedding_table[word_ids.long()]
        if patch_embeddings is not None:
            n = patch_embeddings.shape[1]
            proj = self.patch_proj(patch_embeddings.float())
            emb = emb + F.pad(proj, (0, 0, 2, word_ids.shape[1] - 2 - n))
        return {"sequence_output": self.mix(emb).float()}


class NoWordTableEncoder(nn.Module):
    """An encoder without a word table for the MLM head to share."""

    def __init__(self, config, num_patch_per_row=14, patch_dim=768, device=None):
        super().__init__()
        self.mix = nn.Linear(config.hidden_size, config.hidden_size, device=device)


class TunableLoader:
    """``(shard, num_shards) ->`` one batch holding ``TUNABLE``."""

    def __call__(self, shard, num_shards):
        yield {"tunable": np.asarray([TUNABLE], np.float64), "shard": np.asarray([shard])}


def slow_classification_load(self, *args, **kwargs):
    for batch in _CLASSIFICATION_LOAD(self, *args, **kwargs):
        time.sleep(0.5)
        yield batch
