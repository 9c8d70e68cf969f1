"""Dummy (fake-data) input path (torch-port copy of ``mmt_tpu/data/dummy.py``).

The reference's ``input_path: 'dummy'`` smoke path: an infinite stream of
correctly shaped numpy batches, so the full train loop runs with no data.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from mmt_tpu_torch.configs.data import MmtPretrainDataConfig


def dummy_pretrain_batches(
    config: MmtPretrainDataConfig, batch_size: int = 0
) -> Iterator[dict]:
    b = batch_size or config.global_batch_size
    s = config.max_seq_len
    n = config.num_patches
    m = config.mlm_max_selections_per_seq
    p = config.mpp_max_selections_per_seq
    batch = {
        "word_ids": np.zeros((b, s), np.int32),
        "segment_ids": np.zeros((b, s), np.int32),
        "patch_embeddings": np.ones((b, n, 3 * config.patch_size**2), np.float32),
        "lengths": np.full((b,), s, np.int32),
        "mlm_positions": np.zeros((b, m), np.int32),
        "mlm_label_ids": np.zeros((b, m), np.int32),
        "mlm_label_weights": np.zeros((b, m), np.float32),
        "mpp_positions": np.zeros((b, p), np.int32),
        "mpp_label_ids": np.zeros((b, p), np.int32),
        "mpp_label_weights": np.zeros((b, p), np.float32),
        "itm_label_ids": np.zeros((b,), np.int32),
        "itm_label_weights": np.ones((b,), np.float32),
    }
    while True:
        yield batch
