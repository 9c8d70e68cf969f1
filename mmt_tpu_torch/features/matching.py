"""ITM (image-text matching) in-batch negative mining.

The port's own copy of ``mmt_tpu/features/matching.py`` (numpy only),
itself ``src/data/data_utils.py:642-712`` (``get_matching_fn``) as a
host-side numpy batch transform:

1. Sort the batch so identical images (same image key) are adjacent --
   via first-occurrence ("unique") indices, exactly as the reference's
   ``tf.unique`` + ``tf.argsort``.
2. Tile image-side features ``(ratio + 1)`` times.
3. Build text permutations: copy 0 identity (positives), copy i >= 1
   rolled by ``min_shift + i`` (negatives).
4. Labels: first ``batch_size`` rows positive; ``itm_pos_weights``
   upweights positives by ``ratio - 1 (+1)``.
5. MLM/MPP label tensors follow the text permutation in lockstep.

Requires ``batch_size > ratio + 1 + min_shift`` (reference assertion,
``src/data/data_utils.py:647``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["make_matching_features"]

_TEXT_PERMUTED_KEYS = (
    "text_token_ids",
    "num_text_wordpieces",
    "mlm_positions",
    "mlm_label_ids",
    "mlm_label_weights",
    "mpp_positions",
    "mpp_label_ids",
    "mpp_label_weights",
)

_IMAGE_TILED_KEYS = (
    "patch_token_ids", "patch_embeddings", "num_image_wordpieces",
    "images", "patch_mask",  # ship_raw_images: device-side patch path
)


def _first_occurrence_ids(keys: Sequence) -> np.ndarray:
    """tf.unique-style ids: index of each element's first occurrence order."""
    seen: Dict = {}
    out = np.empty((len(keys),), dtype=np.int64)
    for i, k in enumerate(keys):
        k = k.tobytes() if isinstance(k, np.ndarray) else k
        if k not in seen:
            seen[k] = len(seen)
        out[i] = seen[k]
    return out


def make_matching_features(
    features: Dict[str, np.ndarray],
    image_keys: Sequence,
    negative_positive_ratio: int = 1,
    min_shift: int = 5,
) -> Dict[str, np.ndarray]:
    """Expands a batch with in-batch ITM negatives.

    Args:
      features: dict of batched arrays (leading dim = batch_size).
      image_keys: per-example image identity keys (popped image_key_field).

    Returns:
      New dict with leading dim ``batch_size * (ratio + 1)`` plus
      ``itm_label_ids`` <int32>, ``itm_label_weights`` / ``itm_pos_weights``
      <float32>.
    """
    batch_size = len(image_keys)
    if batch_size <= negative_positive_ratio + 1 + min_shift:
        raise ValueError(
            f"batch_size ({batch_size}) must exceed ratio+1+min_shift "
            f"({negative_positive_ratio + 1 + min_shift})."
        )
    if negative_positive_ratio <= 0:
        raise ValueError("negative_positive_ratio must be > 0.")

    sort_order = np.argsort(_first_occurrence_ids(image_keys), kind="stable")
    feats = {k: np.asarray(v)[sort_order] for k, v in features.items()}

    total = negative_positive_ratio + 1

    perms = [np.arange(batch_size)]
    for i in range(1, total):
        perms.append(np.roll(np.arange(batch_size), shift=min_shift + i))
    perm = np.concatenate(perms)

    out: Dict[str, np.ndarray] = {}
    for k, v in feats.items():
        if k in _IMAGE_TILED_KEYS:
            reps = (total,) + (1,) * (v.ndim - 1)
            out[k] = np.tile(v, reps)
        elif k in _TEXT_PERMUTED_KEYS:
            out[k] = v[perm]
        else:
            reps = (total,) + (1,) * (v.ndim - 1)
            out[k] = np.tile(v, reps)

    labels = np.zeros((batch_size * total,), dtype=np.int32)
    labels[:batch_size] = 1
    out["itm_label_ids"] = labels
    out["itm_label_weights"] = np.ones_like(labels, dtype=np.float32)
    out["itm_pos_weights"] = (
        1.0 + labels.astype(np.float32) * (negative_positive_ratio - 1)
    ).astype(np.float32)
    return out
