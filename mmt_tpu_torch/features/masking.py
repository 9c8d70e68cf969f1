"""MLM / MPP masking: selection, value choice, label construction.

The port's own copy of ``mmt_tpu/features/masking.py`` (numpy only),
itself the reference's masking pipeline (``src/data/data_utils.py:383-639``:
``tf_text.RandomItemSelector`` + ``MaskValuesChooser`` +
``mask_language_model``) as a host-side stage of the input pipeline with a
pluggable numpy ``rng``:

* Whole-word MLM: selection operates on *words* (lists of wordpieces);
  when a word is selected every wordpiece in it is masked.  The 80/10/10
  mask/random/keep choice is made per wordpiece.
* MPP: selection operates on patch tokens; chosen patches' token ids are
  replaced the same way (80% -> mask token), and the loader zeroes the
  *embeddings* of patches whose token became the mask token.
* Label weights quirk (kept): weights are 1.0 for the first
  ``count(token == mask_token)`` selections, so the 10% random and 10%
  kept selections are *under*-counted exactly as in the reference's
  ``get_masked_weights`` (``src/data/data_utils.py:483-504``).
* Number selected: ``min(max_selections, ceil(rate * num_selectable))``.

The rng is drawn in the JAX package's order (one permutation, then per
selected wordpiece one uniform and, for a random replacement, one
integer), so the same seed gives the same masks in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["MaskingSpec", "MaskedResult", "mask_items", "pad_1d"]


@dataclasses.dataclass
class MaskingSpec:
    """Parameters for one masking task (MLM or MPP)."""

    vocab_size: int
    mask_token_id: int
    selection_rate: float
    max_selections: int
    mask_prob: float = 0.8  # P(replace with mask token)
    random_prob: float = 0.1  # P(replace with random vocab token)


@dataclasses.dataclass
class MaskedResult:
    token_ids: np.ndarray  # <int32>[seq_len] tokens after masking
    positions: np.ndarray  # <int32>[num_selected] wordpiece positions
    label_ids: np.ndarray  # <int32>[num_selected] original token ids
    label_weights: np.ndarray  # <float32>[num_selected]


def pad_1d(x: np.ndarray, length: int, value=0) -> np.ndarray:
    """Right-pad (or cut) a 1D array to ``length``."""
    if x.shape[0] >= length:
        return x[:length]
    out = np.full((length,), value, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _choose_value(out: np.ndarray, pos, spec: MaskingSpec, rng) -> None:
    """The 80/10/10 choice for one wordpiece, in place."""
    u = rng.random()
    if u < spec.mask_prob:
        out[pos] = spec.mask_token_id
    elif u < spec.mask_prob + spec.random_prob:
        out[pos] = int(rng.integers(0, spec.vocab_size))
    # else: keep the original token.


def mask_items(
    items: Sequence[np.ndarray],
    spec: MaskingSpec,
    rng: np.random.Generator,
    selectable: Optional[np.ndarray] = None,
) -> MaskedResult:
    """Masks whole items (words or patches) within one example.

    Args:
      items: one <int32>[num_wordpieces_i] array per selectable unit (a
        whole word for MLM), or one 1D array of single tokens (the MPP
        patch case).  Special tokens are items with ``selectable[i]``
        false.
      spec: masking parameters.
      rng: numpy Generator.
      selectable: <bool>[num_items]; defaults to all True.

    Returns:
      ``MaskedResult`` over the *flattened* wordpiece sequence.
    """
    num_items = len(items)
    if selectable is None:
        selectable = np.ones((num_items,), dtype=bool)
    selectable = np.asarray(selectable, dtype=bool)

    single_tokens = isinstance(items, np.ndarray) and items.ndim == 1
    if single_tokens:
        flat = items.astype(np.int32)
    else:
        item_lengths = np.array([len(it) for it in items], dtype=np.int64)
        item_offsets = np.concatenate([[0], np.cumsum(item_lengths)[:-1]])
        flat = (np.concatenate(items).astype(np.int32)
                if num_items else np.zeros((0,), np.int32))

    candidate_idx = np.nonzero(selectable)[0]
    num_to_select = min(
        spec.max_selections, int(math.ceil(spec.selection_rate * len(candidate_idx))))
    if num_to_select > 0:
        chosen_items = np.sort(rng.permutation(candidate_idx)[:num_to_select])
    else:
        chosen_items = np.zeros((0,), dtype=np.int64)

    out = flat.copy()
    if single_tokens:
        positions_arr = chosen_items.astype(np.int32)
        labels_arr = flat[chosen_items].astype(np.int32)
        for pos in chosen_items:
            _choose_value(out, pos, spec, rng)
    else:
        positions: List[int] = []
        for it in chosen_items:
            for j in range(item_lengths[it]):
                pos = int(item_offsets[it] + j)
                positions.append(pos)
                _choose_value(out, pos, spec, rng)
        positions_arr = np.asarray(positions, dtype=np.int32)
        labels_arr = flat[positions_arr].astype(np.int32)

    # The label-weight quirk: count only literal mask tokens in the masked
    # sequence (src/data/data_utils.py:483-504).
    num_literal_masks = int(np.sum(out == spec.mask_token_id))
    weights = (np.arange(len(positions_arr)) < num_literal_masks).astype(np.float32)
    return MaskedResult(token_ids=out, positions=positions_arr, label_ids=labels_arr,
                        label_weights=weights)
