"""From-ViT warm start: TF ViT checkpoint -> the port's MmtEncoder tensors.

The port's counterpart of ``mmt_tpu/train/vit_checkpoint.py``.  Parity
surface: the reference's ``*_from_vit`` experiments
(``src/exp_yamls/pretrain/wit/mlm_itm_from_vit.yaml``) restore a
pretrained ViT via the same object-checkpoint mechanism as any other
warm start (``src/tasks/pretraining.py:341-351``, ``expect_partial``),
with ``max_absolute_position_embeddings: 578`` enabling the absolute
position table (``src/modeling/models/mmt_encoder.py:97-103``).  578 =
2 special slots ([CLS] [PATCH]) + 24^2 patches: the ViT is an
image-only model with the MMT encoder layout, so its variables align
with the encoder's object paths and ``expect_partial`` leaves the
text-specific tables (word/segment embeddings, relative-bias tables,
heads) freshly initialized.

This converter reproduces that behavior and adds two conveniences:

* conv-style patch kernels ``[p, p, 3, H]`` are reshaped to the
  encoder's flattened ``[3*p^2, H]`` projection (raster [py, px, c]
  order -- matching ``features.patches.extract_patches``);
* position tables whose patch grid differs from the target are
  bilinearly interpolated (the standard ViT grid-resize trick), keeping
  the 2 special-slot rows and copying any text-position rows that both
  tables cover.

Strictness: every *image-relevant* encoder parameter (patch projection,
position table, embedding norm, transformer stack, pooler if present)
must be matched or conversion raises; text-specific parameters are the
only ones allowed to stay fresh.  The JAX package finds the leaves left
untouched by object identity; a state dict has none, so the port tracks
the set of tensors the conversion assigned.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from mmt_tpu_torch.convert import flax_paths
from mmt_tpu_torch.train.tf_checkpoint import convert_tf_checkpoint

# Target path prefixes that a ViT (image-only) checkpoint legitimately
# cannot provide; everything else under encoder/ must be matched.
_TEXT_ONLY_PREFIXES = (
    ("encoder", "word_embeddings"),
    ("encoder", "segment_embeddings"),
)
_TEXT_ONLY_SUFFIXES = ("relative_emb_table",)


def interpolate_position_embeddings(
    table: np.ndarray, target_len: int, num_special: int = 2
) -> np.ndarray:
    """Resizes a [2 + P^2 (+ text), H] MMT position table to target_len.

    The patch-grid block (rows [num_special, num_special + P^2)) is
    bilinearly resized from PxP to P'xP' where P'^2 fills the target's
    grid; special rows are copied; leftover trailing rows are copied
    where both tables have them (extra target rows keep zeros -- callers
    merge over fresh inits).
    """
    src_len, hidden = table.shape
    if src_len == target_len:
        return table
    src_grid = int(round((src_len - num_special) ** 0.5))
    tgt_grid = int(round((target_len - num_special) ** 0.5))
    if src_grid * src_grid != src_len - num_special or \
            tgt_grid * tgt_grid != target_len - num_special:
        # Not pure special+grid tables: length-interpolate the whole thing.
        xs = np.linspace(0.0, src_len - 1.0, target_len)
        x0 = np.floor(xs).astype(np.int64)
        x1 = np.minimum(x0 + 1, src_len - 1)
        w = (xs - x0)[:, None]
        return (table[x0] * (1 - w) + table[x1] * w).astype(table.dtype)

    grid = table[num_special:].reshape(src_grid, src_grid, hidden)
    ys = (np.arange(tgt_grid) + 0.5) * src_grid / tgt_grid - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, src_grid - 1)
    y1 = np.clip(y0 + 1, 0, src_grid - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    rows = grid[y0] * (1 - wy)[:, None, None] + grid[y1] * wy[:, None, None]
    cols = rows[:, y0] * (1 - wy)[None, :, None] + rows[:, y1] * wy[None, :, None]
    out = np.concatenate(
        [table[:num_special], cols.reshape(tgt_grid * tgt_grid, hidden)], axis=0
    )
    return out.astype(table.dtype)


def _is_text_only(path: Tuple[str, ...]) -> bool:
    return any(path[: len(p)] == p for p in _TEXT_ONLY_PREFIXES) or \
        path[-1] in _TEXT_ONLY_SUFFIXES or path[0] != "encoder"


def convert_vit_checkpoint(
    tf_vars: Dict[str, np.ndarray],
    model: nn.Module,
    extra_rules: Optional[List[Tuple[str, str]]] = None,
    assigned: Optional[Set[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Returns ``model``'s state_dict warm-started from a ViT checkpoint;
    ``assigned``, if given, receives the port names of the tensors the
    checkpoint filled.

    Raises if any image-relevant encoder parameter stays unmatched.
    """
    tf_vars = dict(tf_vars)

    # Conv-style patch kernels -> flattened projection.
    for key in list(tf_vars):
        if re.search(r"patch_embedding[^/]*/kernel$", key):
            v = tf_vars[key]
            if v.ndim == 4:  # [p, p, c, H], raster [py, px, c] flatten
                tf_vars[key] = v.reshape(-1, v.shape[-1])

    # Position-table grid interpolation to the target length.
    tgt_pos = getattr(getattr(model, "encoder", None), "absolute_position_embeddings", None)
    if tgt_pos is not None:
        for key in list(tf_vars):
            if re.search(r"position_embedding[^/]*/embeddings?$", key):
                v = np.asarray(tf_vars[key])
                if v.ndim == 3:  # [1, L, H]
                    v = v[0]
                tf_vars[key] = interpolate_position_embeddings(v, int(tgt_pos.shape[0]))

    done: Set[str] = set()
    converted = convert_tf_checkpoint(
        tf_vars, model, extra_rules=extra_rules, strict=False, assigned=done
    )
    paths = {tuple(path.split("/")): name for name, path in flax_paths(model).items()}
    unmatched = [
        p for p in sorted(paths)  # a JAX pytree's order
        if not _is_text_only(p) and paths[p] not in done  # untouched leaf
    ]
    if unmatched:
        raise ValueError(
            "from-ViT warm start left image-relevant encoder params "
            "unmatched: " + ", ".join("/".join(p) for p in unmatched[:8])
        )
    if assigned is not None:
        assigned.update(done)
    return converted
