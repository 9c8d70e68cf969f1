"""Relative attention id generation (1D text + 2D image patches), numpy.

The port's own copy of ``mmt_tpu/features/relative_position.py`` (the
port imports nothing of the JAX package).  The ids are a closed-form
function of the 2D offset between patches:

    fine ids   : id(dy, dx) = (dy * d + dx) mod d**2      for |dy|,|dx| <= r
    coarse ids : d**2 + direction(dy, dx)                 otherwise
    (d = 2r + 1; 8 directions ordered top, top-right, right,
     bottom-right, bottom, bottom-left, left, top-left)

and clipped 1D offsets for text.  The fused kernel
(``mmt_tpu_torch/csrc/rel_attention_fwd.cu``) evaluates the same closed
form per (i, j); the [S, S] map built here is what the dense path and
the kernel's plain version consume.

ID space of the 2D generator, with the reference's quirks kept:

  [0, d**2)                       fine-grained 2D ids (shared with text 1D ids)
  [d**2, d**2 + 8)                coarse direction ids
  [0, 2*D + 1)                    text 1D ids (D = text max distance),
                                  overlapping the image id range
  P**2 + 8 + 2*D + 1              image_part_id (text row -> image column)
  P**2 + 8 + 2*D + 2              text_part_id  (image row -> text column)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "RelativePositionGenerator",
    "MmtRelativePositionGenerator",
]

_NUM_DIRECTIONS = 8


def _relative_1d_ids(offsets: np.ndarray, max_distance: int) -> np.ndarray:
    """ETC-style clipped 1D relative position ids.

    id(off) = 0                              if off == 0
              min(off, D)                    if off  > 0   (ids 1..D)
              D + min(-off, D)               if off  < 0   (ids D+1..2D)
    """
    off = np.asarray(offsets)
    pos = np.minimum(np.abs(off), max_distance)
    return np.where(off >= 0, pos, max_distance + pos).astype(np.int32)


class RelativePositionGenerator:
    """1D relative position ids over a token sequence (ETC semantics)."""

    def __init__(self, max_distance: int):
        if max_distance < 0:
            raise ValueError("`max_distance` must be >= 0.")
        self.max_distance = max_distance

    @property
    def relative_vocab_size(self) -> int:
        return 2 * self.max_distance + 1

    def make_relative_att_ids(self, seq_len: int, batch_size: int = 1) -> np.ndarray:
        """Returns <int32>[batch_size, seq_len, seq_len] relative ids."""
        pos = np.arange(seq_len)
        off = pos[None, :] - pos[:, None]  # off[q, k] = k - q
        ids = _relative_1d_ids(off, self.max_distance)
        return np.broadcast_to(ids, (batch_size, seq_len, seq_len)).copy()


def _relative_2d_ids(dy: np.ndarray, dx: np.ndarray, num_core_layers: int) -> np.ndarray:
    """2D patch-to-patch relative ids as a function of the 2D offset.

    ``dy = row(k) - row(q)``, ``dx = col(k) - col(q)``.
    """
    r = num_core_layers
    d = 2 * r + 1
    fine = np.mod(dy * d + dx, d * d)

    in_core = (np.abs(dy) <= r) & (np.abs(dx) <= r)
    above, below = dy < -r, dy > r
    left, right = dx < -r, dx > r
    mid_y = ~above & ~below
    mid_x = ~left & ~right

    coarse = np.zeros_like(fine)
    # Direction order: top, top_right, right, right_bottom, bottom,
    # bottom_left, left, top_left.
    for idx, mask in enumerate(
        [
            above & mid_x,   # top
            above & right,   # top-right
            mid_y & right,   # right
            below & right,   # bottom-right
            below & mid_x,   # bottom
            below & left,    # bottom-left
            mid_y & left,    # left
            above & left,    # top-left
        ]
    ):
        coarse = np.where(mask, d * d + idx, coarse)

    return np.where(in_core, fine, coarse).astype(np.int32)


class MmtRelativePositionGenerator:
    """2D (image patches) + 1D (text) relative attention ids.

    Quirks kept from the reference:

    * The first ``P**2`` positions of the sequence are treated as patches
      in raster order even though the model places [CLS] and [PATCH] at
      positions 0 and 1 and the patches in slots [2, 2 + P**2).
    * ``image_part_id``/``text_part_id`` are ``P**2 + 8 + 2D+1`` and
      ``+1``; with the shipped configs (relative_vocab_size=49, P=14) they
      exceed the relative vocab, and the attention layers map them to a
      **zero bias**.
    * Image and text share the low end of the id space.
    """

    def __init__(
        self,
        num_patch_per_row: int,
        num_core_layers: int,
        text_relative_pos_max_distance: int,
    ):
        if num_patch_per_row <= 0:
            raise ValueError("`num_patch_per_row` must be positive.")
        if num_core_layers <= 0:
            raise ValueError("`num_core_layers` must be positive.")
        if text_relative_pos_max_distance < 0:
            raise ValueError("`text_relative_pos_max_distance` must be positive.")

        self.num_patch_per_row = num_patch_per_row
        self.num_core_layers = num_core_layers
        self.core_layer_diameter = 2 * num_core_layers + 1
        self.text_relative_pos_max_distance = text_relative_pos_max_distance

        text_max_id = 2 * text_relative_pos_max_distance + 1
        self.image_part_id = num_patch_per_row**2 + _NUM_DIRECTIONS + text_max_id
        self.text_part_id = self.image_part_id + 1

        self._text_generator = RelativePositionGenerator(text_relative_pos_max_distance)

    @property
    def relative_vocab_size(self) -> int:
        """Vocab needed to embed every emitted id (text_part_id + 1)."""
        return self.text_part_id + 1

    def image_ids(self) -> np.ndarray:
        """<int32>[P**2, P**2] patch-to-patch 2D relative ids."""
        p = self.num_patch_per_row
        coords = np.stack(
            np.meshgrid(np.arange(p), np.arange(p), indexing="ij"), axis=-1
        ).reshape(-1, 2)  # raster order: (row, col)
        dy = coords[None, :, 0] - coords[:, None, 0]
        dx = coords[None, :, 1] - coords[:, None, 1]
        return _relative_2d_ids(dy, dx, self.num_core_layers)

    def make_relative_att_ids(self, seq_len: int, batch_size: int = 1) -> np.ndarray:
        """<int32>[batch_size, seq_len, seq_len] joint image+text ids."""
        image_seq_len = self.num_patch_per_row**2
        text_seq_len = seq_len - image_seq_len
        if text_seq_len < 0:
            raise ValueError(
                f"seq_len ({seq_len}) must be >= P**2 ({image_seq_len})."
            )

        ids = np.empty((seq_len, seq_len), dtype=np.int32)
        ids[:image_seq_len, :image_seq_len] = self.image_ids()
        ids[:image_seq_len, image_seq_len:] = self.text_part_id
        ids[image_seq_len:, :image_seq_len] = self.image_part_id
        ids[image_seq_len:, image_seq_len:] = self._text_generator.make_relative_att_ids(
            text_seq_len, batch_size=1
        )[0]
        return np.broadcast_to(ids, (batch_size, seq_len, seq_len)).copy()
