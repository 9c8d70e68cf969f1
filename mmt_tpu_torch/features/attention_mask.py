"""Attention masks from per-example lengths (torch counterpart of
``mmt_tpu/features/attention_mask.py``).

Token q attends to token k iff both are real (< L) or both are padding
(>= L): the reference's segmented-mask semantics, where padding tokens
share example id 0 and attend to each other.
"""

from __future__ import annotations

import torch


def make_segmented_att_mask(example_ids: torch.Tensor) -> torch.Tensor:
    """<int32>[..., S, S] mask where mask[q, k] = example_ids[q] == example_ids[k]."""
    q = example_ids[..., :, None]
    k = example_ids[..., None, :]
    return (q == k).to(torch.int32)


def make_att_mask_from_length(seq_len: int, length: torch.Tensor) -> torch.Tensor:
    """[S, S] (scalar length) or [B, S, S] (<int>[B] lengths) int32 mask."""
    length = torch.as_tensor(length)
    pos = torch.arange(seq_len, dtype=torch.int32, device=length.device)
    real = pos[None, :] < length[..., None] if length.ndim else pos < length
    return make_segmented_att_mask(real)


def make_segment_ids(seq_len: int, num_image_wordpieces, num_text_wordpieces) -> torch.Tensor:
    """Segment ids: 1 for the image part, 2 for the text part, 0 for padding.

    Keeps the reference's off-by-one: the boundary position ``pos ==
    num_image_wordpieces`` (the first text token) gets segment id 0,
    because the text segment is a strict ``position > img_wp``.

    Args:
      seq_len: padded length S.
      num_image_wordpieces, num_text_wordpieces: <int> scalar or [B].

    Returns:
      <int32>[S] or <int32>[B, S].
    """
    img = torch.as_tensor(num_image_wordpieces)
    txt = torch.as_tensor(num_text_wordpieces, device=img.device)
    pos = torch.arange(seq_len, dtype=torch.int32, device=img.device)
    if img.ndim:
        pos, img, txt = pos[None, :], img[..., None], txt[..., None]
    img_segment = torch.where(pos < img, 1, 0)
    txt_segment = torch.where((pos > img) & (pos < img + txt), 2, 0)
    return (img_segment + txt_segment).to(torch.int32)
