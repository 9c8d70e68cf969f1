"""Fused relative-bias attention forward: the Hopper kernel and its plain version.

Counterpart of ``mmt_tpu/ops/pallas_attention.py`` (forward only).  The
kernel is ``mmt_tpu_torch/csrc/rel_attention_fwd.cu``; it replaces the
TPU kernels K1 ``_fwd_kernel`` and K2 ``_fwd_list_kernel`` (with the
split schedule's logsumexp combine and the image-corner build) by one
flash-attention pass that regenerates the relative ids from positions.

* ``relative_attention_forward`` is the wrapper: on a CUDA tensor it
  launches the kernel or raises; on a CPU tensor it returns the plain
  version.  ``relative_attention_forward.launches`` counts the kernel's
  launches.
* ``relative_attention_plain`` is the plain PyTorch version: a dense
  masked softmax over the materialised id map, chunked over the batch.

Rows with ``i >= lengths[b]`` are unspecified: the kernel skips key
tiles past the length and writes o = 0 / lse = -inf for query tiles
past it, while the plain version takes a softmax over the padding.
Compare real rows only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from mmt_tpu_torch.features.attention_mask import make_att_mask_from_length
from mmt_tpu_torch.features.relative_position import (
    MmtRelativePositionGenerator,
    RelativePositionGenerator,
)
from mmt_tpu_torch.ops import build
from mmt_tpu_torch.ops.relative_attention_ref import relative_attention_scores

NEG_INF = -10000.0
# Relative-vocab columns the kernel keeps per query row (csrc kVP).
MAX_KERNEL_VOCAB = 64
KERNEL_HEAD_DIMS = (32, 64)
# Logit elements per chunk of the plain version (1 GiB of float32).
_PLAIN_CHUNK_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class RelGeometry:
    """Static description of the relative-id scheme.

    ``num_core_layers > 0`` => MMT 2D scheme over the first
    ``num_patch_per_row**2`` positions + clipped 1D text after; else the
    ETC 1D scheme over the whole sequence (``image_len == 0``).
    ``window``/``num_global`` describe the sliding-window pattern, which
    the port does not run yet (the wrapper raises on ``window > 0``).
    """

    text_max_distance: int
    num_patch_per_row: int = 0
    num_core_layers: int = 0
    window: int = 0
    num_global: int = 0

    @property
    def image_len(self) -> int:
        return self.num_patch_per_row**2 if self.num_core_layers > 0 else 0

    @property
    def num_image_ids(self) -> int:
        d = 2 * self.num_core_layers + 1
        return d * d + 8

    @property
    def image_part_id(self) -> int:
        return self.image_len + 8 + 2 * self.text_max_distance + 1

    @property
    def text_part_id(self) -> int:
        return self.image_part_id + 1


def relative_att_ids(geometry: RelGeometry, seq_len: int) -> np.ndarray:
    """<int32>[S, S] id map of the geometry, from the feature generators."""
    if geometry.num_core_layers > 0:
        gen = MmtRelativePositionGenerator(
            geometry.num_patch_per_row, geometry.num_core_layers,
            geometry.text_max_distance,
        )
    else:
        gen = RelativePositionGenerator(geometry.text_max_distance)
    return gen.make_relative_att_ids(seq_len, batch_size=1)[0]


def _check_pattern(geometry: Optional[RelGeometry]) -> None:
    if geometry is not None and geometry.window > 0:
        raise NotImplementedError(
            "window > 0 (sliding-window attention) is not ported yet")


def relative_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked relative attention -> (o [B,S,H,D] q.dtype, lse [B,H,S] fp32).

    Logits, the -10000 length mask, softmax and lse are float32; the
    probabilities are rounded to the compute dtype before ``p . v``
    (summed in float32), as the kernel does.  The batch is processed in
    chunks of at most 1 GiB of logits.
    """
    _check_pattern(geometry)
    batch, seq_len, num_heads, _ = q.shape
    ids = None
    if rel_table is not None and geometry is not None:
        ids = torch.from_numpy(relative_att_ids(geometry, seq_len)).to(q.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // (num_heads * seq_len * seq_len))
    outs, lses = [], []
    for b0 in range(0, batch, chunk):
        sl = slice(b0, b0 + chunk)
        logits = relative_attention_scores(q[sl], k[sl], rel_table, ids)
        mask = make_att_mask_from_length(seq_len, lengths[sl])
        logits = logits + (1.0 - mask[:, None].float()) * NEG_INF
        lses.append(torch.logsumexp(logits, dim=-1))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        del logits
        outs.append(
            torch.einsum("bhqk,bkhd->bqhd", probs.float(), v[sl].float()).to(q.dtype)
        )
    return torch.cat(outs), torch.cat(lses)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library("rel_attention_fwd")
    fn = lib.mmt_rel_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_rel_table(rel_table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[V, H, D] table -> the kernel's [H, 64, D] layout in ``dtype``,
    rows >= V zero."""
    vocab, num_heads, head_dim = rel_table.shape
    out = torch.zeros(num_heads, MAX_KERNEL_VOCAB, head_dim, dtype=dtype,
                      device=rel_table.device)
    out[:, :vocab] = rel_table.to(dtype).permute(1, 0, 2)
    return out


def relative_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    device: str = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relative attention forward -> (o [B,S,H,D], lse [B,H,S] fp32).

    ``device`` names where the tensors must lie.  On ``"cuda"`` the Hopper
    kernel runs (bf16 q/k/v, head_dim 32 or 64, relative vocab <= 64) or
    this raises; on ``"cpu"`` the plain version runs.

    Args:
      q, k, v: <float>[B, S, num_heads, head_dim].
      rel_table: <float32>[V, num_heads, head_dim] or None (no bias).
      geometry: the id scheme, or None (no bias).
      lengths: <int>[B] real lengths.
    """
    _check_pattern(geometry)
    dev = torch.device(device)
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, expected {dev.type}")
    if dev.type == "cpu":
        return relative_attention_plain(q, k, v, rel_table, geometry, lengths)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")

    batch, seq_len, num_heads, head_dim = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the kernel takes bf16 q/k/v, got {q.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be [{batch}], got {tuple(lengths.shape)}")
    use_rel = rel_table is not None and geometry is not None
    vocab = rel_table.shape[0] if use_rel else 0
    if use_rel and (vocab > MAX_KERNEL_VOCAB
                    or rel_table.shape[1:] != (num_heads, head_dim)):
        raise ValueError(
            f"rel_table must be [V <= {MAX_KERNEL_VOCAB}, {num_heads}, {head_dim}], "
            f"got {tuple(rel_table.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    rel = kernel_rel_table(rel_table, torch.bfloat16) if use_rel else None
    lengths32 = lengths.to(torch.int32).contiguous()
    geo = geometry if use_rel else RelGeometry(0)
    o = torch.empty_like(q)
    lse = torch.empty(batch, num_heads, seq_len, dtype=torch.float32, device=q.device)
    lib = _kernel()
    err = lib.mmt_rel_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        rel.data_ptr() if rel is not None else None,
        lengths32.data_ptr(), o.data_ptr(), lse.data_ptr(),
        batch, seq_len, num_heads, head_dim, vocab,
        geo.image_len, geo.num_patch_per_row, geo.num_core_layers,
        geo.text_max_distance, geo.image_part_id, geo.text_part_id,
        1.0 / math.sqrt(head_dim), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"rel_attention_fwd launch failed: CUDA error {err} "
            f"({lib.mmt_cuda_error_string(err).decode()})")
    relative_attention_forward.launches += 1
    return o, lse


relative_attention_forward.launches = 0
