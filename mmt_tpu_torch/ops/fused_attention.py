"""Fused relative-bias attention: the Hopper kernels and their plain versions.

Counterpart of ``mmt_tpu/ops/pallas_attention.py``, forward and backward.

* Forward kernel ``mmt_tpu_torch/csrc/rel_attention_fwd.cu`` (the kernel
  template in ``rel_attention_fwd.cuh``) replaces the
  TPU kernels K1 ``_fwd_kernel`` and K2 ``_fwd_list_kernel`` (with the
  split schedule's logsumexp combine and the image-corner build, and the
  windowed live-tile list) by one flash-attention pass on ``wgmma``: a
  warpgroup owns 64 queries and sweeps its live key tiles, the bias is
  decided once per tile (one id for the whole tile, or per-pair ids), and
  the attention dropout is applied in the kernel.
  ``relative_attention_forward_tiled`` is that schedule in plain PyTorch.
* Backward kernel ``mmt_tpu_torch/csrc/rel_attention_bwd.cu`` replaces K3
  ``_bwd_fused_kernel`` and K5 ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
  (and, windowed, K4 ``_bwd_fused_list_kernel`` and K6
  ``_bwd_dq_list_kernel`` / ``_bwd_dkv_list_kernel``) by one pass over
  each (query, key) pair: a block owns 64 keys and sweeps their live query
  tiles, keeps dk / dv in registers, adds each tile's dq into an fp32
  buffer and each block's dRel into a per-example buffer.
  ``relative_attention_backward_tiled`` is that schedule in plain PyTorch.

The sliding-window + prefix-global pattern (``RelGeometry.window > 0``)
allows a pair (i, j) iff ``i < num_global or j < num_global or |i - j| <=
window``; a disallowed pair gets -10000 on its logit, after the scale and
after the length mask (``pallas_attention.py:_apply_window_mask``).  The
kernels' windowed variants (a template argument) visit only the key (or
query) tiles that hold an allowed pair, which the block computes for
itself; at ``window == 0`` the kernels are the dense ones.

Public pieces:

* ``relative_attention`` is the differentiable op the model calls
  (``RelativeAttentionFunction``, the counterpart of the JAX
  ``custom_vjp`` ``pallas_relative_attention``).
* ``relative_attention_forward`` / ``relative_attention_backward`` are
  the launchers: on CUDA tensors they launch the kernels or raise; on CPU
  tensors they return the plain versions.  The forward launcher goes
  through the registered torch op ``mmt_tpu_torch::rel_attention_fwd``
  (with a fake version, so that ``torch.export`` can trace a model that
  calls it).  Each launcher counts its kernel launches, dense, windowed and
  sequence-sharded (a nonzero ``q_start`` or ``k_start``, or fewer query
  rows than keys) apart; a call whose only offset is ``batch_start`` runs
  the ordinary schedule and counts as dense or windowed:
  ``relative_attention_forward.launches`` / ``.launches_window`` /
  ``.launches_offset`` and ``relative_attention_backward``'s three; a
  launch on a tensor-parallel head shard with a nonzero ``head_start`` is
  counted again in ``.launches_head_shard`` (the shard at head 0 is the
  ordinary call on its heads, as a sequence shard at offset 0 is).
* ``relative_attention_plain`` / ``relative_attention_backward_plain``
  are the plain PyTorch versions: dense formulas over the materialised id
  map and pattern mask, chunked over the batch.
* ``live_tiles`` is the 64-wide tile sweep of a block (csrc ``LiveTiles``),
  ``split_class_tiles`` its far / structured classes (the split probe's
  cut of the forward kernel); ``uniform_tile_id`` and ``image_id_table``
  are the forward kernel's per-tile id and its image id table.
* ``dropout_keep`` / ``dropout_tile`` are a bit-exact copy of the JAX
  dropout hash.
* ``allowed_real_pairs`` counts the pairs a batch's attention computes
  (the kernels' bounds are written in it).
* ``relative_att_ids_at`` and ``empty_rows`` are a chunk's ids and its
  rows without a live key (the offset mode below).

Offsets (the sequence-sharded schedules, ``ops/sharded_attention.py``):
every function takes ``q_start`` and ``k_start``, the global positions of
its first query row and first key (``pallas_attention.py``'s ``qoff``), and
``batch_start``, the global index of its first example.  q covers rows
``[q_start, q_start + S_q)`` and k, v keys ``[k_start, k_start + S_k)``
with ``S_q != S_k`` allowed; the ids, the length and window terms and the
dropout hash use the global positions, and ``lengths`` are global.  A real
row with no live key in the chunk (every key past its length, or every
pair outside the window) gets o = 0 and lse = -inf, so that a logsumexp
combine over chunks ignores it.  The kernels take offsets that are
multiples of 64 (their tiles).

Rows with ``i >= lengths[b]`` are unspecified in the forward: the kernel
skips key tiles past the length and writes o = 0 / lse = -inf for query
tiles past it, while the plain version takes a softmax over the padding.
Compare real rows only.  The backward treats padded rows' outputs as
unused (as every consumer in the package does): gradients of pairs with
a padded query or a padded key are exactly zero, so dq, dk and dv rows
past the length are zero, in the kernels and the plain version alike.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from mmt_tpu_torch.features.relative_position import (
    MmtRelativePositionGenerator,
    RelativePositionGenerator,
)
from mmt_tpu_torch.ops import build
from mmt_tpu_torch.ops.relative_attention_ref import relative_attention_scores

NEG_INF = -10000.0
# Relative-vocab columns the kernels keep per query row (csrc kVP).
MAX_KERNEL_VOCAB = 64
# Rows of the kernels' query and key tiles (csrc kT).
TILE = 64
# The kernels look image ids up in a (2P - 1)^2 table (csrc
# kMaxPatchPerRow); the JAX kernels ask for an image part within one tile
# (pallas_attention.py:_prepare), P <= 22 at 512.
MAX_PATCH_PER_ROW = 32
KERNEL_HEAD_DIMS = (32, 64)
# A row whose largest base-2 logit lies below this carries a -10000 term on
# every pair it saw: it has no live key (o = 0, lse = -inf).
EMPTY_ROW_LOGIT2 = 0.5 * NEG_INF * math.log2(math.e)
# Logit elements per chunk of the plain versions (1 GiB of float32).
_PLAIN_CHUNK_ELEMENTS = 1 << 28

_U32 = 0xFFFFFFFF
# The int32 constants of the JAX hash, as uint32.
_HASH_I, _HASH_J, _HASH_HEAD = 0x9E3779B9, 0x85EBCA6B, 0x27D4EB2D
_HASH_M1, _HASH_M2 = 0x45D9F3B, 0x2C1B3C6D
_BATCH_FOLD = 0x96658E39  # np.int32(-1771729351) as uint32


@dataclasses.dataclass(frozen=True)
class RelGeometry:
    """Static description of the relative-id scheme.

    ``num_core_layers > 0`` => MMT 2D scheme over the first
    ``num_patch_per_row**2`` positions + clipped 1D text after; else the
    ETC 1D scheme over the whole sequence (``image_len == 0``).
    ``window > 0`` adds the sliding-window + prefix-global pattern: a
    pair (i, j) is allowed iff ``i < num_global or j < num_global or
    |i - j| <= window``; ``window == 0`` is dense attention.
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


@functools.lru_cache(maxsize=4)
def _id_map(geometry: RelGeometry, size: int) -> np.ndarray:
    return relative_att_ids(geometry, size)


def _check_pattern(geometry: Optional[RelGeometry], rel_table) -> None:
    """The JAX validation of the pattern (``pallas_attention.py:3226-3230``)."""
    if (geometry is not None and geometry.window > 0
            and (rel_table is None or geometry.num_global <= 0)):
        raise ValueError(
            "window > 0 requires the relative-bias path (rel_table) and "
            "num_global > 0 (the prefix-global token count)")


def _windowed(geometry: Optional[RelGeometry]) -> bool:
    return geometry is not None and geometry.window > 0


def window_allowed(geometry: RelGeometry, i_pos, j_pos):
    """Whether the pattern allows the pairs (i_pos, j_pos) (broadcast)."""
    g = geometry.num_global
    return (i_pos < g) | (j_pos < g) | ((j_pos - i_pos).abs() <= geometry.window)


def _positions(start: int, size: int, device) -> torch.Tensor:
    return torch.arange(start, start + size, device=device)


def _window_term(geometry: Optional[RelGeometry], q_pos: torch.Tensor, k_pos: torch.Tensor):
    """<float32>[S_q, S_k]: 0 on allowed pairs, -10000 elsewhere; None when dense."""
    if not _windowed(geometry):
        return None
    allowed = window_allowed(geometry, q_pos[:, None], k_pos[None, :])
    return torch.where(allowed, 0.0, NEG_INF)


def empty_rows(geometry, lengths, q_pos, k_pos) -> torch.Tensor:
    """<bool>[b, S_q]: real query rows with no live key among ``k_pos``
    (every key past the length, or every pair outside the window)."""
    lengths = lengths.to(q_pos.device)[:, None]
    real_k = k_pos[None, :] < lengths
    if _windowed(geometry):
        allowed = window_allowed(geometry, q_pos[:, None], k_pos[None, :])
        live = (real_k.float() @ allowed.float().T) > 0
    else:
        live = real_k.any(-1, keepdim=True)
    return (q_pos[None, :] < lengths) & ~live


def allowed_real_pairs(geometry: Optional[RelGeometry], lengths) -> int:
    """sum_b |{(i, j) : i, j < L_b, allowed(i, j)}|: the pairs whose logits
    the attention needs (L_b**2 per example when dense)."""
    total = 0
    for n in np.asarray(lengths, np.int64).tolist():
        if not _windowed(geometry):
            total += n * n
            continue
        g, w = min(geometry.num_global, n), geometry.window
        i = np.arange(g, n, dtype=np.int64)  # rows past the global prefix
        lo, hi = np.maximum(i - w, g), np.minimum(i + w, n - 1)
        total += g * n + int(((n - g) * g + np.maximum(hi - lo + 1, 0).sum()))
    return total


def live_tiles(r0: int, length: int, geometry: Optional[RelGeometry], start: int = 0) -> list:
    """The 64-wide tiles on the other axis that a block of 64 rows from
    ``r0`` visits, in ascending order (csrc ``LiveTiles``), as global tile
    indexes in ``[start // 64, ceil(length / 64))`` (``start``: the first
    position of the other axis's chunk, a multiple of 64; ``length``: the
    end of its real positions): every such tile when dense or when the
    block meets the global prefix; else the global tiles and the band
    ``[floor((r0 - w) / 64), floor((r0 + 63 + w) / 64)]``, a tile in both
    visited once.  The pattern is symmetric, so this is a query block's key
    tiles and a key block's query tiles alike."""
    first, n = start // TILE, -(-length // TILE)
    if not _windowed(geometry) or r0 < geometry.num_global:
        return list(range(first, n))
    head = min(-(-geometry.num_global // TILE), n)
    lo = max(max(r0 - geometry.window, 0) // TILE, head, first)
    hi = min((r0 + TILE - 1 + geometry.window) // TILE + 1, n)
    return list(range(first, head)) + list(range(lo, max(lo, hi)))


# The key tiles a forward warpgroup computes (csrc ``TileClass``): its live
# tiles, or one class of the far / structured split (the split probe).
TILE_CLASSES = ("all", "far", "structured")


def split_class_tiles(q_first: int, q_last: int, length: int, geometry: RelGeometry,
                      tile_class: str) -> list:
    """The key tiles of one class of the far / structured split that the
    64-row query tiles ``q_first <= ... <= q_last`` (one or two adjacent
    starts) meet among the dense tiles ``[0, ceil(length / 64))``, in
    ascending order (csrc ``split_class_tiles``).  A tile (q0, k0) is far
    when both lie in the text part and every offset ``j - i`` in it is
    beyond the text distance d on one side (``k0 >= q0 + 64 + d`` or ``k0
    <= q0 - 64 - d``; ``pallas_attention.py:_build_tile_meta`` at 64-blocks);
    every other tile is structured.  For two query tiles this is the union
    of their tiles: the block's walk in the kernel."""
    if tile_class not in TILE_CLASSES[1:]:
        raise ValueError(f"tile_class must be 'far' or 'structured', got {tile_class!r}")
    n = -(-length // TILE)
    il, d = geometry.image_len, geometry.text_max_distance
    ti = min(-(-il // TILE), n)

    def lhi(q0):  # one past the last far tile left of the band
        return min((q0 - TILE - d) // TILE + 1 if q0 - TILE - d >= 0 else 0, n)

    def rlo(q0):  # the first far tile right of the band
        return min(-(-(q0 + TILE + d) // TILE), n)

    if tile_class == "far":
        if q_last < il:  # no text query tile
            return []
        head = max(ti, lhi(q_last))
        lo = max(head, rlo(q_last if q_first < il else q_first))
        return list(range(ti, head)) + list(range(lo, n))
    if q_first < il:  # an image query tile meets every tile
        return list(range(n))
    lo = max(ti, lhi(q_first))
    return list(range(ti)) + list(range(lo, max(lo, rlo(q_last))))


# ------------------------------------------------------------ dropout hash


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_threshold(rate: float) -> int:
    """Keep iff the hash's low 24 bits are >= this (JAX: ``round(rate * 2**24)``)."""
    return int(round(rate * (1 << 24)))


def dropout_scale(rate: float) -> float:
    """The keep factor 1/(1-rate), rounded to float32 as JAX rounds it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_keep(seed, head, i_pos, j_pos, rate: float) -> torch.Tensor:
    """Attention-dropout keep factor in {0, 1/(1-rate)} (float32).

    Bit-exact copy of ``mmt_tpu/ops/pallas_attention.py:_dropout_keep``:
    a 3-round multiply-xorshift hash of (seed, head, global query
    position, global key position) in 32-bit wrap-around arithmetic with
    logical shifts, computed here on int64 tensors holding uint32 values.
    Arguments are ints or int tensors that broadcast together.
    """
    as_u32 = lambda a: torch.as_tensor(a, dtype=torch.int64) & _U32  # noqa: E731
    x = _mul32(as_u32(i_pos), _HASH_I)
    x = x ^ _mul32(as_u32(j_pos), _HASH_J)
    x = x ^ ((as_u32(seed) + _mul32(as_u32(head), _HASH_HEAD)) & _U32)
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_M2)
    x = x ^ (x >> 16)
    keep = (x & 0xFFFFFF) >= dropout_threshold(rate)
    return keep.to(torch.float32) * dropout_scale(rate)


def example_seed(seed, batch_idx):
    """Per-example seed ``seed + batch_idx * -1771729351`` (int32 wrap), as uint32."""
    as_u32 = lambda a: torch.as_tensor(a, dtype=torch.int64) & _U32  # noqa: E731
    return (as_u32(seed) + _mul32(as_u32(batch_idx), _BATCH_FOLD)) & _U32


def dropout_tile(seed, batch_idx, head, q_base, k_base, shape, rate: float) -> torch.Tensor:
    """Keep-factor tile for a (q_base, k_base) block of one example
    (``pallas_attention.py:_dropout_tile``)."""
    i_pos = q_base + torch.arange(shape[0], dtype=torch.int64)[:, None]
    j_pos = k_base + torch.arange(shape[1], dtype=torch.int64)[None, :]
    return dropout_keep(example_seed(seed, batch_idx), head, i_pos, j_pos, rate)


def _dropout_block(seed, batch_ids: torch.Tensor, num_heads: int, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, rate: float, head_start: int = 0) -> torch.Tensor:
    """[b, H, S_q, S_k] keep factors for the (global) examples ``batch_ids``
    and the global heads ``[head_start, head_start + H)``."""
    dev = batch_ids.device
    heads = torch.arange(num_heads, dtype=torch.int64, device=dev) + head_start
    seeds = example_seed(seed, batch_ids.to(torch.int64))
    return dropout_keep(seeds[:, None, None, None], heads[None, :, None, None],
                        q_pos.long()[:, None], k_pos.long()[None, :], rate)


def head_seed(seed, head_start: int) -> int:
    """The int32 seed whose hash at local head h is ``seed``'s at global head
    ``head_start + h``: the hash adds ``head * 0x27D4EB2D`` to the example's
    seed (mod 2**32), so a head offset folds into the seed and the kernels
    take a head shard unchanged."""
    return _int32(int(seed) + head_start * _HASH_HEAD)


def _check_offsets(q_start: int, k_start: int, batch_start: int) -> None:
    if min(q_start, k_start, batch_start) < 0:
        raise ValueError(f"offsets must be >= 0, got q_start={q_start}, k_start={k_start}, "
                         f"batch_start={batch_start}")


def _check_tile_offsets(q_start: int, k_start: int, batch_start: int) -> None:
    """The kernels' offsets: q_start and k_start multiples of the tile."""
    _check_offsets(q_start, k_start, batch_start)
    if q_start % TILE or k_start % TILE:
        raise ValueError(f"the kernels take q_start and k_start in multiples of {TILE}, "
                         f"got {q_start}, {k_start}")


def _check_dropout(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        # A silently defaulted seed would repeat the same mask every step.
        raise ValueError(
            "dropout_seed is required when dropout_rate > 0 "
            "(derive a distinct int32 seed per training step)")


# ------------------------------------------------------- plain versions


def relative_att_ids_at(geometry: RelGeometry, q_start: int, seq_q: int, k_start: int,
                        seq_k: int) -> np.ndarray:
    """<int32>[S_q, S_k] ids of the global rows [q_start, q_start + S_q)
    against the global keys [k_start, k_start + S_k) (a read-only view of
    a cached map when the chunk starts at 0 and is square)."""
    ids = _id_map(geometry, max(q_start + seq_q, k_start + seq_k))
    if q_start or k_start or seq_q != seq_k:
        ids = np.ascontiguousarray(ids[q_start:q_start + seq_q, k_start:k_start + seq_k])
    return ids


def _plain_ids(geometry, rel_table, q_start, seq_q, k_start, seq_k, device):
    """The chunk's ids as a tensor on ``device``, or None without a bias."""
    if rel_table is None or geometry is None:
        return None
    return torch.from_numpy(relative_att_ids_at(geometry, q_start, seq_q, k_start, seq_k)
                            ).to(device)


def _length_mask(lengths, q_pos, k_pos):
    """<bool>[b, S_q, S_k]: whether the pair is on one side of the length
    (both real or both padding; ``make_att_mask_from_length``)."""
    lengths = lengths.to(q_pos.device)[:, None]
    return (q_pos[None, :] < lengths)[:, :, None] == (k_pos[None, :] < lengths)[:, None, :]


def _masked_logits(q, k, rel_table, ids, lengths, window_term=None, q_pos=None, k_pos=None):
    """Scaled logits + the length mask, then the window term (the order of
    ``_apply_window_mask``: after the scale and the length mask)."""
    if q_pos is None:
        q_pos = k_pos = torch.arange(q.shape[1], device=q.device)
    logits = relative_attention_scores(q, k, rel_table, ids)
    mask = _length_mask(lengths, q_pos, k_pos)
    logits = logits + (1.0 - mask[:, None].float()) * NEG_INF
    if window_term is not None:
        logits = logits + window_term
    return logits


def relative_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
    head_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked relative attention -> (o [B,S_q,H,D] q.dtype, lse [B,H,S_q] fp32).

    Logits, the -10000 length mask, the -10000 window term (when
    ``geometry.window > 0``), softmax and lse are float32.  The
    dropout keep factors (the hash of ``dropout_keep``) multiply the
    probabilities after the softmax; the probabilities are then rounded
    to the compute dtype before ``p . v`` (summed in float32), as the
    kernel does.  The batch is processed in chunks of at most 1 GiB of
    logits.  Differentiable by autograd.  ``q_start``, ``k_start`` and
    ``batch_start`` place q, k and the batch in the global sequence and
    batch (module docstring); a real row with no live key in k gives o =
    0 and lse = -inf.  ``head_start``: the global index of q's first head,
    which the dropout hash takes (a tensor-parallel head shard).
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    _check_offsets(q_start, k_start, batch_start)
    batch, seq_q, num_heads, _ = q.shape
    seq_k = k.shape[1]
    q_pos, k_pos = _positions(q_start, seq_q, q.device), _positions(k_start, seq_k, q.device)
    ids = _plain_ids(geometry, rel_table, q_start, seq_q, k_start, seq_k, q.device)
    window = _window_term(geometry, q_pos, k_pos)
    offsets = bool(q_start or k_start or seq_q != seq_k)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // (num_heads * seq_q * seq_k))
    if torch.compiler.is_exporting():
        # A traced batch may be symbolic: one chunk, whatever its size.
        chunks = [slice(None)]
    else:
        chunks = [slice(b0, b0 + chunk) for b0 in range(0, batch, chunk)]
    outs, lses = [], []
    for sl in chunks:
        b0 = sl.start or 0
        logits = _masked_logits(q[sl], k[sl], rel_table, ids, lengths[sl], window, q_pos, k_pos)
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        del logits
        if dropout_rate > 0.0:
            rows = torch.arange(batch_start + b0, batch_start + b0 + probs.shape[0],
                                device=q.device)
            probs = probs * _dropout_block(dropout_seed, rows, num_heads, q_pos, k_pos,
                                           dropout_rate, head_start)
        probs = probs.to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v[sl].float()).to(q.dtype)
        if offsets:  # rows whose chunk holds no live key contribute nothing
            empty = empty_rows(geometry, lengths[sl], q_pos, k_pos)
            o = torch.where(empty[:, :, None, None], torch.zeros((), dtype=o.dtype,
                                                                 device=o.device), o)
            lse = torch.where(empty[:, None, :], -math.inf, lse)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def relative_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
    head_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Dense backward -> (dq [B,S_q,H,D], dk, dv [B,S_k,H,D] in q.dtype, drel
    [V,H,D] in the table's dtype or None).

    With s the scaled, masked logits (length mask and window term, as in
    the forward), P = exp(s - lse), K the dropout keep
    factors, delta = rowsum(do * o) and "real" the pairs whose query and
    key are both real (< length):

      dv   = (P * K * real)^T . do
      dS   = P * (do . v^T * K - delta) * real
      dq   = scale * (dS . k + dSV . R_h),  dSV[i, v] = sum_{j: id(i,j)=v} dS_ij
      dk   = scale * dS^T . q
      dRel = scale * sum_b dSV^T . q

    in float32 from the given tensors (R rounded to the compute dtype, as
    in the forward).  Pairs the window disallows need no term of their
    own: their -10000 drives P to exactly 0, as in JAX.  ``lse`` below -1e38 (a row with no live key tile)
    is clamped to 3e38, as the kernels do.  Chunked over the batch like
    the forward.  Offsets as in ``relative_attention_plain``: with a chunk
    of keys and the global ``lse`` (the ring schedule), these are the
    chunk's terms of the gradients; ``head_start`` as there too.

    Args:
      q, do: <float>[B, S_q, H, D]; k, v: <float>[B, S_k, H, D].
      lse, delta: <float32>[B, H, S_q].
      rel_table: <float>[V, H, D] or None.
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    _check_offsets(q_start, k_start, batch_start)
    batch, seq_q, num_heads, head_dim = q.shape
    seq_k = k.shape[1]
    scale = 1.0 / math.sqrt(head_dim)
    q_pos, k_pos = _positions(q_start, seq_q, q.device), _positions(k_start, seq_k, q.device)
    ids = _plain_ids(geometry, rel_table, q_start, seq_q, k_start, seq_k, q.device)
    window = _window_term(geometry, q_pos, k_pos)
    use_rel = ids is not None
    if use_rel:
        vocab = rel_table.shape[0]
        r = rel_table.to(q.dtype).float()
        safe_ids = torch.where(ids < vocab, ids.long(), vocab)  # column V collects OOV ids
        drel = torch.zeros(vocab, num_heads, head_dim, dtype=torch.float32, device=q.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // (num_heads * seq_q * seq_k))
    dqs, dks, dvs = [], [], []
    for b0 in range(0, batch, chunk):
        sl = slice(b0, b0 + chunk)
        qf, kf, vf, dof = (t[sl].float() for t in (q, k, v, do))
        s = _masked_logits(q[sl], k[sl], rel_table if use_rel else None, ids, lengths[sl],
                           window, q_pos, k_pos)
        lse_c = lse[sl].float()
        lse_c = torch.where(lse_c < -1e38, torch.full_like(lse_c, 3e38), lse_c)
        p = torch.exp(s - lse_c[..., None])
        del s
        lengths_c = lengths[sl].to(q.device)[:, None]
        real_q, real_k = q_pos[None, :] < lengths_c, k_pos[None, :] < lengths_c  # [b, S]
        pair = (real_q[:, :, None] & real_k[:, None, :])[:, None]  # [b, 1, S_q, S_k]
        dp = torch.einsum("bihd,bjhd->bhij", dof, vf)
        if dropout_rate > 0.0:
            rows = torch.arange(batch_start + b0, batch_start + b0 + p.shape[0],
                                device=q.device)
            keep = _dropout_block(dropout_seed, rows, num_heads, q_pos, k_pos, dropout_rate,
                                  head_start)
            dp = dp * keep
            p_v = p * keep
            del keep
        else:
            p_v = p
        zero = torch.zeros((), device=q.device)
        ds = torch.where(pair, p * (dp - delta[sl].float()[..., None]), zero)
        p_v = torch.where(pair, p_v, zero)
        del p, dp
        dvs.append(torch.einsum("bhij,bihd->bjhd", p_v, dof))
        del p_v
        dks.append(torch.einsum("bhij,bihd->bjhd", ds, qf) * scale)
        dq = torch.einsum("bhij,bjhd->bihd", ds, kf)
        if use_rel:
            index = safe_ids[None, None].expand(ds.shape[0], num_heads, -1, -1)
            dsv = torch.zeros(*ds.shape[:3], vocab + 1, dtype=torch.float32,
                              device=q.device).scatter_add_(-1, index, ds)[..., :vocab]
            dq = dq + torch.einsum("bhiv,vhd->bihd", dsv, r)
            drel += torch.einsum("bhiv,bihd->vhd", dsv, qf) * scale
        del ds
        dqs.append(dq * scale)
    dq, dk, dv = (torch.cat(ts).to(q.dtype) for ts in (dqs, dks, dvs))
    return dq, dk, dv, drel.to(rel_table.dtype) if use_rel else None


def uniform_tile_id(q0: int, k0: int, geometry: RelGeometry) -> int:
    """The one id of every pair of the 64 x 64 tile at (q0, k0), or -1
    when ids vary (csrc ``uniform_tile_id``): image queries x text keys,
    text queries x image keys, and text tiles whose every offset j - i is
    beyond the clip distance on one side."""
    il, q1, k1 = geometry.image_len, q0 + TILE - 1, k0 + TILE - 1
    tmd = geometry.text_max_distance
    if q1 < il:
        return geometry.text_part_id if k0 >= il else -1
    if q0 < il:
        return -1
    if k1 < il:
        return geometry.image_part_id
    if k0 < il:
        return -1
    if k0 - q1 >= tmd:
        return tmd
    if q0 - k1 >= tmd:
        return 2 * tmd
    return -1


def image_id_table(geometry: RelGeometry) -> np.ndarray:
    """<int64>[(2P - 1)**2] 2D ids by offset (csrc image id table): entry
    ``(dy + P - 1) * W + dx + P - 1``, W = 2P - 1, holds the id of an image
    pair with ``dy = jy - iy``, ``dx = jx - ix``."""
    p, r = geometry.num_patch_per_row, geometry.num_core_layers
    d = 2 * r + 1
    dy, dx = np.meshgrid(np.arange(1 - p, p), np.arange(1 - p, p), indexing="ij")
    above, below, left, right = dy < -r, dy > r, dx < -r, dx > r
    mid_y, mid_x = ~above & ~below, ~left & ~right
    ids = np.full(dy.shape, d * d + 7)  # top-left
    for n, sel in enumerate([above & mid_x, above & right, mid_y & right, below & right,
                             below & mid_x, below & left, mid_y & left]):
        ids[sel] = d * d + n
    ids[mid_y & mid_x] = ((dy * d + dx) % (d * d))[mid_y & mid_x]
    return ids.reshape(-1)


def _tile_pair_ids(geometry: RelGeometry, i_pos: torch.Tensor, j_pos: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """Per-pair ids of a tile whose ids vary, as the kernel takes them: image
    pairs from the offset table by a key code minus a row code, image x text
    from the part ids, text pairs the clipped offset."""
    p, il, tmd = geometry.num_patch_per_row, geometry.image_len, geometry.text_max_distance
    w = 2 * p - 1
    i, j = i_pos[:, None], j_pos[None, :]
    if il:
        qcode = (i // p) * w + i % p - (p - 1) * (w + 1)
        kcode = (j // p) * w + j % p
        image = table[torch.clamp(kcode - qcode, 0, w * w - 1)]
    else:
        image = torch.zeros((), dtype=torch.int64)
    off = j - i
    band = torch.where(off >= 0, off.clamp(max=tmd), tmd + (-off).clamp(max=tmd))
    return torch.where(i < il, torch.where(j < il, image, geometry.text_part_id),
                       torch.where(j < il, geometry.image_part_id, band))


def _window_cuts(q0: int, k0: int, q_end: int, k_end: int, geometry: RelGeometry) -> bool:
    """Whether the window term can change a pair of the tile below the
    chunks' ends ``q_end`` / ``k_end`` (csrc ``window_cuts``): not when
    every row or every key is global, nor when the tile lies wholly inside
    the band."""
    g, w = geometry.num_global, geometry.window
    if q0 + TILE <= g or k0 + TILE <= g:
        return False
    return min(k0 + TILE, k_end) - 1 - q0 > w or min(q0 + TILE, q_end) - 1 - k0 > w


def relative_attention_forward_tiled(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
    tile_class: str = "all",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's schedule in plain PyTorch (float32, small
    shapes): the function of ``relative_attention_plain``, computed as
    ``csrc/rel_attention_fwd.cuh`` decomposes it.

    For each example and each 64-row query block with a real row, qr =
    q . R^T (times scale * log2(e)) once, then the block's live key tiles
    (``live_tiles``, in the key chunk) in order.  Per tile: s2 = q . k^T *
    scale * log2(e) plus the bias, decided once per tile: one id for the
    whole tile (``uniform_tile_id``) adds one column of qr per row, or
    nothing when the id is out of vocabulary; else each pair's id
    (``_tile_pair_ids``).  The length term (-10000 in base 2; keys past the
    chunk count as padding) only on tiles that hold the length or the
    chunk's end, the window term only on tiles the band edge cuts; then the
    online softmax in base 2, the dropout keep factor after the row sum, p
    rounded to the compute dtype before p . v.  Positions, ids, masks and
    the hash are global (``q_start``, ``k_start``, ``batch_start``; multiples
    of 64 for the first two).  Returns (o in q.dtype, lse [B, H, S_q]
    float32 in natural log); query blocks past the length, and rows whose
    best logit carries a -10000 term (no live key: ``EMPTY_ROW_LOGIT2``),
    give o = 0 and lse = -inf, as the kernel writes them.

    ``tile_class`` "far" or "structured" is the split probe's cut of the
    kernel (csrc ``SplitPass``): each 64-row block visits only its key
    tiles of that class (``split_class_tiles``), and o comes back in
    float32, normalised by the pass's own row sum (dense, no offsets).
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    _check_tile_offsets(q_start, k_start, batch_start)
    if tile_class not in TILE_CLASSES:
        raise ValueError(f"tile_class must be one of {TILE_CLASSES}, got {tile_class!r}")
    if tile_class != "all" and (geometry is None or _windowed(geometry) or q_start or k_start):
        raise ValueError("a split class runs the dense forward with a bias and no offsets")
    batch, seq_q, num_heads, head_dim = q.shape
    seq_k = k.shape[1]
    c2 = math.log2(math.e) / math.sqrt(head_dim)
    mask2 = NEG_INF * math.log2(math.e)
    use_rel = rel_table is not None and geometry is not None
    vocab = rel_table.shape[0] if use_rel else 0
    geo = geometry if use_rel else RelGeometry(0)
    r = rel_table.to(q.dtype).float() if use_rel else None
    table = torch.from_numpy(image_id_table(geo)) if geo.image_len else None
    windowed = _windowed(geometry)
    qf, kf, vf = (t.float() for t in (q, k, v))
    o = torch.zeros_like(qf)
    lse = torch.full((batch, num_heads, seq_q), -math.inf, device=q.device)
    heads = torch.arange(num_heads, dtype=torch.int64, device=q.device)
    q_end, k_end = q_start + seq_q, k_start + seq_k
    for b in range(batch):
        length = int(lengths[b])
        key_end = min(length, k_end)  # keys past the chunk count as padding
        for q0 in range(q_start, min(length, q_end), TILE):
            qs = slice(q0 - q_start, min(q0 - q_start + TILE, seq_q))
            i_pos = torch.arange(q0, q0 + qs.stop - qs.start, device=q.device)
            qr = torch.einsum("ihd,vhd->hiv", qf[b, qs], r) * c2 if use_rel else None
            m = torch.full((num_heads, len(i_pos)), -math.inf, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(num_heads, len(i_pos), head_dim, device=q.device)
            tiles = (live_tiles(q0, key_end, geometry, k_start) if tile_class == "all"
                     else split_class_tiles(q0, q0, key_end, geometry, tile_class))
            for tile in tiles:
                k0 = tile * TILE
                ks = slice(k0 - k_start, min(k0 - k_start + TILE, seq_k))
                j_pos = torch.arange(k0, k0 + ks.stop - ks.start, device=q.device)
                s = torch.einsum("ihd,jhd->hij", qf[b, qs], kf[b, ks]) * c2
                tile_id = uniform_tile_id(q0, k0, geo) if use_rel else MAX_KERNEL_VOCAB
                if tile_id >= 0:
                    if tile_id < vocab:
                        s = s + qr[:, :, tile_id:tile_id + 1]
                else:
                    ids = _tile_pair_ids(geo, i_pos, j_pos, table)
                    in_vocab = ids < vocab
                    gathered = torch.gather(
                        qr, 2, torch.where(in_vocab, ids, 0).expand(num_heads, -1, -1))
                    s = s + torch.where(in_vocab, gathered, 0.0)
                if q0 + TILE > length or k0 + TILE > key_end:
                    pad = (i_pos[:, None] < length) != (j_pos[None, :] < key_end)
                    s = s + pad.float() * mask2
                if windowed and _window_cuts(q0, k0, q_end, k_end, geometry):
                    allowed = window_allowed(geometry, i_pos[:, None], j_pos[None, :])
                    s = s + torch.where(allowed, 0.0, mask2)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                m = m_new
                if dropout_rate > 0.0:
                    p = p * dropout_keep(example_seed(dropout_seed, batch_start + b),
                                         heads[:, None, None], i_pos[:, None], j_pos[None, :],
                                         dropout_rate)
                pv = torch.einsum("hij,jhd->hid", p.to(q.dtype).float(), vf[b, ks])
                acc = acc * alpha[..., None] + pv
            empty = m < EMPTY_ROW_LOGIT2  # no tile, or only masked pairs
            l = torch.where(empty, 1.0, l)
            o[b, qs] = torch.where(empty[..., None], 0.0, acc / l[..., None]).permute(1, 0, 2)
            lse[b, :, qs] = torch.where(empty, -math.inf, (m + torch.log2(l)) * math.log(2.0))
    return (o.to(q.dtype) if tile_class == "all" else o), lse


def relative_attention_backward_tiled(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel's schedule in plain PyTorch (float32, small
    shapes): the function of ``relative_attention_backward_plain``,
    computed as ``csrc/rel_attention_bwd.cu`` decomposes it.

    For each example and each 64-key block with a real key, the block's
    live query tiles (``live_tiles``, in the query chunk) are swept in
    order; each (query tile, key block) pair computes s, p, the dropout keep
    factor K and dS once, adds ``(p K)^T . do`` to dv and ``dS^T . q`` to
    dk, adds its dq contribution ``dS . k + dSV_tile . R_h`` to the query
    rows, and adds ``dSV_tile^T . q_tile`` to dRel, with ``dSV_tile[i, v]``
    the tile's per-row id histogram of dS.  Offsets as in
    ``relative_attention_forward_tiled``.  Returns (dq, dk, dv in q.dtype,
    drel [V, H, D] in the table's dtype or None), zero past each length.
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    _check_tile_offsets(q_start, k_start, batch_start)
    batch, seq_q, num_heads, head_dim = q.shape
    seq_k = k.shape[1]
    scale = 1.0 / math.sqrt(head_dim)
    q_pos, k_pos = _positions(q_start, seq_q, q.device), _positions(k_start, seq_k, q.device)
    ids = _plain_ids(geometry, rel_table, q_start, seq_q, k_start, seq_k, q.device)
    window = _window_term(geometry, q_pos, k_pos)
    use_rel = ids is not None
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    if use_rel:
        vocab = rel_table.shape[0]
        r = rel_table.to(q.dtype).float()
        safe_ids = torch.where(ids < vocab, ids.long(), vocab)
        drel = torch.zeros(vocab, num_heads, head_dim, dtype=torch.float32, device=q.device)
    heads = torch.arange(num_heads, dtype=torch.int64, device=q.device)
    for b in range(batch):
        length = int(lengths[b])
        q_real, k_real = min(length, q_start + seq_q), min(length, k_start + seq_k)
        for k0 in range(k_start, k_real, TILE):
            ks = slice(k0 - k_start, min(k0 - k_start + TILE, seq_k))
            j_pos = k_pos[ks]
            for tile in live_tiles(k0, q_real, geometry, q_start):
                qs = slice(tile * TILE - q_start, min(tile * TILE - q_start + TILE, seq_q))
                i_pos = q_pos[qs]
                s = torch.einsum("ihd,jhd->hij", qf[b, qs], kf[b, ks])
                if use_rel:
                    qr = torch.einsum("ihd,vhd->hiv", qf[b, qs], r)
                    tile_ids = ids[qs, ks].long()
                    in_vocab = tile_ids < vocab
                    gathered = torch.gather(
                        qr, 2, torch.where(in_vocab, tile_ids, 0).expand(num_heads, -1, -1))
                    s = s + torch.where(in_vocab, gathered, 0.0)
                s = s * scale
                real_i, real_j = i_pos < q_real, j_pos < k_real
                s = s + (real_i[:, None] != real_j[None, :]).float() * NEG_INF
                if window is not None:
                    s = s + window[qs, ks]
                lse_t = lse[b, :, qs].float()
                lse_t = torch.where(lse_t < -1e38, torch.full_like(lse_t, 3e38), lse_t)
                p = torch.exp(s - lse_t[..., None])
                keep = (dropout_keep(example_seed(dropout_seed, batch_start + b),
                                     heads[:, None, None], i_pos[:, None], j_pos[None, :],
                                     dropout_rate)
                        if dropout_rate > 0.0 else torch.ones((), device=q.device))
                real = real_i[:, None] & real_j[None, :]
                dp = torch.einsum("ihd,jhd->hij", dof[b, qs], vf[b, ks]) * keep
                ds = torch.where(real, p * (dp - delta[b, :, qs].float()[..., None]), 0.0)
                pk = torch.where(real, p * keep, 0.0)
                dv[b, ks] += torch.einsum("hij,ihd->jhd", pk, dof[b, qs])
                dk[b, ks] += torch.einsum("hij,ihd->jhd", ds, qf[b, qs]) * scale
                dq_tile = torch.einsum("hij,jhd->ihd", ds, kf[b, ks])
                if use_rel:
                    index = safe_ids[qs, ks].expand(num_heads, -1, -1)
                    dsv = torch.zeros(num_heads, qs.stop - qs.start, vocab + 1,
                                      device=q.device).scatter_add_(-1, index, ds)[..., :vocab]
                    dq_tile = dq_tile + torch.einsum("hiv,vhd->ihd", dsv, r)
                    drel += torch.einsum("hiv,ihd->vhd", dsv, qf[b, qs]) * scale
                dq[b, qs] += dq_tile * scale
    dq, dk, dv = (t.to(q.dtype) for t in (dq, dk, dv))
    return dq, dk, dv, drel.to(rel_table.dtype) if use_rel else None


# --------------------------------------------------------------- kernels


def _error_string(lib, err: int) -> str:
    return lib.mmt_cuda_error_string(err).decode()


# mmt_rel_attention_fwd's C arguments (csrc/rel_attention_fwd.cu).
FWD_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + [ctypes.c_float]
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def bind_fwd_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the forward library's C functions' types."""
    lib.mmt_rel_attention_fwd.argtypes = FWD_ARGTYPES
    lib.mmt_rel_attention_fwd.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    return bind_fwd_library(build.load_library("rel_attention_fwd"))


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    lib = build.load_library("rel_attention_bwd")
    fn = lib.mmt_rel_attention_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 16 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_rel_table(rel_table: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[V, H, D] table -> the kernels' [H, 64, D] layout in ``dtype``,
    rows >= V zero."""
    vocab, num_heads, head_dim = rel_table.shape
    out = torch.zeros(num_heads, MAX_KERNEL_VOCAB, head_dim, dtype=dtype,
                      device=rel_table.device)
    out[:, :vocab] = rel_table.to(dtype).permute(1, 0, 2)
    return out


def _check_devices(device: str, **tensors) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    for name, t in tensors.items():
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, expected {dev.type}")
    return dev


def _geometry_args(rel_table, geometry) -> Tuple[int, ...]:
    """The geometry as the kernels' 8 ints (image_len, num_patch_per_row,
    num_core_layers, text_max_distance, image_part_id, text_part_id, window,
    num_global; window and num_global 0 when dense); all 0 without a bias."""
    geo = geometry if rel_table is not None and geometry is not None else RelGeometry(0)
    window = geo.window if _windowed(geo) else 0
    return (geo.image_len, geo.num_patch_per_row, geo.num_core_layers,
            geo.text_max_distance, geo.image_part_id, geo.text_part_id,
            window, geo.num_global if window else 0)


def _geometry_from_args(geo_args) -> RelGeometry:
    """``_geometry_args``'s inverse (the bias-carrying case)."""
    _, num_patch_per_row, num_core_layers, text_max_distance, _, _, window, num_global = geo_args
    return RelGeometry(text_max_distance, num_patch_per_row, num_core_layers, window, num_global)


def _check_kernel_inputs(q, lengths, rel_table, geometry, keys=(), **same_shape):
    """Shape/dtype checks shared by the launchers; returns whether the bias
    is used, the relative vocab and the kernel's geometry arguments
    (``_geometry_args``).  ``same_shape`` tensors have q's shape; ``keys``
    (k, v) its batch, heads and head_dim with their own sequence length."""
    batch, seq_len, num_heads, head_dim = q.shape
    for name, t in same_shape.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernels take bf16 {name}, got {t.dtype}")
    for name, t in zip("kv", keys):
        if t.shape != keys[0].shape or t.shape[0] != batch or t.shape[2:] != q.shape[2:]:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)} and k {tuple(keys[0].shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernels take bf16 {name}, got {t.dtype}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the kernels take bf16 q/k/v, got {q.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernels take head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be [{batch}], got {tuple(lengths.shape)}")
    use_rel = rel_table is not None and geometry is not None
    vocab = rel_table.shape[0] if use_rel else 0
    if use_rel and (vocab > MAX_KERNEL_VOCAB
                    or rel_table.shape[1:] != (num_heads, head_dim)):
        raise ValueError(
            f"rel_table must be [V <= {MAX_KERNEL_VOCAB}, {num_heads}, {head_dim}], "
            f"got {tuple(rel_table.shape)}")
    if use_rel and geometry.image_len and geometry.num_patch_per_row > MAX_PATCH_PER_ROW:
        raise ValueError(f"the kernels take num_patch_per_row <= {MAX_PATCH_PER_ROW}, "
                         f"got {geometry.num_patch_per_row}")
    return use_rel, vocab, _geometry_args(rel_table, geometry)


def _kernel_table(rel_table, kernel_table):
    """The kernels' table: ``kernel_table`` (``kernel_rel_table(rel_table)``,
    built once by the caller) when given, else built here."""
    if kernel_table is None:
        return kernel_rel_table(rel_table)
    vocab, num_heads, head_dim = rel_table.shape
    if (kernel_table.shape != (num_heads, MAX_KERNEL_VOCAB, head_dim)
            or kernel_table.dtype != torch.bfloat16 or not kernel_table.is_contiguous()):
        raise ValueError(f"kernel_table must be contiguous bf16 [{num_heads}, "
                         f"{MAX_KERNEL_VOCAB}, {head_dim}], got {kernel_table.dtype} "
                         f"{tuple(kernel_table.shape)}")
    return kernel_table


def _contiguous_aligned(**tensors):
    out = []
    for name, t in tensors.items():
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        out.append(t)
    return out


def _int32(x) -> int:
    """``x`` wrapped to int32 (the C arguments' type)."""
    x = int(np.int64(x) & _U32)
    return x - (1 << 32) if x >= 1 << 31 else x


def _dropout_args(rate: float, seed, batch_start: int = 0):
    """(threshold, keep scale, int32 seed, int32 batch_start) for the
    kernels: ``batch_start`` is the global index of the call's example 0
    (a data-parallel shard's first example), which enters each example's
    hash seed."""
    if rate == 0.0:
        return 0, 1.0, 0, 0
    return dropout_threshold(rate), dropout_scale(rate), _int32(seed), _int32(batch_start)


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the kernel launchers are not differentiable; call relative_attention(), "
            "whose backward runs the backward kernel")


# The forward launcher as a registered torch op, so that a traced program
# (``torch.export``) holds one opaque call: its fake version gives the
# outputs' shapes, the CUDA version launches the kernel, the CPU version is
# the plain one.  Arguments are flat: the geometry as its 8 ints
# (``_geometry_args``), the dropout as its rate and int32 seed (0 at rate
# 0), then the offsets, which default to 0 (an artifact exported before
# they existed calls the op without them).  ``kernel_table`` is the table in
# the kernels' layout when the caller built it (CUDA only); the kernel
# builds it from ``rel_table`` otherwise.  The op's arguments do not hold
# ``head_start`` (it is folded into the seed), so the launcher marks a
# head-shard call in ``_head_shard_call`` for the CUDA version to count; a
# traced call (the fake version) launches nothing and counts nothing.

_head_shard_call = threading.local()


@torch.library.custom_op("mmt_tpu_torch::rel_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _rel_attention_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_table: Optional[torch.Tensor],
    kernel_table: Optional[torch.Tensor], lengths: torch.Tensor, image_len: int,
    num_patch_per_row: int, num_core_layers: int, text_max_distance: int,
    image_part_id: int, text_part_id: int, window: int, num_global: int,
    dropout_rate: float, dropout_seed: int, q_start: int = 0, k_start: int = 0,
    batch_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    batch, seq_q, num_heads, head_dim = q.shape
    seq_k = k.shape[1]
    q, k, v = _contiguous_aligned(q=q, k=k, v=v)
    rel = None
    if rel_table is not None:
        rel = _kernel_table(rel_table, kernel_table)
    lengths32 = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(batch, num_heads, seq_q, dtype=torch.float32, device=q.device)
    lib = _fwd_kernel()
    err = lib.mmt_rel_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        rel.data_ptr() if rel is not None else None,
        lengths32.data_ptr(), o.data_ptr(), lse.data_ptr(),
        batch, seq_q, seq_k, q_start, k_start, num_heads, head_dim,
        rel_table.shape[0] if rel_table is not None else 0,
        image_len, num_patch_per_row, num_core_layers, text_max_distance,
        image_part_id, text_part_id, window, num_global,
        1.0 / math.sqrt(head_dim),
        *_dropout_args(dropout_rate, dropout_seed, batch_start),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rel_attention_fwd launch failed: CUDA error {err} "
                           f"({_error_string(lib, err)})")
    if q_start or k_start or seq_q != seq_k:
        relative_attention_forward.launches_offset += 1
    elif window:
        relative_attention_forward.launches_window += 1
    else:
        relative_attention_forward.launches += 1
    if getattr(_head_shard_call, "active", False):
        relative_attention_forward.launches_head_shard += 1
    return o, lse


@_rel_attention_fwd_op.register_kernel("cpu")
def _rel_attention_fwd_cpu(q, k, v, rel_table, kernel_table, lengths, image_len,
                           num_patch_per_row, num_core_layers, text_max_distance,
                           image_part_id, text_part_id, window, num_global, dropout_rate,
                           dropout_seed, q_start=0, k_start=0, batch_start=0):
    geo_args = (image_len, num_patch_per_row, num_core_layers, text_max_distance,
                image_part_id, text_part_id, window, num_global)
    geometry = _geometry_from_args(geo_args) if rel_table is not None else None
    o, lse = relative_attention_plain(q, k, v, rel_table, geometry, lengths, dropout_rate,
                                      dropout_seed if dropout_rate > 0.0 else None,
                                      q_start, k_start, batch_start)
    return o.contiguous(), lse.contiguous()


@_rel_attention_fwd_op.register_fake
def _rel_attention_fwd_fake(q, k, v, rel_table, kernel_table, lengths, *geo_dropout_offsets):
    batch, seq_q, num_heads, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((batch, num_heads, seq_q), dtype=torch.float32))


def relative_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    device: str = "cuda",
    dropout_rate: float = 0.0,
    dropout_seed=None,
    kernel_table: Optional[torch.Tensor] = None,
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
    head_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relative attention forward -> (o [B,S_q,H,D], lse [B,H,S_q] fp32).

    ``device`` names where the tensors must lie.  On ``"cuda"`` the Hopper
    kernel runs (bf16 q/k/v, head_dim 32 or 64, relative vocab <= 64), its
    windowed variant when ``geometry.window > 0``, or this raises; on
    ``"cpu"`` the plain version runs.  Both go through the registered op
    ``torch.ops.mmt_tpu_torch.rel_attention_fwd``, which counts the
    kernel's launches.  Not differentiable:
    raises when grad mode is on and an input requires grad
    (``relative_attention`` is the differentiable op).

    Args:
      q: <float>[B, S_q, num_heads, head_dim]; k, v: [B, S_k, ...].
      rel_table: <float32>[V, num_heads, head_dim] or None (no bias).
      geometry: the id scheme, or None (no bias).
      lengths: <int>[B] real lengths (global positions).
      dropout_rate, dropout_seed: in-kernel attention-probs dropout (the
        hash of ``dropout_keep``, per-example seed
        ``seed + (batch_start + b) * -1771729351``); the seed is required
        when the rate > 0.
      kernel_table: ``kernel_rel_table(rel_table)``, when the caller
        already built it (CUDA only); else it is built here.
      q_start, k_start, batch_start: the global positions of q's first row
        and k's first key (multiples of 64 on the card) and the global
        index of the first example (module docstring).
      head_start: the global index of q's first head for a tensor-parallel
        head shard; the dropout hash takes global heads, so it is folded
        into the seed (``head_seed``) and the kernel runs unchanged.  A
        launch with a nonzero ``head_start`` also counts in
        ``.launches_head_shard``.
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    _check_offsets(q_start, k_start, batch_start)
    _refuse_grad(q, k, v, rel_table)
    dev = _check_devices(device, q=q, k=k, v=v, lengths=lengths)
    if rel_table is None or geometry is None:
        rel_table = kernel_table = None
    if dev.type == "cuda":
        _check_tile_offsets(q_start, k_start, batch_start)
        _, _, geo_args = _check_kernel_inputs(q, lengths, rel_table, geometry, keys=(k, v))
        if rel_table is not None:
            kernel_table = _kernel_table(rel_table, kernel_table)
    else:
        geo_args, kernel_table = _geometry_args(rel_table, geometry), None
    seed = head_seed(dropout_seed, head_start) if dropout_rate > 0.0 else 0
    _head_shard_call.active = bool(head_start)
    try:
        return _rel_attention_fwd_op(q, k, v, rel_table, kernel_table, lengths, *geo_args,
                                     float(dropout_rate), seed, q_start, k_start, batch_start)
    finally:
        _head_shard_call.active = False


relative_attention_forward.launches = 0
relative_attention_forward.launches_window = 0
relative_attention_forward.launches_offset = 0
relative_attention_forward.launches_head_shard = 0


def relative_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    device: str = "cuda",
    dropout_rate: float = 0.0,
    dropout_seed=None,
    kernel_table: Optional[torch.Tensor] = None,
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
    head_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fused relative attention backward -> (dq, dk, dv, drel).

    On ``"cuda"`` launches the Hopper kernel (one pass over each (query,
    key) pair; bf16 q/k/v/do, fp32 lse/delta; its windowed variant when
    ``geometry.window > 0``) or raises; on ``"cpu"`` returns
    ``relative_attention_backward_plain``.  dq/dk/dv come in q.dtype (the
    kernel adds dq in an fp32 buffer, cast here); drel is [V, H, D] in the
    table's dtype (summed over the batch here, as
    ``pallas_attention.py:2972`` does), or None without a table.
    Arguments as in ``relative_attention_backward_plain``;
    ``kernel_table`` and the offsets, ``head_start`` included, as in
    ``relative_attention_forward`` (dk, dv: [B, S_k, H, D]).
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    _check_offsets(q_start, k_start, batch_start)
    dev = _check_devices(device, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                         lengths=lengths)
    if dropout_rate > 0.0:
        dropout_seed = head_seed(dropout_seed, head_start)
    if dev.type == "cpu":
        return relative_attention_backward_plain(q, k, v, do, lse, delta, rel_table,
                                                 geometry, lengths, dropout_rate,
                                                 dropout_seed, q_start, k_start, batch_start)

    _check_tile_offsets(q_start, k_start, batch_start)
    batch, seq_len, num_heads, head_dim = q.shape
    use_rel, vocab, geo_args = _check_kernel_inputs(q, lengths, rel_table, geometry,
                                                    keys=(k, v), do=do)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (batch, num_heads, seq_len) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{batch}, {num_heads}, {seq_len}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    q, k, v, do = _contiguous_aligned(q=q, k=k, v=v, do=do)
    lse, delta = lse.contiguous(), delta.contiguous()
    rel = _kernel_table(rel_table, kernel_table) if use_rel else None
    lengths32 = lengths.to(torch.int32).contiguous()
    # dq is summed over key blocks by reductions into fp32; rows past the
    # length receive none and stay 0.  dRel per example, summed below.
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    drel_b = (torch.zeros(batch, num_heads, MAX_KERNEL_VOCAB, head_dim,
                          dtype=torch.float32, device=q.device) if use_rel else None)
    lib = _bwd_kernel()
    err = lib.mmt_rel_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), rel.data_ptr() if rel is not None else None, lengths32.data_ptr(),
        dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        drel_b.data_ptr() if drel_b is not None else None,
        batch, seq_len, k.shape[1], q_start, k_start, num_heads, head_dim, vocab, *geo_args,
        1.0 / math.sqrt(head_dim),
        *_dropout_args(dropout_rate, dropout_seed, batch_start),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rel_attention_bwd launch failed: CUDA error {err} "
                           f"({_error_string(lib, err)})")
    if q_start or k_start or seq_len != k.shape[1]:
        relative_attention_backward.launches_offset += 1
    elif _windowed(geometry):
        relative_attention_backward.launches_window += 1
    else:
        relative_attention_backward.launches += 1
    if head_start:
        relative_attention_backward.launches_head_shard += 1
    drel = None
    if use_rel:
        drel = drel_b.sum(0)[:, :vocab].permute(1, 0, 2).to(rel_table.dtype)
    return dq32.to(q.dtype), dk, dv, drel


relative_attention_backward.launches = 0
relative_attention_backward.launches_window = 0
relative_attention_backward.launches_offset = 0
relative_attention_backward.launches_head_shard = 0


# ------------------------------------------------------ differentiable op


class RelativeAttentionFunction(torch.autograd.Function):
    """Forward by ``relative_attention_forward``, backward by
    ``relative_attention_backward``: the counterpart of the JAX
    ``custom_vjp`` around ``_attention_forward`` / ``_attention_backward``
    (``pallas_attention.py:3105-3140``).  Saves q, k, v, o and lse as the
    JAX residuals do; delta = rowsum(do * o) is computed here in plain
    torch, outside the kernels (``:2842``).  On CUDA the table's kernel
    layout is built once and kept for the backward.  ``offsets`` is
    (q_start, k_start, batch_start, head_start)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_table, lengths, geometry, dropout_rate, dropout_seed,
                device, offsets=(0, 0, 0, 0)):
        kernel_table = None
        if rel_table is not None and torch.device(device).type == "cuda":
            kernel_table = kernel_rel_table(rel_table)
        o, lse = relative_attention_forward(q, k, v, rel_table, geometry, lengths,
                                            device, dropout_rate, dropout_seed, kernel_table,
                                            *offsets)
        ctx.save_for_backward(q, k, v, rel_table, lengths, o, lse)
        ctx.kernel_table = kernel_table
        ctx.geometry, ctx.device, ctx.offsets = geometry, device, offsets
        ctx.dropout_rate, ctx.dropout_seed = dropout_rate, dropout_seed
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, rel_table, lengths, o, lse = ctx.saved_tensors
        delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
        dq, dk, dv, drel = relative_attention_backward(
            q, k, v, do.to(q.dtype), lse, delta, rel_table, ctx.geometry, lengths,
            ctx.device, ctx.dropout_rate, ctx.dropout_seed, ctx.kernel_table, *ctx.offsets)
        if rel_table is None or not ctx.needs_input_grad[3]:
            drel = None
        return dq, dk, dv, drel, None, None, None, None, None, None


def relative_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    device: str = "cuda",
    q_start: int = 0,
    k_start: int = 0,
    batch_start: int = 0,
    head_start: int = 0,
) -> torch.Tensor:
    """Fused, differentiable relative attention -> o [B, S_q, H, D] (q.dtype).

    Mirrors ``pallas_relative_attention``: ``dropout_rate`` applies the
    reference-order attention-probs dropout inside the kernels, from a
    hash of (dropout_seed, example, head, query, key) that the backward
    regenerates; ``dropout_seed`` (an int32) is required when
    ``dropout_rate > 0`` -- derive one per call.  ``geometry.window > 0``
    adds the sliding-window + prefix-global pattern (it needs the table).
    On ``"cuda"`` the forward and backward run the Hopper kernels; on
    ``"cpu"`` their plain versions.  ``q_start``, ``k_start`` and
    ``batch_start`` as in ``relative_attention_forward`` (JAX's ``qoff``);
    ``head_start`` (a tensor-parallel head shard: q, k, v hold heads
    ``[head_start, head_start + H)`` and ``rel_table`` their slice) too.
    """
    _check_pattern(geometry, rel_table)
    _check_dropout(dropout_rate, dropout_seed)
    if rel_table is None or geometry is None:
        rel_table = geometry = None
    o, _ = RelativeAttentionFunction.apply(q, k, v, rel_table, lengths, geometry,
                                           float(dropout_rate), dropout_seed, device,
                                           (q_start, k_start, batch_start, head_start))
    return o
