"""Fused relative-bias attention: the Hopper kernels and their plain versions.

Counterpart of ``mmt_tpu/ops/pallas_attention.py``, forward and backward.

* Forward kernel ``mmt_tpu_torch/csrc/rel_attention_fwd.cu`` replaces the
  TPU kernels K1 ``_fwd_kernel`` and K2 ``_fwd_list_kernel`` (with the
  split schedule's logsumexp combine and the image-corner build) by one
  flash-attention pass that regenerates the relative ids from positions
  and applies the attention dropout in the kernel.
* Backward kernels ``mmt_tpu_torch/csrc/rel_attention_bwd.cu`` replace K3
  ``_bwd_fused_kernel`` and K5 ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
  by K5's two-pass schedule: a dq + dRel pass and a dk/dv pass.

Public pieces:

* ``relative_attention`` is the differentiable op the model calls
  (``RelativeAttentionFunction``, the counterpart of the JAX
  ``custom_vjp`` ``pallas_relative_attention``).
* ``relative_attention_forward`` / ``relative_attention_backward`` are
  the launchers: on CUDA tensors they launch the kernels or raise; on CPU
  tensors they return the plain versions.  Each launcher counts its
  kernel launches: ``relative_attention_forward.launches`` and, one per
  backward kernel, ``relative_attention_backward.launches_dq`` /
  ``.launches_dkv``.
* ``relative_attention_plain`` / ``relative_attention_backward_plain``
  are the plain PyTorch versions: dense formulas over the materialised id
  map, chunked over the batch.
* ``dropout_keep`` / ``dropout_tile`` are a bit-exact copy of the JAX
  dropout hash.

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
# Relative-vocab columns the kernels keep per query row (csrc kVP).
MAX_KERNEL_VOCAB = 64
KERNEL_HEAD_DIMS = (32, 64)
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


def _dropout_block(seed, batch_ids: torch.Tensor, num_heads: int, seq_len: int,
                   rate: float) -> torch.Tensor:
    """[b, H, S, S] keep factors for the examples ``batch_ids``."""
    dev = batch_ids.device
    pos = torch.arange(seq_len, dtype=torch.int64, device=dev)
    heads = torch.arange(num_heads, dtype=torch.int64, device=dev)
    seeds = example_seed(seed, batch_ids.to(torch.int64))
    return dropout_keep(seeds[:, None, None, None], heads[None, :, None, None],
                        pos[:, None], pos[None, :], rate)


def _check_dropout(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        # A silently defaulted seed would repeat the same mask every step.
        raise ValueError(
            "dropout_seed is required when dropout_rate > 0 "
            "(derive a distinct int32 seed per training step)")


# ------------------------------------------------------- plain versions


def _plain_ids(geometry, rel_table, seq_len, device):
    if rel_table is None or geometry is None:
        return None
    return torch.from_numpy(relative_att_ids(geometry, seq_len)).to(device)


def _masked_logits(q, k, rel_table, ids, lengths):
    seq_len = q.shape[1]
    logits = relative_attention_scores(q, k, rel_table, ids)
    mask = make_att_mask_from_length(seq_len, lengths)
    return logits + (1.0 - mask[:, None].float()) * NEG_INF


def relative_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked relative attention -> (o [B,S,H,D] q.dtype, lse [B,H,S] fp32).

    Logits, the -10000 length mask, softmax and lse are float32.  The
    dropout keep factors (the hash of ``dropout_keep``) multiply the
    probabilities after the softmax; the probabilities are then rounded
    to the compute dtype before ``p . v`` (summed in float32), as the
    kernel does.  The batch is processed in chunks of at most 1 GiB of
    logits.  Differentiable by autograd.
    """
    _check_pattern(geometry)
    _check_dropout(dropout_rate, dropout_seed)
    batch, seq_len, num_heads, _ = q.shape
    ids = _plain_ids(geometry, rel_table, seq_len, q.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // (num_heads * seq_len * seq_len))
    outs, lses = [], []
    for b0 in range(0, batch, chunk):
        sl = slice(b0, b0 + chunk)
        logits = _masked_logits(q[sl], k[sl], rel_table, ids, lengths[sl])
        lses.append(torch.logsumexp(logits, dim=-1))
        probs = torch.softmax(logits, dim=-1)
        del logits
        if dropout_rate > 0.0:
            rows = torch.arange(b0, b0 + probs.shape[0], device=q.device)
            probs = probs * _dropout_block(dropout_seed, rows, num_heads, seq_len,
                                           dropout_rate)
        probs = probs.to(q.dtype)
        outs.append(
            torch.einsum("bhqk,bkhd->bqhd", probs.float(), v[sl].float()).to(q.dtype)
        )
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Dense backward -> (dq, dk, dv in q.dtype, drel [V,H,D] in the table's dtype or None).

    With s the scaled logits, P = exp(s - lse), K the dropout keep
    factors, delta = rowsum(do * o) and "real" the pairs whose query and
    key are both real (< length):

      dv   = (P * K * real)^T . do
      dS   = P * (do . v^T * K - delta) * real
      dq   = scale * (dS . k + dSV . R_h),  dSV[i, v] = sum_{j: id(i,j)=v} dS_ij
      dk   = scale * dS^T . q
      dRel = scale * sum_b dSV^T . q

    in float32 from the given tensors (R rounded to the compute dtype, as
    in the forward).  ``lse`` below -1e38 (a row with no live key tile)
    is clamped to 3e38, as the kernels do.  Chunked over the batch like
    the forward.

    Args:
      q, k, v, do: <float>[B, S, H, D].
      lse, delta: <float32>[B, H, S].
      rel_table: <float>[V, H, D] or None.
    """
    _check_pattern(geometry)
    _check_dropout(dropout_rate, dropout_seed)
    batch, seq_len, num_heads, head_dim = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    ids = _plain_ids(geometry, rel_table, seq_len, q.device)
    use_rel = ids is not None
    if use_rel:
        vocab = rel_table.shape[0]
        r = rel_table.to(q.dtype).float()
        safe_ids = torch.where(ids < vocab, ids.long(), vocab)  # column V collects OOV ids
        drel = torch.zeros(vocab, num_heads, head_dim, dtype=torch.float32, device=q.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // (num_heads * seq_len * seq_len))
    pos = torch.arange(seq_len, device=q.device)
    dqs, dks, dvs = [], [], []
    for b0 in range(0, batch, chunk):
        sl = slice(b0, b0 + chunk)
        qf, kf, vf, dof = (t[sl].float() for t in (q, k, v, do))
        s = _masked_logits(q[sl], k[sl], rel_table if use_rel else None, ids, lengths[sl])
        lse_c = lse[sl].float()
        lse_c = torch.where(lse_c < -1e38, torch.full_like(lse_c, 3e38), lse_c)
        p = torch.exp(s - lse_c[..., None])
        del s
        real = pos[None, :] < lengths[sl].to(q.device)[:, None]  # [b, S]
        pair = (real[:, :, None] & real[:, None, :])[:, None]  # [b, 1, S, S]
        dp = torch.einsum("bihd,bjhd->bhij", dof, vf)
        if dropout_rate > 0.0:
            rows = torch.arange(b0, b0 + p.shape[0], device=q.device)
            keep = _dropout_block(dropout_seed, rows, num_heads, seq_len, dropout_rate)
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


# --------------------------------------------------------------- kernels


def _error_string(lib, err: int) -> str:
    return lib.mmt_cuda_error_string(err).decode()


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    lib = build.load_library("rel_attention_fwd")
    fn = lib.mmt_rel_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = build.load_library("rel_attention_bwd")
    for fn in (lib.mmt_rel_attention_bwd_dq, lib.mmt_rel_attention_bwd_dkv):
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_float]
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


def _check_kernel_inputs(q, lengths, rel_table, geometry, **same_shape):
    """Shape/dtype/alignment checks shared by the launchers; returns the
    kernel's geometry arguments."""
    batch, seq_len, num_heads, head_dim = q.shape
    for name, t in same_shape.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
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
    geo = geometry if use_rel else RelGeometry(0)
    return use_rel, vocab, (geo.image_len, geo.num_patch_per_row, geo.num_core_layers,
                            geo.text_max_distance, geo.image_part_id, geo.text_part_id)


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


def _dropout_args(rate: float, seed):
    """(threshold, keep scale, int32 seed, batch_start) for the kernels.
    The kernels take whole batches, so example 0 is global example 0."""
    if rate == 0.0:
        return 0, 1.0, 0, 0
    seed32 = int(np.int64(seed) & _U32)
    seed32 = seed32 - (1 << 32) if seed32 >= 1 << 31 else seed32
    return dropout_threshold(rate), dropout_scale(rate), seed32, 0


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the kernel launchers are not differentiable; call relative_attention(), "
            "whose backward runs the backward kernels")


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relative attention forward -> (o [B,S,H,D], lse [B,H,S] fp32).

    ``device`` names where the tensors must lie.  On ``"cuda"`` the Hopper
    kernel runs (bf16 q/k/v, head_dim 32 or 64, relative vocab <= 64) or
    this raises; on ``"cpu"`` the plain version runs.  Not differentiable:
    raises when grad mode is on and an input requires grad
    (``relative_attention`` is the differentiable op).

    Args:
      q, k, v: <float>[B, S, num_heads, head_dim].
      rel_table: <float32>[V, num_heads, head_dim] or None (no bias).
      geometry: the id scheme, or None (no bias).
      lengths: <int>[B] real lengths.
      dropout_rate, dropout_seed: in-kernel attention-probs dropout (the
        hash of ``dropout_keep``, per-example seed
        ``seed + b * -1771729351``); the seed is required when the rate > 0.
      kernel_table: ``kernel_rel_table(rel_table)``, when the caller
        already built it (CUDA only); else it is built here.
    """
    _check_pattern(geometry)
    _check_dropout(dropout_rate, dropout_seed)
    _refuse_grad(q, k, v, rel_table)
    dev = _check_devices(device, q=q, k=k, v=v, lengths=lengths)
    if dev.type == "cpu":
        return relative_attention_plain(q, k, v, rel_table, geometry, lengths,
                                        dropout_rate, dropout_seed)

    batch, seq_len, num_heads, head_dim = q.shape
    use_rel, vocab, geo_args = _check_kernel_inputs(q, lengths, rel_table, geometry, k=k, v=v)
    q, k, v = _contiguous_aligned(q=q, k=k, v=v)
    rel = _kernel_table(rel_table, kernel_table) if use_rel else None
    lengths32 = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(batch, num_heads, seq_len, dtype=torch.float32, device=q.device)
    lib = _fwd_kernel()
    err = lib.mmt_rel_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        rel.data_ptr() if rel is not None else None,
        lengths32.data_ptr(), o.data_ptr(), lse.data_ptr(),
        batch, seq_len, num_heads, head_dim, vocab, *geo_args,
        1.0 / math.sqrt(head_dim),
        *_dropout_args(dropout_rate, dropout_seed),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rel_attention_fwd launch failed: CUDA error {err} "
                           f"({_error_string(lib, err)})")
    relative_attention_forward.launches += 1
    return o, lse


relative_attention_forward.launches = 0


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fused relative attention backward -> (dq, dk, dv, drel).

    On ``"cuda"`` launches the two Hopper kernels (dq + per-example dRel,
    then dk/dv; bf16 q/k/v/do, fp32 lse/delta) or raises; on ``"cpu"``
    returns ``relative_attention_backward_plain``.  dq/dk/dv come in
    q.dtype; drel is [V, H, D] in the table's dtype (summed over the
    batch here, as ``pallas_attention.py:2972`` does), or None without a
    table.  Arguments as in ``relative_attention_backward_plain``;
    ``kernel_table`` as in ``relative_attention_forward``.
    """
    _check_pattern(geometry)
    _check_dropout(dropout_rate, dropout_seed)
    dev = _check_devices(device, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                         lengths=lengths)
    if dev.type == "cpu":
        return relative_attention_backward_plain(q, k, v, do, lse, delta, rel_table,
                                                 geometry, lengths, dropout_rate,
                                                 dropout_seed)

    batch, seq_len, num_heads, head_dim = q.shape
    use_rel, vocab, geo_args = _check_kernel_inputs(q, lengths, rel_table, geometry,
                                                    k=k, v=v, do=do)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (batch, num_heads, seq_len) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{batch}, {num_heads}, {seq_len}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    q, k, v, do = _contiguous_aligned(q=q, k=k, v=v, do=do)
    lse, delta = lse.contiguous(), delta.contiguous()
    rel = _kernel_table(rel_table, kernel_table) if use_rel else None
    lengths32 = lengths.to(torch.int32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Per-example dRel, summed by atomics over the example's query tiles.
    drel_b = (torch.zeros(batch, num_heads, MAX_KERNEL_VOCAB, head_dim,
                          dtype=torch.float32, device=q.device) if use_rel else None)
    lib = _bwd_kernels()
    common = (
        batch, seq_len, num_heads, head_dim, vocab, *geo_args,
        1.0 / math.sqrt(head_dim),
        *_dropout_args(dropout_rate, dropout_seed),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), rel.data_ptr() if rel is not None else None,
              lengths32.data_ptr())
    err = lib.mmt_rel_attention_bwd_dq(
        *inputs, dq.data_ptr(), drel_b.data_ptr() if drel_b is not None else None, *common)
    if err:
        raise RuntimeError(f"rel_attention_bwd dq launch failed: CUDA error {err} "
                           f"({_error_string(lib, err)})")
    relative_attention_backward.launches_dq += 1
    err = lib.mmt_rel_attention_bwd_dkv(*inputs, dk.data_ptr(), dv.data_ptr(), *common)
    if err:
        raise RuntimeError(f"rel_attention_bwd dkv launch failed: CUDA error {err} "
                           f"({_error_string(lib, err)})")
    relative_attention_backward.launches_dkv += 1
    drel = None
    if use_rel:
        drel = drel_b.sum(0)[:, :vocab].permute(1, 0, 2).to(rel_table.dtype)
    return dq, dk, dv, drel


relative_attention_backward.launches_dq = 0
relative_attention_backward.launches_dkv = 0


# ------------------------------------------------------ differentiable op


class RelativeAttentionFunction(torch.autograd.Function):
    """Forward by ``relative_attention_forward``, backward by
    ``relative_attention_backward``: the counterpart of the JAX
    ``custom_vjp`` around ``_attention_forward`` / ``_attention_backward``
    (``pallas_attention.py:3105-3140``).  Saves q, k, v, o and lse as the
    JAX residuals do; delta = rowsum(do * o) is computed here in plain
    torch, outside the kernels (``:2842``).  On CUDA the table's kernel
    layout is built once and kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, rel_table, lengths, geometry, dropout_rate, dropout_seed,
                device):
        kernel_table = None
        if rel_table is not None and torch.device(device).type == "cuda":
            kernel_table = kernel_rel_table(rel_table)
        o, lse = relative_attention_forward(q, k, v, rel_table, geometry, lengths,
                                            device, dropout_rate, dropout_seed, kernel_table)
        ctx.save_for_backward(q, k, v, rel_table, lengths, o, lse)
        ctx.kernel_table = kernel_table
        ctx.geometry, ctx.device = geometry, device
        ctx.dropout_rate, ctx.dropout_seed = dropout_rate, dropout_seed
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, rel_table, lengths, o, lse = ctx.saved_tensors
        delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
        dq, dk, dv, drel = relative_attention_backward(
            q, k, v, do.to(q.dtype), lse, delta, rel_table, ctx.geometry, lengths,
            ctx.device, ctx.dropout_rate, ctx.dropout_seed, ctx.kernel_table)
        if rel_table is None or not ctx.needs_input_grad[3]:
            drel = None
        return dq, dk, dv, drel, None, None, None, None, None


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
) -> torch.Tensor:
    """Fused, differentiable relative attention -> o [B, S, H, D] (q.dtype).

    Mirrors ``pallas_relative_attention``: ``dropout_rate`` applies the
    reference-order attention-probs dropout inside the kernels, from a
    hash of (dropout_seed, example, head, query, key) that the backward
    regenerates; ``dropout_seed`` (an int32) is required when
    ``dropout_rate > 0`` -- derive one per call.  On ``"cuda"`` the
    forward and backward run the Hopper kernels; on ``"cpu"`` their plain
    versions.
    """
    _check_dropout(dropout_rate, dropout_seed)
    if rel_table is None or geometry is None:
        rel_table = geometry = None
    o, _ = RelativeAttentionFunction.apply(q, k, v, rel_table, lengths, geometry,
                                           float(dropout_rate), dropout_seed, device)
    return o
