"""Cost of each op family inside the forward kernel's grid, on the card.

Counterpart of ``scripts/op_cost_probe.py``: the flagship attention
kernel's grid, a common baseline, one op family added per variant; a
variant's time minus the baseline's is that family's cost over the grid.
One templated kernel, ``csrc/probe_op_cost.cu``, on the production
forward's grid and tile walk (one block per 64 query rows of one (batch,
head), key tiles of 64 below the length).  Every variant writes

    out[b, h, i] = sum_{j < 64 ceil(L_b / 64)} x(i, j) + qr[i, 0] (+ extra)

for rows below ``64 ceil(L_b / 64)`` and 0 past them, so nothing it
computes is dead code.  ``VARIANTS`` names them; the source's header says
what each adds.  ``gather`` contains ``ids`` and ``reduce`` contains
``exp``: their own costs are the differences, which ``run`` prints too.

The TPU script's variants that price TPU-only devices have no counterpart
on the card and are not ported: the lane rolls (``roll``, ``roll_static``,
``rollu``, ``rollneg``, ``narrowroll``), the band strip built by lane
concatenation (``strip``), the sublane flips (``rev``, ``revrollrev``), the
skew-roll band gather (``deskew``), the outer-product broadcasts through
the matrix unit (``rank1dot``, ``rank2dot``) and the select / multiply
spellings of one vector-unit bias chain (``iota2``, ``cmp2sel``,
``select3``, ``leanbias``, ``mulbias``, ``mixbias``, ``selmul``, ``cond2``,
``bcast``, ``bcast2``).  The card's counterparts of what they were for are
``ids``, ``gather`` and ``rank1``.

Run on the card::

    python -m mmt_tpu_torch.probes.op_cost_probe [variant ...]

Each variant is first held against ``op_cost_plain`` at B=1, H=2, S=512,
then timed at the retrieval shape (B=32, S=4096, H=12, D=64, lengths ~
U[2048, 4096]) with CUDA events; one line per variant: ms and the delta
against the baseline.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmt_tpu_torch.ops import build
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.probes import common
from mmt_tpu_torch.probes.common import TILE

# In the order of the kernel's ``Variant`` enum.
VARIANTS = ("base", "ids", "gather", "rank1", "mask", "window", "hash", "exp", "reduce", "pv",
            "kt_store", "ldmatrix_trans", "cp_async", "wgmma_qk", "atomics")
# Variants whose result is the baseline's (another way to the same numbers).
SAME_AS_BASE = ("cp_async", "wgmma_qk")
# The sliding-window pattern and the dropout the ``window`` / ``hash``
# variants use: the 4k pretraining configuration's.
WINDOW, NUM_GLOBAL = 512, 198
DROPOUT_RATE, DROPOUT_SEED = 0.1, 20260
ATOMIC_ROWS = 49
# Each result is a float32 sum of up to 4096 terms taken in another order
# than the plain version's (and, for `atomics`, in an order that changes
# from run to run): a few 1e-6 of the largest magnitude.  `pv` rounds x to
# bf16 before the product, and a sum that lands on the other side of a
# rounding boundary moves one term by 2**-8 of itself: still below 1e-4 of
# the row's total.  Held to max |kernel - plain| <= REL_BOUND * max |plain|.
REL_BOUND = 1e-4
# `pv` at the retrieval shape: over up to 4096 keys a handful of x(i, j)
# land on the other side of a bf16 rounding boundary than the plain
# version's (the products' float32 sums are taken in another order), and
# each moves its term by one bf16 spacing of x times |sum_d v[j, d]|, up to
# a few units where the row's total is some 1e4.  Every other variant holds
# REL_BOUND there too.  A skipped key tile or a wrong stride moves a row by
# 1e-2 of the largest magnitude or more.
PV_RETRIEVAL_REL_BOUND = 1e-3
# The check's shape: the length is no multiple of 64, so the last visited
# tile holds masked keys, and its window is narrow enough to disallow pairs.
CHECK_SHAPE = dict(lengths=[431], seq_len=512, heads=2)
CHECK_WINDOW, CHECK_NUM_GLOBAL = 96, 70


def _tile_start(pos: torch.Tensor) -> torch.Tensor:
    return pos // TILE * TILE


def variant_term(variant: str, qr: torch.Tensor, geometry: fa.RelGeometry, seq_len: int,
                 length: int, window: int = WINDOW, num_global: int = NUM_GLOBAL,
                 ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """<float32>[H, S, S] (or broadcastable): what ``ids`` / ``gather`` /
    ``rank1`` / ``mask`` / ``window`` add to x(i, j), for one example with
    ``qr`` [H, S, V] = q . R^T.  ``ids`` is the [S, S] id map, made here
    when not given."""
    dev = qr.device
    pos = torch.arange(seq_len, device=dev)
    i, j = pos[:, None], pos[None, :]
    if variant in ("ids", "gather"):
        if ids is None:
            ids = torch.from_numpy(fa.relative_att_ids(geometry, seq_len)).to(dev).long()
        if variant == "ids":
            return ids.float()[None]
        valid = ids < qr.shape[-1]
        index = torch.where(valid, ids, 0)[None].expand(qr.shape[0], -1, -1)
        return torch.where(valid[None], torch.gather(qr, -1, index), 0.0)
    if variant == "rank1":
        d = geometry.text_max_distance
        right = _tile_start(j) > _tile_start(i)
        return torch.where(right[None], qr[:, :, d, None], qr[:, :, 2 * d, None])
    if variant == "mask":
        return torch.where((i < length) != (j < length), fa.NEG_INF, 0.0)[None]
    if variant == "window":
        allowed = (i < num_global) | (j < num_global) | ((j - i).abs() <= window)
        return torch.where(allowed, 0.0, fa.NEG_INF)[None]
    raise ValueError(f"variant {variant!r} adds no per-element term")


def op_cost_plain(variant: str, q, k, v, rel_table, geometry: fa.RelGeometry, lengths,
                  window: int = WINDOW,
                  num_global: int = NUM_GLOBAL) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of one variant -> (out fp32 [B, H, S],
    out2 fp32 [B, H, 64, 64] for ``atomics`` else None).  Float32 sums of
    the compute-dtype inputs, one example at a time."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    batch, seq_len, num_heads, head_dim = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    table = rel_table.to(q.dtype).float()
    pos = torch.arange(seq_len, device=q.device)
    out = torch.zeros(batch, num_heads, seq_len, dtype=torch.float32, device=q.device)
    out2 = ids = None
    if variant == "atomics":
        out2 = torch.zeros(batch, num_heads, fa.MAX_KERNEL_VOCAB, head_dim, dtype=torch.float32,
                           device=q.device)
    if variant in ("ids", "gather"):
        ids = torch.from_numpy(fa.relative_att_ids(geometry, seq_len)).to(q.device).long()
    for b in range(batch):
        length = max(0, min(int(lengths[b]), seq_len))
        n = -(-length // TILE) * TILE  # rows and keys the walk visits
        if n == 0:
            continue
        qf, kf, vf = q[b].float(), k[b].float(), v[b].float()
        x = torch.einsum("ihd,jhd->hij", qf, kf)
        qr = torch.einsum("ihd,vhd->hiv", qf, table)
        extra = 0.0
        if variant in ("ids", "gather", "rank1", "mask", "window"):
            x = x + variant_term(variant, qr, geometry, seq_len, length, window, num_global,
                                 ids)
        elif variant == "hash":
            heads = torch.arange(num_heads, device=q.device)
            keep = fa.dropout_keep(fa.example_seed(DROPOUT_SEED, b), heads[:, None, None],
                                   pos[:, None], pos[None, :], DROPOUT_RATE)
            x = x * keep.to(q.device)
        elif variant in ("exp", "reduce"):
            x = x * scale
        visited = (pos < n)[None, None, :]
        if variant == "reduce":
            total = torch.logsumexp(x.masked_fill(~visited, -math.inf), dim=-1)
        else:
            if variant == "exp":
                x = torch.exp(x)
            total = torch.where(visited, x, 0.0).sum(-1)
        if variant == "pv":
            p = torch.where(visited, x, 0.0).to(q.dtype).float()
            extra = torch.einsum("hij,jh->hi", p, vf.sum(-1))
        elif variant in ("kt_store", "ldmatrix_trans"):
            # Column sums of the visited V rows by d mod 8; row i gets class i mod 8.
            by_class = vf[:n].sum(0).reshape(num_heads, head_dim // 8, 8).sum(1)  # [H, 8]
            extra = by_class[:, pos % 8]
        elif variant == "atomics":
            tiles = qf[:n].reshape(n // TILE, TILE, num_heads, head_dim)
            starts = torch.arange(0, n, TILE, device=q.device)
            tiles = tiles[starts < length]
            out2[b, :, :ATOMIC_ROWS] = tiles[:, :ATOMIC_ROWS].sum(0).permute(1, 0, 2)
        out[b] = torch.where((pos < n)[None], total + qr[..., 0] + extra, 0.0)
    return out, out2


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load_library("probe_op_cost")
    fn = lib.mmt_probe_op_cost
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def op_cost(variant: str, q, k, v, rel_table, geometry: fa.RelGeometry, lengths,
            kernel_table: Optional[torch.Tensor] = None, window: int = WINDOW,
            num_global: int = NUM_GLOBAL):
    """One variant by the probe kernel -> (out, out2) as ``op_cost_plain``.

    CUDA tensors only (bf16 q/k/v [B, S, H, 64], S a multiple of 64):
    anything else raises.  Counts its launches per variant in
    ``op_cost.launches[variant]``.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    common.require_cuda(q=q, k=k, v=v, rel_table=rel_table, lengths=lengths)
    batch, seq_len, num_heads, head_dim = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the probe kernels take bf16 q/k/v")
    if head_dim != 64 or seq_len % TILE or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("the op-cost probe takes q/k/v [B, S, H, 64] with S a multiple of "
                         f"64, got {tuple(q.shape)}")
    vocab = rel_table.shape[0]
    if (vocab > fa.MAX_KERNEL_VOCAB or rel_table.shape[1:] != (num_heads, head_dim)
            or 2 * geometry.text_max_distance >= vocab):
        raise ValueError(f"rel_table must be [2 D < V <= 64, {num_heads}, 64], "
                         f"got {tuple(rel_table.shape)}")
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be [{batch}], got {tuple(lengths.shape)}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    rel = fa.kernel_rel_table(rel_table) if kernel_table is None else kernel_table
    lengths32 = lengths.to(torch.int32).contiguous()
    out = torch.empty(batch, num_heads, seq_len, dtype=torch.float32, device=q.device)
    out2 = None
    if variant == "atomics":
        out2 = torch.zeros(batch, num_heads, fa.MAX_KERNEL_VOCAB, head_dim, dtype=torch.float32,
                           device=q.device)
    lib = _library()
    err = lib.mmt_probe_op_cost(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), lengths32.data_ptr(),
        out.data_ptr(), out2.data_ptr() if out2 is not None else None,
        VARIANTS.index(variant), batch, seq_len, num_heads, head_dim, vocab,
        geometry.image_len, geometry.num_patch_per_row, geometry.num_core_layers,
        geometry.text_max_distance, geometry.image_part_id, geometry.text_part_id,
        window, num_global, 1.0 / math.sqrt(head_dim),
        fa.dropout_threshold(DROPOUT_RATE), fa.dropout_scale(DROPOUT_RATE), DROPOUT_SEED,
        torch.cuda.current_stream(q.device).cuda_stream)
    common.raise_on_error(lib, err, f"probe_op_cost[{variant}]")
    op_cost.launches[variant] += 1
    return out, out2


op_cost.launches = {name: 0 for name in VARIANTS}


def relative_error(name: str, got, want, bound: float = REL_BOUND) -> float:
    """Max abs error of one variant's (out, out2) against its plain
    version's, relative to the plain result's largest magnitude.  Raises
    on a non-finite result and above ``bound``."""
    worst = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite result")
        worst = max(worst, ((g - w).abs().max() / w.abs().max()).item())
    if not worst <= bound:
        raise AssertionError(f"op-cost variant {name} disagrees with its plain version: "
                             f"{worst} > {bound}")
    return worst


def check(variants: Sequence[str] = VARIANTS, seed: int = 11,
          geometry: fa.RelGeometry = common.FLAGSHIP, **shape) -> dict:
    """Max abs error of each variant against its plain version, relative
    to the plain result's largest magnitude (default shape: B=1, H=2,
    S=512, length 431, window 96 with 70 global).  Raises above ``REL_BOUND``."""
    shape = {**CHECK_SHAPE, **shape}
    q, k, v, table, lens = common.attention_inputs(shape["lengths"], seed, shape["seq_len"],
                                                   shape["heads"])
    errors = {}
    for name in variants:
        pattern = dict(window=CHECK_WINDOW, num_global=CHECK_NUM_GLOBAL)
        got = op_cost(name, q, k, v, table, geometry, lens, **pattern)
        torch.cuda.synchronize()
        want = op_cost_plain(name, q, k, v, table, geometry, lens, **pattern)
        errors[name] = relative_error(name, got, want)
    return errors


def measure(variants: Sequence[str] = VARIANTS, lengths: Optional[Sequence[int]] = None,
            seed: int = 3, iters: int = 5, seq_len: int = common.SEQ_LEN,
            geometry: fa.RelGeometry = common.FLAGSHIP) -> dict:
    """ms per call of each variant at the retrieval shape; the baseline is
    timed first and last and its mean taken."""
    lengths = common.retrieval_lengths(seq_len=seq_len) if lengths is None else list(lengths)
    q, k, v, table, lens = common.attention_inputs(lengths, seed, seq_len)
    rel = fa.kernel_rel_table(table)
    order = [*variants, "base"] if variants and variants[0] == "base" else list(variants)
    times = {}
    for name in order:
        ms = common.cuda_ms(lambda: op_cost(name, q, k, v, table, geometry, lens, rel), iters)
        times.setdefault(name, []).append(ms)
    return {name: float(np.mean(ms)) for name, ms in times.items()}


def deltas(times: dict) -> dict:
    """Each variant's ms minus the baseline's; ``gather_own`` and
    ``reduce_own`` are the parts ``gather`` and ``reduce`` add to the
    variant they contain."""
    base = times.get("base")
    if base is None:
        return {}
    out = {name: ms - base for name, ms in times.items() if name != "base"}
    if "gather" in times and "ids" in times:
        out["gather_own"] = times["gather"] - times["ids"]
    if "reduce" in times and "exp" in times:
        out["reduce_own"] = times["reduce"] - times["exp"]
    return out


def run(variants: Sequence[str] = VARIANTS, batch: int = common.BATCH,
        seq_len: int = common.SEQ_LEN, iters: int = 5, device="cuda") -> dict:
    """The probe's entry point: checks, then times.  Runs on the card."""
    from mmt_tpu_torch.device import resolve_device

    if resolve_device(device).type != "cuda":
        raise ValueError("the probe kernels have no CPU version: run on the card")
    card = common.card_line()
    print(card, flush=True)
    errors = check(variants)
    times = measure(variants, common.retrieval_lengths(batch=batch, seq_len=seq_len),
                    iters=iters, seq_len=seq_len)
    delta = deltas(times)
    for name, ms in times.items():
        extra = f"  ({delta[name]:+7.2f})" if name in delta else ""
        print(f"{name:15s}: {ms:7.2f} ms{extra}   rel err {errors[name]:.1e}", flush=True)
    for name in ("gather_own", "reduce_own"):
        if name in delta:
            print(f"{name:15s}:            ({delta[name]:+7.2f})", flush=True)
    return {"card": card, "rel_errors": errors, "rel_bound": REL_BOUND, "ms": times,
            "delta_ms": delta, "shape": [batch, seq_len, common.HEADS, common.HEAD_DIM]}


if __name__ == "__main__":
    print(json.dumps(run(tuple(sys.argv[1:]) or VARIANTS)))
