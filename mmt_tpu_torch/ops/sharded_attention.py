"""Sequence-sharded relative attention over ``torch.distributed``.

Counterpart of ``mmt_tpu/ops/pallas_attention.py:3246-3506``
(``sequence_sharded_pallas_attention`` and
``ring_sequence_sharded_pallas_attention``).  A sequence group of n ranks
holds a batch's [B, S, H, D] q, k and v as n contiguous chunks of S / n
rows (rank r: rows ``[r S / n, (r + 1) S / n)``); ``lengths`` are the
examples' global lengths.  Both schedules run the fused kernels in their
offset mode (``ops/fused_attention.py``), so ids, masks and the dropout
hash see global positions, and with ``batch_start``, the global index of
the rank's first example, a data-parallel shard drops exactly the pairs
the single call drops.

* ``sequence_sharded_relative_attention``: one all-gather of K and V
  (``all_gather_into_tensor``), then the kernel on the rank's S / n rows
  against all S keys (``q_start = r S / n``).  Backward: the kernel's dk
  and dv of all S keys are reduce-scattered over the sequence group.
* ``ring_sequence_sharded_relative_attention``: n steps; at step i the rank
  holds the chunk of rank (r - i) mod n, runs the kernel on S / n x S / n
  with ``(q_start, k_start)``, combines the step into its output through
  the logsumexps (``ring_combine``) and passes the chunk to rank r + 1
  (``batch_isend_irecv``).  Backward, one ``autograd.Function``: each step
  runs the backward kernel against the global lse and delta = sum(do * o);
  dq accumulates here, and the chunk's dk / dv accumulators travel with it
  and are home after n passes.

Both give the relative table's gradient summed over the sequence group and
over ``data_group`` (JAX's ``shard_map`` transpose sums a replicated
input's cotangent over every mesh axis); a caller that all-reduces
gradients itself must not pass ``data_group``.

Each schedule is split in two.  The per-shard local functions take the
shard's q, its K / V chunks and its offsets and hold no collective:
``all_gather_local_forward`` / ``all_gather_local_backward``, and
``ring_local_forward`` / ``ring_local_backward``, which take the chunks
from a ``RingChunks``.  The wrappers put the collectives around them;
``all_gather_shards`` and ``ring_shards`` drive the same local functions
for every rank in one process (``OneProcessRing`` plays the ring), as the
card's one-device check and the CPU tests do.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from mmt_tpu_torch.ops.fused_attention import (
    RelGeometry,
    relative_attention_backward,
    relative_attention_forward,
)

# The logsumexp combine's clamp (pallas_attention.py:3393-3396): a row that
# is -inf in every chunk weighs its parts exp(-inf + 3e38) = 0, not NaN.
LSE_FLOOR = -3e38


def ring_combine(out: torch.Tensor, lse: torch.Tensor, out_i: torch.Tensor,
                 lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash combine of two partial attentions over disjoint keys:
    (out [B, S, H, D], lse [B, H, S]) and (out_i, lse_i) -> their union,
    the output in ``out``'s dtype (JAX rounds it to q's dtype each step)."""
    lse_new = torch.logaddexp(lse, lse_i)
    lse_c = lse_new.clamp(min=LSE_FLOOR)
    w = torch.exp(lse - lse_c).transpose(1, 2)[..., None]
    w_i = torch.exp(lse_i - lse_c).transpose(1, 2)[..., None]
    return (w * out.float() + w_i * out_i.float()).to(out.dtype), lse_new


def ring_chunk(rank: int, step: int, n: int) -> int:
    """The chunk a rank holds at ``step`` (after ``step`` passes)."""
    return (rank - step) % n


def _delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshd,bshd->bhs", do.float(), out.float()).contiguous()


# ------------------------------------------------------- local functions


def all_gather_local_forward(q, k_full, v_full, rel_table, geometry, lengths, q_start: int,
                             batch_start: int = 0, dropout_rate: float = 0.0,
                             dropout_seed=None, device: str = "cuda"):
    """One all-gather shard's forward: its q (rows from ``q_start``)
    against every key -> (o, lse)."""
    return relative_attention_forward(q, k_full, v_full, rel_table, geometry, lengths, device,
                                      dropout_rate, dropout_seed, None, q_start, 0, batch_start)


def all_gather_local_backward(q, k_full, v_full, do, out, lse, rel_table, geometry, lengths,
                              q_start: int, batch_start: int = 0, dropout_rate: float = 0.0,
                              dropout_seed=None, device: str = "cuda"):
    """One all-gather shard's backward -> (dq, dk and dv of every key,
    dRel): the terms of this shard's rows, to be summed over shards."""
    return relative_attention_backward(q, k_full, v_full, do.to(q.dtype), lse, _delta(do, out),
                                       rel_table, geometry, lengths, device, dropout_rate,
                                       dropout_seed, None, q_start, 0, batch_start)


class RingChunks:
    """Where a ring rank's K / V chunks come from and where their dk / dv
    accumulators go.  ``chunks()`` yields (k_start, k, v) for each of the n
    steps; ``add(dk, dv)`` adds the current step's chunk terms (float32)."""

    def chunks(self) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        raise NotImplementedError

    def add(self, dk: torch.Tensor, dv: torch.Tensor) -> None:
        raise NotImplementedError


def ring_local_forward(q, ring: RingChunks, rel_table, geometry, lengths, q_start: int,
                       batch_start: int = 0, dropout_rate: float = 0.0, dropout_seed=None,
                       device: str = "cuda", parts: Optional[list] = None):
    """One ring rank's forward over the chunks of ``ring`` -> (out, lse),
    combined step by step (``ring_combine``); each step's (k_start, o, lse)
    is appended to ``parts`` when given."""
    batch, seq, heads, _ = q.shape
    out = torch.zeros_like(q)
    lse = torch.full((batch, heads, seq), -math.inf, device=q.device)
    for k_start, k_c, v_c in ring.chunks():
        o_i, lse_i = relative_attention_forward(q, k_c, v_c, rel_table, geometry, lengths, device,
                                                dropout_rate, dropout_seed, None, q_start,
                                                k_start, batch_start)
        if parts is not None:
            parts.append((k_start, o_i, lse_i))
        out, lse = ring_combine(out, lse, o_i, lse_i)
    return out, lse


def ring_local_backward(q, ring: RingChunks, do, out, lse, rel_table, geometry, lengths,
                        q_start: int, batch_start: int = 0, dropout_rate: float = 0.0,
                        dropout_seed=None, device: str = "cuda", parts: Optional[list] = None):
    """One ring rank's backward: per chunk, the backward kernel against the
    global ``lse`` and delta = sum(do * out) (``pallas_attention.py:
    3419-3470``) -> (dq, dRel) in float32; each chunk's dk / dv terms go to
    ``ring.add``, and each step's (k_start, dq, dk, dv, dRel) to ``parts``
    when given."""
    delta = _delta(do, out)
    do = do.to(q.dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    drel = None
    for k_start, k_c, v_c in ring.chunks():
        dq_i, dk_c, dv_c, drel_i = relative_attention_backward(
            q, k_c, v_c, do, lse, delta, rel_table, geometry, lengths, device, dropout_rate,
            dropout_seed, None, q_start, k_start, batch_start)
        if parts is not None:
            parts.append((k_start, dq_i, dk_c, dv_c, drel_i))
        dq += dq_i.float()
        if drel_i is not None:
            drel = drel_i.float() if drel is None else drel + drel_i.float()
        ring.add(dk_c.float(), dv_c.float())
    return dq, drel


# ------------------------------------------------ one process, every rank


def _split(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    if t.shape[1] % n:
        raise ValueError(f"seq {t.shape[1]} not divisible by {n} shards")
    return list(t.chunk(n, dim=1))


class OneProcessRing(RingChunks):
    """The ring as rank ``rank`` sees it, played in one process from every
    rank's chunks; the dk / dv terms are summed into ``dk`` / ``dv`` (lists
    of float32 chunks, shared by the ranks' rings)."""

    def __init__(self, rank: int, ks, vs, dk=None, dv=None):
        self.rank, self.ks, self.vs, self.dk, self.dv = rank, ks, vs, dk, dv
        self._chunk = None

    def chunks(self):
        n = len(self.ks)
        seq = self.ks[0].shape[1]
        for step in range(n):
            self._chunk = ring_chunk(self.rank, step, n)
            yield self._chunk * seq, self.ks[self._chunk], self.vs[self._chunk]

    def add(self, dk, dv):
        self.dk[self._chunk] += dk
        self.dv[self._chunk] += dv


def all_gather_shards(q, k, v, rel_table, geometry, lengths, n: int, batch_start: int = 0,
                      dropout_rate: float = 0.0, dropout_seed=None, device: str = "cuda"):
    """The all-gather schedule's forward for every rank of an n-rank group,
    in one process -> (o, lse) assembled over the sequence."""
    outs = [all_gather_local_forward(q_r, k, v, rel_table, geometry, lengths, r * q_r.shape[1],
                                     batch_start, dropout_rate, dropout_seed, device)
            for r, q_r in enumerate(_split(q, n))]
    return torch.cat([o for o, _ in outs], 1), torch.cat([lse for _, lse in outs], 2)


def ring_shards(q, k, v, rel_table, geometry, lengths, n: int, batch_start: int = 0,
                dropout_rate: float = 0.0, dropout_seed=None, device: str = "cuda", do=None):
    """The ring schedule for every rank of an n-rank group, in one process
    -> (o, lse) assembled over the sequence, and with ``do`` also (dq, dk,
    dv in q's dtype, dRel float32 or None)."""
    qs, ks, vs = _split(q, n), _split(k, n), _split(v, n)
    seq = qs[0].shape[1]
    outs = [ring_local_forward(q_r, OneProcessRing(r, ks, vs), rel_table, geometry, lengths,
                               r * seq, batch_start, dropout_rate, dropout_seed, device)
            for r, q_r in enumerate(qs)]
    o, lse = torch.cat([o for o, _ in outs], 1), torch.cat([lse for _, lse in outs], 2)
    if do is None:
        return o, lse
    dk = [torch.zeros(c.shape, dtype=torch.float32, device=c.device) for c in ks]
    dv = [torch.zeros(c.shape, dtype=torch.float32, device=c.device) for c in vs]
    dqs, drel = [], None
    for r, (q_r, do_r) in enumerate(zip(qs, _split(do, n))):
        dq_r, drel_r = ring_local_backward(
            q_r, OneProcessRing(r, ks, vs, dk, dv), do_r, outs[r][0], outs[r][1], rel_table,
            geometry, lengths, r * seq, batch_start, dropout_rate, dropout_seed, device)
        dqs.append(dq_r)
        if drel_r is not None:
            drel = drel_r if drel is None else drel + drel_r
    cast = lambda ts, like: torch.cat(ts, 1).to(like.dtype)  # noqa: E731
    return o, lse, (cast(dqs, q), cast(dk, k), cast(dv, v), drel)


# ------------------------------------------------------------ collectives


def _rank(group) -> Tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _all_gather_seq(t: torch.Tensor, group) -> torch.Tensor:
    """[B, s, H, D] chunks of the group -> [B, n s, H, D] in rank order."""
    _, n = _rank(group)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    out = out.view(n, *t.shape)
    return out.transpose(0, 1).reshape(t.shape[0], n * t.shape[1], *t.shape[2:])


def _reduce_scatter_seq(t: torch.Tensor, group) -> torch.Tensor:
    """[B, n s, H, D] per rank -> this rank's [B, s, H, D] chunk of the sum."""
    _, n = _rank(group)
    batch, seq = t.shape[:2]
    parts = t.reshape(batch, n, seq // n, *t.shape[2:]).transpose(0, 1).contiguous()
    out = torch.empty(parts.shape[1:], dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, parts.view(n * batch, *parts.shape[2:]), group=group)
    return out


def _sum_table_grad(drel, group, data_group):
    if drel is None:
        return None
    drel = drel.contiguous()
    dist.all_reduce(drel, group=group)
    if data_group is not None:
        dist.all_reduce(drel, group=data_group)
    return drel


class _AllGatherAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_table, lengths, geometry, dropout_rate, dropout_seed, device,
                group, data_group, batch_start):
        rank, _ = _rank(group)
        k_full, v_full = _all_gather_seq(k, group), _all_gather_seq(v, group)
        q_start = rank * q.shape[1]
        o, lse = all_gather_local_forward(q, k_full, v_full, rel_table, geometry, lengths,
                                          q_start, batch_start, dropout_rate, dropout_seed,
                                          device)
        ctx.save_for_backward(q, k_full, v_full, rel_table, lengths, o, lse)
        ctx.args = (geometry, dropout_rate, dropout_seed, device, group, data_group,
                    batch_start, q_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k_full, v_full, rel_table, lengths, o, lse = ctx.saved_tensors
        geometry, rate, seed, device, group, data_group, batch_start, q_start = ctx.args
        dq, dk, dv, drel = all_gather_local_backward(
            q, k_full, v_full, do, o, lse, rel_table, geometry, lengths, q_start, batch_start,
            rate, seed, device)
        dk, dv = _reduce_scatter_seq(dk, group), _reduce_scatter_seq(dv, group)
        drel = _sum_table_grad(drel, group, data_group) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, drel, *([None] * 8)


class DistributedRing(RingChunks):
    """The ring over a process group: after each step the chunk (and, in
    the backward, its dk / dv accumulators) goes to rank r + 1 and the
    chunk of rank r - 1 comes in, by ``batch_isend_irecv``."""

    def __init__(self, k, v, group, grads: bool = False):
        self.k, self.v, self.group = k, v, group
        self.rank, self.n = _rank(group)
        self.dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device) if grads else None
        self.dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device) if grads else None

    def _shift(self, *tensors):
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.n)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.n)
        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for tag, (t, o) in enumerate(zip(tensors, outs)):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, o, prv, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def chunks(self):
        k_c, v_c = self.k, self.v
        seq = k_c.shape[1]
        for step in range(self.n):
            yield ring_chunk(self.rank, step, self.n) * seq, k_c, v_c
            if self.dk is not None:  # the accumulators travel every step: home after n
                self.dk, self.dv = self._shift(self.dk, self.dv)
            if step + 1 < self.n:
                k_c, v_c = self._shift(k_c, v_c)

    def add(self, dk, dv):
        self.dk += dk
        self.dv += dv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_table, lengths, geometry, dropout_rate, dropout_seed, device,
                group, data_group, batch_start):
        rank, _ = _rank(group)
        q_start = rank * q.shape[1]
        out, lse = ring_local_forward(q, DistributedRing(k, v, group), rel_table, geometry,
                                      lengths, q_start, batch_start, dropout_rate, dropout_seed,
                                      device)
        ctx.save_for_backward(q, k, v, rel_table, lengths, out, lse)
        ctx.args = (geometry, dropout_rate, dropout_seed, device, group, data_group,
                    batch_start, q_start)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, rel_table, lengths, out, lse = ctx.saved_tensors
        geometry, rate, seed, device, group, data_group, batch_start, q_start = ctx.args
        ring = DistributedRing(k, v, group, grads=True)
        dq, drel = ring_local_backward(q, ring, do, out, lse, rel_table, geometry, lengths,
                                       q_start, batch_start, rate, seed, device)
        if drel is not None and ctx.needs_input_grad[3]:
            drel = _sum_table_grad(drel, group, data_group).to(rel_table.dtype)
        else:
            drel = None
        return (dq.to(q.dtype), ring.dk.to(k.dtype), ring.dv.to(v.dtype), drel,
                *([None] * 8))


def _sharded(fn, q, k, v, rel_table, geometry, lengths, group, data_group, batch_start,
             dropout_rate, dropout_seed, device):
    if rel_table is None or geometry is None:
        rel_table = geometry = None
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_seed is required when dropout_rate > 0")
    return fn.apply(q, k, v, rel_table, lengths, geometry, float(dropout_rate), dropout_seed,
                    device, group, data_group, batch_start)


def sequence_sharded_relative_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    group=None,
    data_group=None,
    batch_start: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    device: str = "cuda",
) -> torch.Tensor:
    """All-gather sequence-sharded fused attention, differentiable.

    Args:
      q, k, v: this rank's <bf16 (card) / float (CPU)>[B, S / n, H, D]
        chunk of the sequence group ``group`` (default: the world).
      rel_table, geometry, dropout_rate, dropout_seed, device: as in
        ``fused_attention.relative_attention``.
      lengths: <int>[B] global lengths of this rank's examples.
      data_group: the data-parallel group the table's gradient is also
        summed over (module docstring), or None.
      batch_start: the global index of this rank's first example.

    Returns:
      this rank's [B, S / n, H, D] rows of the attention output.
    """
    return _sharded(_AllGatherAttention, q, k, v, rel_table, geometry, lengths, group,
                    data_group, batch_start, dropout_rate, dropout_seed, device)


def ring_sequence_sharded_relative_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_table: Optional[torch.Tensor],
    geometry: Optional[RelGeometry],
    lengths: torch.Tensor,
    group=None,
    data_group=None,
    batch_start: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    device: str = "cuda",
) -> torch.Tensor:
    """Ring-schedule sequence-sharded fused attention, differentiable: one
    K / V chunk of S / n rows resident per step.  Arguments and result as
    in ``sequence_sharded_relative_attention``."""
    return _sharded(_RingAttention, q, k, v, rel_table, geometry, lengths, group, data_group,
                    batch_start, dropout_rate, dropout_seed, device)
