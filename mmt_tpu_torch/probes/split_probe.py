"""The far / structured split schedule of the forward, as two probe passes.

Counterpart of ``scripts/split_probe.py``, which launches the TPU list
kernel (``pallas_attention.py:_fwd_list_kernel``) once over the far list
and once over the structured list of ``_split_tile_lists`` and times each.
The port's production forward computes the split's function in one pass
and does not specialise far tiles; this probe says what the specialisation
is worth on the card:

* ``tile_classes`` classifies the kernels' 64 x 64 tiles by the rule of
  ``_build_tile_meta``: a tile is *far* when it lies in the text x text
  part and every offset ``j - i`` in it is beyond the text distance on one
  side, so that its bias is rank-1 (``qr[i, D]`` right, ``qr[i, 2D]``
  left); everything else is *structured*.
* ``split_pass`` launches ``csrc/probe_split.cu`` over one class: the far
  pass adds the rank-1 bias with no per-element id and no gather, the
  structured pass runs the production per-element path.  Each returns
  float32 partials (o normalised by the pass's own row sum, lse).
* ``combine`` merges the two passes by logsumexp with the -3e38 clamp of
  ``_forward_split``.
* ``split_pass_plain`` is the plain PyTorch version of one pass.

Run on the card::

    python -m mmt_tpu_torch.probes.split_probe

It checks the combined (o, lse) against the one-pass kernel and the plain
attention on real rows at the lengths [4096, 3001, 1000, 257] (o 2e-2, lse
1e-3), then prints the far pass's, the structured pass's and the one-pass
kernel's times at the retrieval shape (B=32, S=4096, H=12, D=64, lengths ~
U[2048, 4096]) and the share of live tiles that are far.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmt_tpu_torch.features.attention_mask import make_att_mask_from_length
from mmt_tpu_torch.ops import build
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.ops.relative_attention_ref import relative_attention_scores
from mmt_tpu_torch.probes import common
from mmt_tpu_torch.probes.common import TILE

STRUCTURED, FAR_RIGHT, FAR_LEFT = 0, 1, 2
CHECK_LENGTHS = [4096, 3001, 1000, 257]
O_BOUND, LSE_BOUND = 2e-2, 1e-3


def tile_classes(geometry: fa.RelGeometry, seq_len: int, tile: int = TILE) -> np.ndarray:
    """<int8>[nq, nk]: STRUCTURED, FAR_RIGHT (every pair's id is D) or
    FAR_LEFT (2D) for each tile of ``ceil(S / tile)**2``."""
    n = -(-seq_len // tile)
    start = np.arange(n) * tile
    q0, k0 = start[:, None], start[None, :]
    text = (q0 >= geometry.image_len) & (k0 >= geometry.image_len)
    d = geometry.text_max_distance
    right = text & (k0 - (q0 + tile - 1) > d)
    left = text & (k0 + tile - 1 - q0 < -d)
    return np.where(right, FAR_RIGHT, np.where(left, FAR_LEFT, STRUCTURED)).astype(np.int8)


def split_tile_lists(classes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(far, structured) tile lists, <int32>[n, 3] rows (qi, ki, flag)
    sorted by qi then ki; flag is 0 (right clip) or 1 (left clip) for far
    tiles and 0 for structured ones."""
    far, struct = [], []
    for qi, ki in np.ndindex(*classes.shape):
        c = classes[qi, ki]
        (far if c else struct).append((qi, ki, int(c == FAR_LEFT)))
    as_array = lambda rows: np.asarray(rows, np.int32).reshape(-1, 3)  # noqa: E731
    return as_array(far), as_array(struct)


def far_tile_share(geometry: fa.RelGeometry, lengths: Sequence[int], seq_len: int) -> float:
    """Share of the live tiles (q0 < L and k0 < L) that are far."""
    classes = tile_classes(geometry, seq_len)
    far = live = 0
    for length in lengths:
        n = -(-min(int(length), seq_len) // TILE)
        live += n * n
        far += int((classes[:n, :n] != STRUCTURED).sum())
    return far / live


def split_pass_plain(q, k, v, rel_table, geometry: fa.RelGeometry, lengths,
                     far: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass in plain PyTorch -> (o fp32 [B,S,H,D], lse fp32 [B,H,S]).

    The masked logits of the plain attention, restricted per example to
    the key tiles of the class with ``k0 < L_b``; a row with none gets
    o = 0, lse = -inf.  p is rounded to q.dtype before p . v, as in the
    kernel; o is normalised by the pass's own row sum.
    """
    batch, seq_len = q.shape[:2]
    ids = torch.from_numpy(fa.relative_att_ids(geometry, seq_len)).to(q.device)
    is_far = torch.from_numpy(tile_classes(geometry, seq_len) != STRUCTURED).to(q.device)
    in_class = (is_far == far).repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    in_class = in_class[:seq_len, :seq_len]
    pos = torch.arange(seq_len, device=q.device)
    outs, lses = [], []
    for b in range(batch):  # per example, to bound the [H, S, S] temporaries
        sl = slice(b, b + 1)
        logits = relative_attention_scores(q[sl], k[sl], rel_table, ids)
        mask = make_att_mask_from_length(seq_len, lengths[sl])
        logits = logits + (1.0 - mask[:, None].float()) * fa.NEG_INF
        live_keys = pos < -(-int(lengths[b]) // TILE) * TILE
        logits = logits.masked_fill(~(in_class & live_keys[None, :]), -math.inf)
        lse = torch.logsumexp(logits, dim=-1)
        empty = torch.isinf(lse)
        probs = torch.exp(logits - torch.where(empty, 0.0, lse)[..., None]).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs.float(), v[sl].float()))
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load_library("probe_split")
    fn = lib.mmt_probe_split_pass
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def split_pass(q, k, v, rel_table, geometry: fa.RelGeometry, lengths, far: bool,
               kernel_table: Optional[torch.Tensor] = None):
    """One pass by the probe kernel -> (o fp32 [B,S,H,D], lse fp32 [B,H,S]).

    CUDA tensors only (bf16 q/k/v, head_dim 64, relative vocab <= 64):
    anything else raises.  Counts its launches in ``split_pass.launches_far``
    / ``.launches_structured``.
    """
    common.require_cuda(q=q, k=k, v=v, rel_table=rel_table, lengths=lengths)
    batch, seq_len, num_heads, head_dim = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the probe kernels take bf16 q/k/v")
    if head_dim != 64 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"the split probe takes q/k/v [B, S, H, 64], got {tuple(q.shape)}")
    if rel_table.shape[0] > fa.MAX_KERNEL_VOCAB or rel_table.shape[1:] != (num_heads, head_dim):
        raise ValueError(f"rel_table must be [V <= 64, {num_heads}, 64], "
                         f"got {tuple(rel_table.shape)}")
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be [{batch}], got {tuple(lengths.shape)}")
    if geometry.window:
        raise ValueError("the split schedule is the dense path's: window must be 0")
    q, k, v = (t.contiguous() for t in (q, k, v))
    rel = fa.kernel_rel_table(rel_table) if kernel_table is None else kernel_table
    lengths32 = lengths.to(torch.int32).contiguous()
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(batch, num_heads, seq_len, dtype=torch.float32, device=q.device)
    lib = _library()
    err = lib.mmt_probe_split_pass(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), lengths32.data_ptr(),
        o.data_ptr(), lse.data_ptr(), batch, seq_len, num_heads, head_dim, rel_table.shape[0],
        geometry.image_len, geometry.num_patch_per_row, geometry.num_core_layers,
        geometry.text_max_distance, geometry.image_part_id, geometry.text_part_id,
        1.0 / math.sqrt(head_dim), int(far), torch.cuda.current_stream(q.device).cuda_stream)
    common.raise_on_error(lib, err, "probe_split")
    if far:
        split_pass.launches_far += 1
    else:
        split_pass.launches_structured += 1
    return o, lse


split_pass.launches_far = 0
split_pass.launches_structured = 0


def combine(o_far, lse_far, o_struct, lse_struct, dtype=torch.bfloat16):
    """The logsumexp combine of ``_forward_split``: a row with no live tile
    in either pass has lse = -inf twice; the clamp keeps its weights 0
    instead of NaN."""
    lse = torch.logaddexp(lse_far, lse_struct)
    lse_c = torch.clamp(lse, min=-3e38)
    w_far = torch.exp(lse_far - lse_c).transpose(1, 2)[..., None]  # [B, S, H, 1]
    w_struct = torch.exp(lse_struct - lse_c).transpose(1, 2)[..., None]
    return (o_far * w_far + o_struct * w_struct).to(dtype), lse


def split_forward(q, k, v, rel_table, geometry, lengths):
    """Far pass + structured pass + combine on the card -> (o, lse)."""
    rel = fa.kernel_rel_table(rel_table)
    far = split_pass(q, k, v, rel_table, geometry, lengths, True, rel)
    struct = split_pass(q, k, v, rel_table, geometry, lengths, False, rel)
    return combine(*far, *struct, dtype=q.dtype)


def _real_row_errors(got, want, lengths):
    (o, lse), (o_ref, lse_ref) = got, want
    err_o = err_lse = 0.0
    for b, n in enumerate(lengths):
        if not torch.isfinite(o[b, :n]).all():
            raise AssertionError(f"non-finite split output in example {b}")
        err_o = max(err_o, (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item())
        err_lse = max(err_lse, (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item())
    return err_o, err_lse


def check(lengths: Sequence[int] = CHECK_LENGTHS, seed: int = 1, seq_len: int = common.SEQ_LEN,
          geometry: fa.RelGeometry = common.FLAGSHIP, heads: int = common.HEADS) -> dict:
    """Max abs errors on real rows: each pass against its plain version,
    the combined result against the one-pass kernel and against the plain
    attention.  Raises when the combined result exceeds its bounds."""
    q, k, v, table, lens = common.attention_inputs(lengths, seed, seq_len, heads)
    args = (q, k, v, table, geometry, lens)
    passes = {}
    for far in (True, False):
        passes[far] = split_pass(*args, far)
    torch.cuda.synchronize()
    out = {}
    for far, name in ((True, "far"), (False, "structured")):
        o_ref, lse_ref = split_pass_plain(*args, far)
        o, lse = passes[far]
        finite = torch.isfinite(lse_ref)
        for b, n in enumerate(lengths):  # rows without a tile of the class: -inf in both
            if not torch.equal(torch.isfinite(lse[b, :, :n]), finite[b, :, :n]):
                raise AssertionError(f"{name} pass: rows without a tile differ from plain")
        zero = torch.zeros((), device=q.device)
        err_o, err_lse = _real_row_errors(
            (o, torch.where(finite, lse, zero)), (o_ref, torch.where(finite, lse_ref, zero)),
            lengths)
        out[f"{name}_vs_plain"] = {"o": err_o, "lse": err_lse}
        del o_ref, lse_ref
    combined = combine(*passes[True], *passes[False], dtype=q.dtype)
    one_pass = fa.relative_attention_forward(*args)
    plain = fa.relative_attention_plain(*args)
    for name, ref in (("one_pass", one_pass), ("plain", plain)):
        err_o, err_lse = _real_row_errors(combined, ref, lengths)
        out[f"combined_vs_{name}"] = {"o": err_o, "lse": err_lse}
        if not (err_o <= O_BOUND and err_lse <= LSE_BOUND):
            raise AssertionError(f"split forward disagrees with {name}: o {err_o} lse {err_lse}")
    for name, errs in out.items():
        if not (errs["o"] <= O_BOUND and errs["lse"] <= LSE_BOUND):
            raise AssertionError(f"{name}: {errs}")
    out["o_bound"], out["lse_bound"] = O_BOUND, LSE_BOUND
    return out


def measure(lengths: Optional[Sequence[int]] = None, seed: int = 3, iters: int = 10,
            seq_len: int = common.SEQ_LEN,
            geometry: fa.RelGeometry = common.FLAGSHIP) -> dict:
    """Times of the two passes and the one-pass kernel at the retrieval
    shape, in turns, and the share of live tiles that are far."""
    lengths = common.retrieval_lengths(seq_len=seq_len) if lengths is None else list(lengths)
    q, k, v, table, lens = common.attention_inputs(lengths, seed, seq_len)
    rel = fa.kernel_rel_table(table)
    calls = {
        "far_ms": lambda: split_pass(q, k, v, table, geometry, lens, True, rel),
        "structured_ms": lambda: split_pass(q, k, v, table, geometry, lens, False, rel),
        "one_pass_ms": lambda: fa.relative_attention_forward(
            q, k, v, table, geometry, lens, kernel_table=rel),
    }
    times = {name: [] for name in calls}
    order = list(calls)
    for names in (order, order[::-1]):  # in turns
        for name in names:
            times[name].append(common.cuda_ms(calls[name], iters))
    out = {name: float(np.mean(ms)) for name, ms in times.items()}
    passes = [split_pass(q, k, v, table, geometry, lens, far, rel) for far in (True, False)]
    out["combine_ms"] = common.cuda_ms(lambda: combine(*passes[0], *passes[1], dtype=q.dtype),
                                       iters)
    out["sum_ms"] = out["far_ms"] + out["structured_ms"]
    out["far_tile_share"] = far_tile_share(geometry, lengths, seq_len)
    out["shape"] = [len(lengths), seq_len, q.shape[2], q.shape[3]]
    return out


def run(batch: int = common.BATCH, seq_len: int = common.SEQ_LEN, iters: int = 10,
        device="cuda") -> dict:
    """The probe's entry point: checks, then times.  Runs on the card."""
    from mmt_tpu_torch.device import resolve_device

    if resolve_device(device).type != "cuda":
        raise ValueError("the probe kernels have no CPU version: run on the card")
    card = common.card_line()
    print(card, flush=True)
    checks = check([min(n, seq_len) for n in CHECK_LENGTHS], seq_len=seq_len)
    for name, errs in checks.items():
        if isinstance(errs, dict):
            print(f"check {name:24s}: o {errs['o']:.3e}  lse {errs['lse']:.3e}", flush=True)
    times = measure(common.retrieval_lengths(batch=batch, seq_len=seq_len), iters=iters,
                    seq_len=seq_len)
    print(f"far tiles     : {times['far_tile_share']:.3f} of the live tiles")
    for name in ("far_ms", "structured_ms", "sum_ms", "combine_ms", "one_pass_ms"):
        print(f"{name[:-3]:14s}: {times[name]:8.3f} ms/call")
    return {"card": card, "checks": checks, "times": times}


if __name__ == "__main__":
    print(json.dumps(run()))
