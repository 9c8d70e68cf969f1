"""The backward attention kernel's share of its roofline (as
``attn_fwd_roofline``, for ``rel_attention_bwd_kernel``), in %.

Operations: q.k^T, do.v^T, ds.k, p^T.do and ds^T.q per real pair, q.R^T,
dsv.R and dsv^T.q per real row.  Bytes: each input read once (the real rows
of q, k, v, do, lse and delta, the table, the lengths), each output written
once (every row of dq, dk and dv in bf16, dRel summed)."""

from mmtbench.metrics.attn_fwd_roofline import share

KERNEL = "rel_attention_bwd_kernel"


def backward_work(lengths, seq_len, heads, head_dim, rel_vocab):
    L = [float(x) for x in lengths]
    pairs, rows = sum(x * x for x in L), sum(L)
    flops = 10 * pairs * head_dim * heads + 6 * rows * rel_vocab * head_dim * heads
    row = heads * head_dim * 2
    reads = 4 * rows * row + 2 * rows * heads * 4 + heads * 64 * head_dim * 2 + len(L) * 4
    return flops, reads + 3 * len(L) * seq_len * row + rel_vocab * heads * head_dim * 4


def read(trace, shape):
    if not trace.work.get("training"):
        return None
    return share(trace, KERNEL, backward_work, shape)
