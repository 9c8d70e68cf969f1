"""The forward attention kernel's share of its roofline: the least time
the card could take for the traced calls (the larger of their operations
over the bf16 peak and their bytes over the HBM bandwidth) over the
device time of ``rel_attention_fwd_kernel``, in %.

Operations: q.k^T and p.v over every real query-key pair (sum of L**2 per
example) and q.R^T per real row.  Bytes: the real rows of q, k and v read
once, every row of o and lse written once, the table and the lengths read.
Where the profiler dropped some records, the mean bound of a call stands
for each recorded call."""

from mmtbench.peaks import bound_ms

KERNEL = "rel_attention_fwd_kernel"


def forward_work(lengths, seq_len, heads, head_dim, rel_vocab):
    L = [float(x) for x in lengths]
    pairs, rows = sum(x * x for x in L), sum(L)
    flops = 4 * pairs * head_dim * heads + 2 * rows * rel_vocab * head_dim * heads
    row_bytes = heads * head_dim * 2
    nbytes = (3 * rows * row_bytes + len(L) * seq_len * row_bytes + len(L) * heads * seq_len * 4
              + rel_vocab * heads * head_dim * 4 + len(L) * 4)
    return flops, nbytes


def share(trace, kernel, work_fn, shape):
    ms, records = trace.kernel_ms(lambda n: kernel in n)
    calls = trace.work.get("attention_calls", [])
    if not records or not calls:
        return None
    bounds = [bound_ms(*work_fn(lengths, shape["seq_len"], shape["heads"], shape["head_dim"],
                                shape["rel_vocab"])) for lengths in calls]
    mean = sum(b for b, _ in bounds) / len(bounds)
    ops = sum(b for b, by in bounds if by == "operations")
    by = "operations" if ops >= sum(b for b, _ in bounds) / 2 else "bytes"
    return {"value": 100.0 * mean * records / ms, "bound_by": by, "records": records,
            "calls": len(calls)}


def read(trace, shape):
    return share(trace, KERNEL, forward_work, shape)
