"""Round-robin budget trimming across multiple text fields.

The port's own copy of ``mmt_tpu/text/trimmer.py``.

Re-provides ``tensorflow_text.RoundRobinTrimmer`` capability (call site
``src/data/data_utils.py:121, 259``): the budget is allocated one
*wordpiece* (ragged leaf element) at a time, round-robin across fields
-- field 0 gets the first unit of every round, so earlier fields win
the final partial round -- until ``max_seq_length`` total wordpieces
are kept or every field is exhausted.  Each field then keeps its first
``budget_i`` wordpieces, which can split a word mid-way (the trimmer
operates on the innermost ragged axis, not on word boundaries).

These semantics (element-level allocation + left-to-right tie-break +
mid-word splits) are pinned by goldens in ``tests/test_text.py``.
"""

from __future__ import annotations

from typing import List, Sequence


def _round_robin_budgets(lengths: Sequence[int], total: int) -> List[int]:
    """Unit-per-round water filling with left-to-right partial rounds.

    Closed form (O(F log maxN), not O(total) -- this runs per example in
    the host input hot path): r = the largest number of whole rounds
    with sum(min(n_i, r)) <= total, then the partial round hands one
    unit each to still-active fields left to right.
    """
    if not lengths:
        return []
    lo, hi = 0, max(lengths)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if sum(min(n, mid) for n in lengths) <= total:
            lo = mid
        else:
            hi = mid - 1
    budgets = [min(n, lo) for n in lengths]
    remaining = total - sum(budgets)
    for i, n in enumerate(lengths):
        if remaining <= 0:
            break
        if n > lo:
            budgets[i] += 1
            remaining -= 1
    return budgets


def round_robin_trim(
    fields: Sequence[List[List[int]]], max_total_wordpieces: int
) -> List[List[List[int]]]:
    """Trims word-aligned fields to a shared wordpiece budget.

    Args:
      fields: per-field lists of words, each word a list of wordpiece ids.
      max_total_wordpieces: total budget across all fields.

    Returns:
      New word-aligned lists: each field keeps its first ``budget_i``
      wordpieces; a word at the cut keeps only its leading pieces.
    """
    lengths = [sum(len(w) for w in field) for field in fields]
    budgets = _round_robin_budgets(lengths, max_total_wordpieces)

    out: List[List[List[int]]] = []
    for field, budget in zip(fields, budgets):
        kept: List[List[int]] = []
        for word in field:
            if budget <= 0:
                break
            if len(word) <= budget:
                kept.append(word)
                budget -= len(word)
            else:
                kept.append(word[:budget])
                budget = 0
        out.append(kept)
    return out
