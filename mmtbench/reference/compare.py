"""The numbers that decide ``correct``, each against its limit.

Training (the program's first steps against the reference's):

* ``loss_gap``: the largest |L - L_ref| / |L_ref| over the checked steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, the program's worked out from its optimizer's first moment
  after one step (mu / (1 - b1)), against max(the reference leaf's norm,
  the median leaf's norm);
* ``grad_gap_median``: the median leaf's gap of the first gradient, a
  number steady from seed to seed (the worst leaf is often a head's bias,
  whose gradient is a sum over the batch that nearly cancels);
* ``change_gap``: the same for the norm of each leaf's change over the
  checked steps.  Leaves whose reference gradient lies under a thousandth
  of the median leaf's (a key bias under softmax, a head the batch leaves
  unused) move under Adam by rounding alone and are left out.

Scoring: ``score_gap``, the widest |p - p_ref| over every ITM probability
that the window returned.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

NOUGHT_SHARE = 1e-3


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's |got - want| / max(want, the median leaf's want)."""
    leaves = list(leaves)
    missing = sorted(set(leaves) - set(got))
    if missing:
        raise ValueError(f"the program has no reading for leaves {missing[:5]}")
    median = float(np.median([want[n] for n in leaves]))
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in leaves}


def moved_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median = float(np.median(list(grad_norms.values())))
    return [n for n, v in grad_norms.items() if v >= NOUGHT_SHARE * median]


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference``: {"losses": [...], "grad_norms":
    {leaf: norm}, "change_norms": {leaf: norm}}."""
    if len(program["losses"]) != len(reference["losses"]):
        raise ValueError("the program and the reference ran different numbers of steps")
    losses = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])]
    grads = leaf_gaps(program["grad_norms"], reference["grad_norms"], reference["grad_norms"])
    moved = moved_leaves(reference["grad_norms"])
    changes = leaf_gaps(program["change_norms"], reference["change_norms"], moved)
    return {
        "loss_gap": max(losses),
        "grad_gap": max(grads.values()),
        "grad_gap_median": float(np.median(list(grads.values()))),
        "change_gap": max(changes.values()),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number that is not finite fails."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"no reading for the limits {missing}")
    return {name: {"value": float(numbers[name]), "limit": float(limits[name]),
                   "ok": bool(np.isfinite(numbers[name]) and numbers[name] <= limits[name])}
            for name in limits}
