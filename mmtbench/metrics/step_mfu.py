"""The whole step's share of the card's bf16 peak: the model's operations
at real lengths over the wall time of the run's measured window (untraced:
the profiler slows a host that issues many small operations, and with it
the pretraining step, by ~13%), in %.

Per example of L real positions, forward: per layer the q, k, v and output
projections (8 L H^2), the FFN (4 L H I), q.k^T and p.v (4 L^2 H) and the
relative-bias contraction q.R^T (2 L V H); the patch projection
(2 N patch_dim H); the ITM head (2 H H + 4 H); the MLM head at each masked
position (2 H H + 2 H vocab).  Training counts the forward three times.
Nothing recomputed is counted (remat is off), nor work on padding."""

from mmtbench.peaks import BF16_FLOPS


def example_flops(length, shape):
    H, I, L = shape["hidden"], shape["intermediate"], float(length)
    layer = 8 * L * H * H + 4 * L * H * I + 4 * L * L * H + 2 * L * shape["rel_vocab"] * H
    return (shape["layers"] * layer + 2 * shape["patches"] * shape["patch_dim"] * H
            + 2 * H * H + 4 * H)


def model_flops(work, shape):
    flops = sum(example_flops(x, shape) for x in work["examples"])
    flops += work.get("mlm_targets", 0) * (2 * shape["hidden"] ** 2
                                           + 2 * shape["hidden"] * shape["vocab"])
    return 3 * flops if work.get("training") else flops


def read(trace, shape):
    window = getattr(trace, "window", None)
    if not window or not window["work"].get("examples"):
        return None
    return {"value": 100.0 * model_flops(window["work"], shape) / window["seconds"] / BF16_FLOPS}
