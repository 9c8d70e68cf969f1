"""The readings that a cell's limits are set from, at the cell's own size:

    python3 mmtbench/readings.py --workload <cell> --seeds 1,2,3 [--control 3] [--faults 3]

For each seed, in one process: the sound program's numbers against the
reference (the lower readings), then for the first ``--control`` seeds the
control's (the reference in fp8 put in the program's place) and for the
first ``--faults`` seeds each planted fault's (training: the half batch;
scoring: an altered answer, half the answers).  One JSON line a seed; not
part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtbench import faults, harness  # noqa: E402
from mmtbench.drivers.predict import score_gaps  # noqa: E402
from mmtbench.reference import compare  # noqa: E402


def session_for(bench, cell, seed, device, overrides=None):
    mix = {**harness.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    exp = harness.experiment(harness.config_file(bench, cell["config"]),
                             (overrides or {}).get("config"))
    s = harness.driver(mix["driver"]).Session(exp, mix, harness.shape_of(exp), seed, device, {})
    s.setup()
    return s


def worst_leaves(got, want, n=4) -> dict:
    """The ``n`` leaves with the widest gradient and change gaps."""
    moved = compare.moved_leaves(want["grad_norms"])
    out = {}
    for key, leaves in (("grad_norms", want["grad_norms"]), ("change_norms", moved)):
        gaps = compare.leaf_gaps(got[key], want[key], leaves)
        out[key] = sorted(([k, v, want[key][k]] for k, v in gaps.items()), key=lambda x: -x[1])[:n]
    return out


def seed_readings(bench, cell, seed, control, fault, device="cuda", overrides=None) -> dict:
    import torch

    out = {"seed": seed}
    s = session_for(bench, cell, seed, device, overrides)
    training = hasattr(s, "program")
    if not training:
        s.slots, s.answers = list(range(len(s.pool))), s.score(s.pool)
    answers, slots = getattr(s, "answers", None), getattr(s, "slots", None)
    s.release()
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = s.reference()
    if training:
        out["sound"] = compare.training_numbers(s.program, ref)
        out["sound_leaves"] = worst_leaves(s.program, ref)
        out["losses"] = {"program": s.program["losses"], "reference": ref["losses"]}
    else:
        out["sound"] = score_gaps(answers, slots, ref, float("inf"))[0]
    if control:
        ctrl = s.reference("fp8")
        if training:
            out["control"] = compare.training_numbers(ctrl, ref)
            out["control_leaves"] = worst_leaves(ctrl, ref)
            out["losses"]["control"] = ctrl["losses"]
        else:
            out["control"] = score_gaps([x for slot in slots for x in ctrl[slot]], slots, ref,
                                        float("inf"))[0]
    if fault:
        for name, plant in (faults.TRAINING if training else faults.SCORING).items():
            if name == "unchanged_state":
                continue  # reads 1 by construction: no leaf moves
            with plant():
                f = session_for(bench, cell, seed, device, overrides)
                if training:
                    out[name] = compare.training_numbers(f.program, ref)
                else:
                    got = f.score(f.pool)
                    out[name] = score_gaps(got, list(range(len(f.pool))), ref, float("inf"))[0]
                f.release()
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--faults", type=int, default=0)
    args = parser.parse_args()
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = seed_readings(bench, cell, seed, i < args.control, i < args.faults)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
