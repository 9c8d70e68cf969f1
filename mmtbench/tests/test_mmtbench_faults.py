"""``correct`` comes out false when the timed path is broken underneath:
each planted fault of ``mmtbench/faults.py`` that the cell can have, in a
whole run at a tiny size on the CPU (the look for a card skipped); and the
control (the reference in fp8 in the program's place) fails one of each
cell's limits, here at a tiny size and, with a card, at the cell's own size
on three seeds."""

import io
import json

import pytest

from mmtbench import faults, harness, readings
from mmtbench.drivers.predict import score_gaps
from mmtbench.reference import compare
from tiny import WIDE_SCORE, overrides

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
DRIVER = {w["name"]: harness.traffic(w["traffic"])["driver"] for w in BENCH["workloads"]}
TRAINING = [c for c, d in DRIVER.items() if d == "train_step"]
SCORING = [c for c, d in DRIVER.items() if d == "predict"]
CASES = ([(c, f) for c in TRAINING for f in faults.TRAINING]
         + [(c, f) for c in SCORING for f in faults.SCORING])


def run_line(cell, seed=2**31 + 3):
    out, err = io.StringIO(), io.StringIO()
    assert harness.run(cell, seed, 0.3, False, device="cpu", overrides=overrides(cell),
                       out=out, err=err) == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_not_correct(cell, fault):
    with (faults.TRAINING | faults.SCORING)[fault]():
        line = run_line(cell)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values()) or line["failed"]


def control_numbers(bench, cell, seed, device, o=None):
    s = readings.session_for(bench, harness.find_cell(bench, cell), seed, device, o)
    s.release()
    ref, ctrl = s.reference(), s.reference("fp8")
    if cell in TRAINING:
        return compare.training_numbers(ctrl, ref)
    slots = list(range(len(s.pool)))
    return score_gaps([x for i in slots for x in ctrl[i]], slots, ref, float("inf"))[0]


@pytest.mark.parametrize("cell", TRAINING + SCORING)
def test_control_fails_a_limit(cell):
    size = WIDE_SCORE if cell in SCORING else overrides(cell)
    numbers = control_numbers(BENCH, cell, 2**31 + 21, "cpu", size)
    limits = harness.limits(cell)
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


@pytest.mark.parametrize("cell", TRAINING + SCORING)
def test_control_fails_a_limit_at_size(cell, cuda):
    limits = harness.limits(cell)
    for seed in (4000000001, 4000000002, 4000000003):
        numbers = control_numbers(BENCH, cell, seed, "cuda")
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers, limits)
