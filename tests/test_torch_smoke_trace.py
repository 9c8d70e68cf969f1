"""chip_smoke's one-step traces: an incomplete trace is taken again, and
the per-call reading refuses a trace that stays incomplete. The profiler
runs on the CPU here; the device intervals each trace yields are given."""
import pytest
import torch

import chip_smoke

FWD, BWD = chip_smoke.FWD_KERNEL, chip_smoke.BWD_KERNEL


def trace(fwd, bwd):
    """Intervals of ``fwd`` forward and ``bwd`` backward calls, 2 us each,
    among other kernels."""
    out = [("gemm_sm90", 0.0, 5.0)]
    out += [(f"void {FWD}<...>", 10.0 * i, 10.0 * i + 2.0) for i in range(fwd)]
    out += [(f"void {BWD}<...>", 10.0 * i, 10.0 * i + 2.0) for i in range(bwd)]
    return out


@pytest.mark.parametrize("traces, taken", [
    ([trace(12, 12)], 1),
    ([trace(11, 12), trace(12, 12)], 2),
    ([trace(12, 11), trace(11, 12), trace(12, 12)], 3),
])
def test_incomplete_traces_are_taken_again(monkeypatch, traces, taken):
    given = iter(traces)
    steps = []
    monkeypatch.setattr(chip_smoke, "device_intervals", lambda prof: next(given))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "TRACE_MARGIN_S", 0.0)
    intervals, wall_ms, attempts = chip_smoke.profile_step(lambda: steps.append(1),
                                                           {FWD: 12, BWD: 12})
    assert attempts == taken == len(steps)
    assert intervals == traces[-1] and wall_ms >= 0
    assert chip_smoke.kernel_calls_ms(intervals, FWD, 12) == pytest.approx(2e-3)


def test_a_trace_incomplete_every_time_is_refused(monkeypatch):
    steps = []
    monkeypatch.setattr(chip_smoke, "device_intervals", lambda prof: trace(11, 12))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "TRACE_MARGIN_S", 0.0)
    intervals, _, attempts = chip_smoke.profile_step(lambda: steps.append(1), {FWD: 12})
    assert attempts == len(steps) == chip_smoke.TRACE_ATTEMPTS
    with pytest.raises(AssertionError, match="11 calls of"):
        chip_smoke.kernel_calls_ms(intervals, FWD, 12)


def test_phase_walls_add_up_to_the_last_phase_line(monkeypatch, capsys):
    """Each phase line adds the seconds since the previous one to its
    phase's wall (a phase emitted twice sums both), for the total line's
    ``phase_seconds``."""
    import json

    clock = iter([12.5, 13.0, 20.0, 21.0])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(chip_smoke, "_start", [10.0])
    monkeypatch.setattr(chip_smoke, "_lines", [])
    monkeypatch.setattr(chip_smoke, "_phase_seconds", {})
    for obj in ({"phase": "a"}, {"note": 1}, {"phase": "b"}, {"phase": "a"}):
        chip_smoke.emit(obj)
    assert chip_smoke._phase_seconds == {"a": 2.5 + 1.0, "b": 7.5}
    assert [json.loads(line)["elapsed_s"] for line in chip_smoke._lines] == [2.5, 3.0, 10.0, 11.0]
    capsys.readouterr()
