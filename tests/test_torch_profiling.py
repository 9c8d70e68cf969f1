"""The port's profiling hooks against the JAX package's.

* ``StepTimer``: the JAX timer's numbers under the same pinned
  ``time.perf_counter`` readings;
* ``trace_if``: a Chrome trace file under ``log_dir`` on the CPU, holding
  the enclosed block's operators; nothing when disabled;
* ``start_server`` has no PyTorch counterpart and raises.
"""

import json
import time

import pytest
import torch

from mmt_tpu.utils import profiling as jax_profiling
from mmt_tpu_torch.utils import profiling


@pytest.fixture
def pinned_perf_counter(monkeypatch):
    def pin(readings):
        it = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
    return pin


@pytest.mark.parametrize("updates", [[], [4], [4, 8, 16], [1] * 7])
def test_step_timer_matches_jax(pinned_perf_counter, updates):
    readings = [10.0 + 0.5 * i for i in range(4 * len(updates) + 8)]
    results = []
    for timer_cls in (profiling.StepTimer, jax_profiling.StepTimer):
        pinned_perf_counter(list(readings))
        timer = timer_cls()
        snaps = [timer.snapshot()]
        for batch in updates:
            timer.update(batch)
        snaps.append(timer.snapshot())
        timer.update(3)
        snaps.append(timer.snapshot())
        results.append(snaps)
    assert results[0] == results[1]
    if updates:
        assert results[0][1]["examples_per_sec"] == sum(updates) / 0.5


def test_trace_if_writes_a_chrome_trace(tmp_path):
    with profiling.trace_if(str(tmp_path / "trace"), enabled=True) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").iterdir())
    assert [str(f) for f in files] == [prof.trace_path]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_if_disabled_writes_nothing(tmp_path):
    with profiling.trace_if(str(tmp_path / "trace"), enabled=False) as prof:
        torch.ones(2) + 1
    assert prof is None and not (tmp_path / "trace").exists()


def test_start_server_raises():
    with pytest.raises(NotImplementedError, match="trace_if"):
        profiling.start_server(9999)
