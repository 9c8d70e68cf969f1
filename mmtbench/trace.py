"""Device traces of a short steady stretch: the profiler's records, read
into device intervals, host activity, the busy time and the breakdown.

The profiler has dropped kernel records from one-step traces, most often at
the window's start, so the stretch runs ``MARGIN_S`` inside the profiler's
window at each end and a trace that lacks a call of ``expected`` is taken
again, up to ``ATTEMPTS`` traces.  A trace is read once and not kept.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ATTEMPTS = 5
MARGIN_S = 0.25
MARK = "mmtbench.traced"
# Gaps shorter than this are counted together as launch gaps.
SHORT_GAP_US = 20.0
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """One traced stretch: device (name, start_us, end_us) intervals and
    host ones, clipped to nothing; the stretch's bounds in trace time; its
    wall seconds by the host's clock; ``units`` steps or batches; ``work``
    what the driver says they computed; the number of traces taken."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start_us: float
    end_us: float
    wall_s: float
    units: int
    work: dict
    attempts: int
    window: Optional[dict] = None  # the run's measured window: its seconds and work

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the stretch."""
        busy, covered = 0.0, -math.inf
        for _, start, end in sorted(self.device, key=lambda x: x[1]):
            start, end = max(start, self.start_us, covered), min(end, self.end_us)
            if end > start:
                busy += end - start
            covered = max(covered, end)
        return busy / 1e6

    def kernel_ms(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(device ms, records) of the device operations whose name matches."""
        calls = [end - start for name, start, end in self.device if match(name)]
        return sum(calls) / 1e3, len(calls)

    def top_ops(self, n: int = 10) -> list:
        by_name: Dict[str, float] = {}
        for name, start, end in self.device:
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
        return [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle seconds of the stretch by what the host was doing: the
        innermost host operation that spans each gap's middle; gaps under
        SHORT_GAP_US are counted as launch gaps."""
        spans, covered = [], self.start_us
        for _, start, end in sorted(self.device, key=lambda x: x[1]):
            start, end = max(start, self.start_us), min(end, self.end_us)
            if start > covered:
                spans.append((covered, start))
            covered = max(covered, end)
        if self.end_us > covered:
            spans.append((covered, self.end_us))
        host = sorted(self.host, key=lambda x: x[1])
        starts = [h[1] for h in host]
        totals: Dict[str, float] = {}
        for start, end in spans:
            label = f"launch gaps under {SHORT_GAP_US:g} us"
            if end - start >= SHORT_GAP_US:
                label = "no host operation recorded"
                mid = (start + end) / 2
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 256, -1), -1):
                    if host[j][2] > mid:
                        label = host[j][0]
                        break
            totals[label[:120]] = totals.get(label[:120], 0.0) + (end - start) / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _read(prof) -> Tuple[list, list, float, float]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    device, host_spans, bounds = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append(span)
        elif cat in HOST_CATEGORIES:
            host_spans.append(span)
        elif e["name"] == MARK and cat == "user_annotation":
            bounds = span[1:]
    if bounds is None and device:  # a device-only trace: the stretch is its device span
        bounds = (min(d[1] for d in device), max(d[2] for d in device))
    if bounds is None:
        raise RuntimeError("the trace holds neither a mark of the stretch nor device records")
    return device, host_spans, bounds[0], bounds[1]


def trace(run: Callable[[], None], units: int, work: dict,
          expected: Dict[str, int], host: bool = True) -> Trace:
    """``run()`` (``units`` steps or batches, ending in a synchronise)
    under the profiler: device activity, and with ``host`` the host's too
    (whose recording slows a host that issues many small operations, so a
    stretch that the host paces under the profiler traces the device
    alone, and its idle gaps are not labelled).  ``expected``: kernel name
    -> records a complete trace holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, ATTEMPTS + 1):
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            time.sleep(MARGIN_S)
            t0 = time.perf_counter()
            with record_function(MARK):
                run()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(MARGIN_S)
        device, host_spans, start, end = _read(prof)
        complete = all(sum(name in n for n, _, _ in device) == count
                       for name, count in expected.items())
        if complete or attempt == ATTEMPTS:
            return Trace(device, host_spans, start, end, wall, units, work, attempt)
    raise AssertionError("unreachable")
