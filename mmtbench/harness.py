"""The benchmark's run: find the cell's pieces by name, set up, measure,
trace, check, print.

Everything that belongs to one piece sits in files of its own, found by the
names in ``BENCHMARK.json``:

* a configuration: the ``file`` its entry names (``configs/<name>.json``):
  the experiment, the source's values, ``reduced`` and ``assumed``;
* a traffic mix: ``traffic/<mix>.json``, the parameters that
  ``generate.py`` reads, and the ``driver`` (``drivers/<driver>.py``) that
  drives the program's entry for it;
* a cell's limits: ``limits/<cell>.json``, the numbers that decide
  ``correct``;
* a per-layer metric ``<base>.<variant>``: the reader ``metrics/<base>.py``.

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "mmt_tpu")
PLACEHOLDER = "CHANGE_ME"
GIB = float(1 << 30)


class RunError(Exception):
    """A run that cannot print a result; ``code`` is its exit code."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


@contextlib.contextmanager
def phase(times: Dict[str, float], name: str):
    """Adds the seconds of the block to ``times[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise RunError(f"no workload {name!r} in BENCHMARK.json", 2)


def config_file(bench: dict, name: str, repo: Path = REPO) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return load_json(repo / entry["file"])
    raise RunError(f"no configuration {name!r} in BENCHMARK.json", 2)


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict[str, float]:
    return load_json(ROOT / "limits" / f"{cell}.json")["limits"]


def driver(name: str):
    return importlib.import_module(f"mmtbench.drivers.{name}")


def reader(metric: str):
    return importlib.import_module(f"mmtbench.metrics.{metric.split('.')[0]}")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports: those
    that list it under ``workloads``, which every per-layer entry has, and
    the end-to-end entries without the key."""
    return [m for m in bench[kind]
            if cell in (m["workloads"] if kind == "per_layer" else m.get("workloads", [cell]))]


def _values(cfg) -> dict:
    """The source's values, less the placeholders the benchmark does not read
    (record paths, a vocabulary file, a checkpoint to warm-start from)."""
    if isinstance(cfg, dict):
        return {k: _values(v) for k, v in cfg.items()
                if not (isinstance(v, str) and v.startswith(PLACEHOLDER))}
    if isinstance(cfg, list):
        return [_values(v) for v in cfg]
    return cfg


def experiment(cfg: dict, overrides: Optional[dict] = None):
    """The program's experiment config of a configuration file."""
    from mmt_tpu_torch.configs import get_experiment_config, override

    exp = override(get_experiment_config(cfg["experiment"]), _values(cfg["config"]))
    return override(exp, overrides) if overrides else exp


def shape_of(exp) -> dict:
    """The sizes the generator, the reference and the readers take."""
    enc, data = exp.task.model.encoder.mmt, exp.task.train_data
    reference = enc.as_dict()
    reference.update(image_size=data.image_size, patch_size=data.patch_size)
    return {
        "seq_len": data.max_seq_len, "patches": data.num_patches,
        "patch_dim": data.input_channels * data.patch_size**2, "vocab": enc.vocab_size,
        "hidden": enc.hidden_size, "heads": enc.num_attention_heads,
        "head_dim": enc.hidden_size // enc.num_attention_heads,
        "intermediate": enc.intermediate_size, "layers": enc.num_hidden_layers,
        "rel_vocab": enc.relative_vocab_size,
        "mlm_slots": getattr(data, "mlm_max_selections_per_seq", 0),
        "mpp_slots": getattr(data, "mpp_max_selections_per_seq", 0),
        "initializer_range": enc.initializer_range,
        "reference": reference, "optimizer": exp.trainer.optimizer_config.as_dict(),
    }


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def run(cell_name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        repo: Path = REPO, overrides: Optional[dict] = None, t_start: Optional[float] = None,
        out=None, err=None) -> int:
    """One run of ``cell_name``; prints the set-up line, then the check
    lines on ``err`` and the result as the last line of ``out``.  Returns
    the exit code.  ``overrides`` (tests: a tiny model on the CPU) are
    applied to the configuration and the traffic mix."""
    out, err = out or sys.stdout, err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    try:
        bench = load_json(repo / "BENCHMARK.json")
        cell = find_cell(bench, cell_name)
        import torch

        if device == "cuda" and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < cell["chips"]):
            raise RunError(f"{cell_name} needs {cell['chips']} CUDA device(s); "
                           f"torch sees {torch.cuda.device_count()}", 3)
        mix = {**traffic(cell["traffic"]), **overrides.get("traffic", {})}
        cell_limits = limits(cell_name)
        times: Dict[str, float] = {}
        with phase(times, "import"):
            exp = experiment(config_file(bench, cell["config"], repo), overrides.get("config"))
        shape = shape_of(exp)
        session = driver(mix["driver"]).Session(exp, mix, shape, seed, device, times)
        session.setup()
        setup_s = time.perf_counter() - t_start
        times["other"] = setup_s - sum(times.values())
        print(json.dumps({"setup_s": setup_s, "setup_parts_s": times}), file=out, flush=True)
        measured = session.window(seconds)
        trace = session.trace() if traced else None
        if trace is not None:
            trace.window = {"seconds": measured["seconds"], "work": measured["work"]}
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        session.release()
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        from mmtbench.reference.compare import judge

        t_check = time.perf_counter()
        numbers, failed_answers = session.check(cell_limits)
        check_s = time.perf_counter() - t_check
        checks = judge(numbers, cell_limits)
        found = forbidden_modules()
        if found:
            raise RunError(f"modules of JAX or the JAX package were loaded: {found}", 4)
    except RunError as e:
        print(f"mmtbench: {e}", file=err, flush=True)
        return e.code

    values = {**measured["metrics"], "setup_s": setup_s, "peak_mem_gib": peak / GIB}
    result_metrics = {}
    for m in cell_metrics(bench, cell_name, "per_layer" if traced else "end_to_end"):
        if traced:
            value = reader(m["name"]).read(trace, shape)
            if value is None:
                continue
        elif m["name"] in values:
            value = {"value": values[m["name"]]}
        else:
            print(f"mmtbench: the driver gives no {m['name']}", file=err, flush=True)
            return 5
        result_metrics[m["name"]] = {**value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": all(c["ok"] for c in checks.values()) and measured["failed"] == 0
            and failed_answers == 0,
            "attempted": measured["attempted"], "failed": measured["failed"] + failed_answers,
            "metrics": result_metrics, "device": dev}
    if traced:
        dev.update(busy_s=trace.busy_s(), window_s=trace.wall_s)
        line["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
        line["traces"] = trace.attempts
    line["check_s"] = check_s
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return 0
