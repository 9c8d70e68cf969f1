"""Each configuration file against its yaml, and BENCHMARK.json against the
shape of the benchmark's contract."""

import json
import re

import pytest
import yaml

from mmtbench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CONFIGS = [c["name"] for c in BENCH["configs"]]
# Every configuration file, those that no cell uses yet included.
FILES = sorted(p.stem for p in (harness.ROOT / "configs").glob("*.json"))


def config(name):
    return harness.load_json(harness.ROOT / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", FILES)
def test_config_file_is_its_yaml(name):
    cfg = config(name)
    assert cfg["config"] == yaml.safe_load((harness.REPO / cfg["yaml"]).read_text())


@pytest.mark.parametrize("name", FILES)
def test_widths_are_what_runs(name):
    cfg = config(name)
    exp = harness.experiment(cfg)
    enc, data = exp.task.model.encoder.mmt, exp.task.train_data
    adamw = exp.trainer.optimizer_config.adamw
    run = {**enc.as_dict(), **data.as_dict(), "weight_decay_rate": adamw.weight_decay_rate}
    assert {k: run[k] for k in cfg["widths"]} == cfg["widths"]


@pytest.mark.parametrize("name", FILES)
def test_reduced_is_what_was_left_out(name):
    cfg = config(name)
    for entry in BENCH["configs"]:
        if entry["name"] == name:
            assert entry["reduced"] == cfg["reduced"]
            assert entry["file"] == f"mmtbench/configs/{name}.json"
    dropped = [k for k, v in cfg["config"]["task"].items()
               if isinstance(v, str) and v.startswith(harness.PLACEHOLDER)]
    assert dropped == cfg["reduced"]


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mmtbench"] and BENCH["command"][1].startswith("mmtbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in CONFIGS and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:  # each cell that reports it reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
