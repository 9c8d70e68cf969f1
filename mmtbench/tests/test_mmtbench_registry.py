"""The harness finds every piece by name, and a configuration, a mix, a
cell and a per-layer metric are added as new files and entries, with no
existing file edited."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from mmtbench import harness
from tiny import ENCODER

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_pieces(cell):
    w = harness.find_cell(BENCH, cell)
    harness.config_file(BENCH, w["config"])
    mix = harness.traffic(w["traffic"])
    harness.driver(mix["driver"]).Session
    assert harness.limits(cell)
    reported = harness.cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    for m in harness.cell_metrics(BENCH, cell, "per_layer"):
        assert callable(harness.reader(m["name"]).read)


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


DUMMY_METRIC = '''"""A metric added as a file: the traced stretch's units."""


def read(trace, shape):
    return {"value": float(trace.units)}
'''


def test_pieces_added_as_files(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "mmtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    before = digest(tmp_path)
    root = tmp_path / "mmtbench"
    cfg = json.loads((root / "configs/flickr30k-itm-2d.json").read_text())
    cfg["name"] = "tiny-itm"
    cfg["config"]["task"]["model"]["encoder"]["mmt"].update(
        ENCODER, max_absolute_position_embeddings=40, compute_dtype="float32")
    cfg["config"]["task"]["train_data"].update(image_size=8, patch_size=4, max_seq_len=24,
                                               global_batch_size=8)
    (root / "configs/tiny-itm.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic/finetune.json").read_text())
    mix["text"] = {"dist": "uniform", "low": 3, "high": 18}
    (root / "traffic/tiny-finetune.json").write_text(json.dumps(mix))
    (root / "limits/tiny-itm.finetune.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}}))
    (root / "metrics/units_traced.py").write_text(DUMMY_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-itm", "source": "a test", "reduced": [],
                             "file": "mmtbench/configs/tiny-itm.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-itm.finetune", "config": "tiny-itm",
                               "traffic": "tiny-finetune", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "flickr30k-itm-2d.finetune" in m["workloads"]:
            m["workloads"].append("tiny-itm.finetune")
    bench["per_layer"].append({"name": "units_traced.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "driver",
                               "moves": "train_examples_per_s",
                               "workloads": ["tiny-itm.finetune"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(harness.REPO)!r}]\n"
            "import torch; torch.set_num_threads(2)\n"
            "from pathlib import Path\n"
            "from mmtbench import harness\n"
            "assert harness.ROOT == Path(sys.path[0]) / 'mmtbench', harness.ROOT\n"
            "bench = harness.load_json(Path(sys.path[0]) / 'BENCHMARK.json')\n"
            "names = [m['name'] for m in\n"
            "         harness.cell_metrics(bench, 'tiny-itm.finetune', 'per_layer')]\n"
            "assert 'units_traced.train' in names, names\n"
            "assert harness.reader('units_traced.train').read(type('T', (), {'units': 3}), {})"
            " == {'value': 3.0}\n"
            "sys.exit(harness.run('tiny-itm.finetune', 5, 0.5, False, device='cpu',"
            " repo=Path(sys.path[0])))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"train_examples_per_s", "peak_mem_gib",
                                                        "setup_s"}
