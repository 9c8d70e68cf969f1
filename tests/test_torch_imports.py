"""Import hygiene of the PyTorch port.

``mmt_tpu_torch`` imports torch, numpy and the standard library only:
never jax, flax, pandas, the JAX package ``mmt_tpu`` (whose name is a
prefix of the port's), or yaml at module level.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import mmt_tpu_torch

PACKAGE_DIR = Path(mmt_tpu_torch.__file__).resolve().parent
REPO = PACKAGE_DIR.parent
# `mmt_tpu` followed by a dot or a word boundary that is not `_torch`.
_JAX_PACKAGE = r"mmt_tpu(?!_torch)\b"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|orbax|pandas|" + _JAX_PACKAGE + r")\b", re.MULTILINE)
_TOP_LEVEL_YAML = re.compile(r"^(?:import|from)\s+yaml\b", re.MULTILINE)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PACKAGE_DIR)], prefix="mmt_tpu_torch."))


def test_every_module_imports_without_jax_or_the_jax_package():
    modules = _modules()
    for name in ("ops.fused_attention", "models.pretraining_model", "train.tasks",
                 "train.loop", "train.optimizer", "train.losses", "train.metrics",
                 "train.train_state", "data.dummy", "cli.train", "configs.experiments",
                 "configs.data", "configs.optimization", "probes.split_probe",
                 "probes.op_cost_probe", "probes.hopper_probe", "probes.common", "probes.fwd_ab",
                 "data.tfrecord", "data.native", "data.assembly", "data.loaders",
                 "text.wordpiece", "text.trimmer", "text.native", "features.patches",
                 "cli.predict", "train.checkpoint", "features.masking", "data.prefetch",
                 "train.preemption", "train.continuous", "utils.tb_events", "utils.bindings",
                 "utils.profiling", "ops.quant", "eval.export", "preprocessing.records",
                 "preprocessing.flickr30k", "preprocessing.wit", "preprocessing.fashion_gen"):
        assert f"mmt_tpu_torch.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'pandas', 'yaml', 'PIL', 'triton', 'mmt_tpu'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_no_forbidden_import():
    sources = sorted(PACKAGE_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
        assert not _TOP_LEVEL_YAML.search(text), path


def test_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.search("from mmt_tpu.ops import x")
    assert _FORBIDDEN.search("import mmt_tpu")
    assert _FORBIDDEN.search("  import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from mmt_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import mmt_tpu_torch")
