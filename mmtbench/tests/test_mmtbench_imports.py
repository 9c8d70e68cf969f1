"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``mmt_tpu`` (``mmt_tpu_torch`` is another name), and the
reference loads nothing of the program."""

import ast
import subprocess
import sys

from mmtbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "mmt_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in harness.ROOT.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "reference").rglob("*.py"):
        assert not top_level_imports(path) & (FORBIDDEN | {"mmt_tpu_torch"}), path
    code = (f"import sys; sys.path.insert(0, {str(harness.REPO)!r})\n"
            "import mmtbench.reference.model, mmtbench.reference.train, "
            "mmtbench.reference.compare\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mmt_tpu', 'mmt_tpu_torch'})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_the_check_compares_whole_names(monkeypatch):
    for name in ("mmt_tpu_torch", "mmt_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name not in harness.forbidden_modules()
    for name in ("mmt_tpu", "mmt_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in harness.forbidden_modules()
