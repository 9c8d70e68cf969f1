"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``mmt_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own by ``nvcc`` for ``sm_90a`` into
``mmt_tpu_torch/_build/<name>-<hash>.so`` (the directory is git-ignored),
keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, at first use.  It is loaded
with ``ctypes``.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas registers / shared memory / spills)


def sources() -> List[str]:
    """Names of the CUDA sources in the package, without ``.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """The build of ``name``, keyed by its source, the shared headers and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Built]:
    """Builds every named source (default: all) with one ``nvcc`` each,
    all started together.  Raises RuntimeError if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    built = {name: Built(library_path(name), 0.0, "") for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = Built(out, seconds, log)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return built


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    path = library_path(name)
    if not path.exists():
        build_all([name])
    return ctypes.CDLL(str(path))
