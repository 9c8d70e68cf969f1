"""Builds of the forward kernel's source timed against each other, on the card.

The forward kernel (``csrc/rel_attention_fwd.cu``, its template in
``csrc/rel_attention_fwd.cuh``) is one source with a plain C entry point,
``mmt_rel_attention_fwd``.  This probe compiles several versions of that
source (the tree's own, an older commit's, a version with other
preprocessor flags) and runs each through the port's own wrapper,
``fused_attention.relative_attention_forward``, so that a design change is
measured against the design before it in one process on one card.  A
variant is ``SOURCE[:FLAGS]``: ``current`` for the tree's source, or a path
to a ``.cu`` file (its directory, then ``csrc/``, is on the include path,
so an older commit's ``csrc/`` unpacked whole builds with its own headers),
and nvcc flags after a colon.  For example::

    mkdir -p .checkout_parent && git archive HEAD~1 mmt_tpu_torch/csrc | tar -x -C .checkout_parent
    python -m mmt_tpu_torch.probes.fwd_ab current \
        .checkout_parent/mmt_tpu_torch/csrc/rel_attention_fwd.cu

Each variant is first held against the plain version (``kernel_errors``:
the o / lse bounds of ``tests/test_torch_cuda.py``) at the check lengths
without and with dropout, at the pretraining micro-batch with dropout and
at the windowed micro-batch with dropout; then every variant's o and lse
are compared bit for bit with the first variant's (``bit_equality``) at
the three main-path shapes, each at rates 0 and 0.1; then every variant is
timed, in turns (variants in order, then in reverse), by the profiler's
device time of the kernel at those shapes: retrieval (B=32, S=4096, rate
0), the 4k windowed micro-batch (B=8, window 512, global prefix 198, rate
0.1), and the S=256 micro-batch (B=64, rate 0.1 and 0).  One JSON line per
build, per check, per comparison and per timing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mmt_tpu_torch.ops import build
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.probes import common

O_BOUND, LSE_BOUND = 2e-2, 1e-3
KERNEL_NAME = "rel_attention_fwd"
CHECK_LENGTHS = [4096, 3001, 1000, 257]
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MIN_LEN = 256, 64, 204
WINDOW, WINDOW_GLOBAL, WINDOW_BATCH = 512, 198, 8
_BUILD_DIR = build.PACKAGE_DIR / "_build" / "fwd_ab"


def parse_variant(spec: str) -> Tuple[Path, List[str]]:
    """``SOURCE[:FLAGS]`` -> (source path, nvcc flags)."""
    source, _, flags = spec.partition(":")
    path = build.CSRC_DIR / "rel_attention_fwd.cu" if source == "current" else Path(source)
    return path.resolve(), flags.split()


def build_variants(specs: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together; a failed build raises."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, spec in enumerate(specs):
        source, flags = parse_variant(spec)
        out = _BUILD_DIR / f"variant{n}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-I", str(source.parent),
               "-I", str(build.CSRC_DIR), "-o", str(out), str(source)]
        procs[spec] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for spec, (proc, out) in procs.items():
        log, _ = proc.communicate()
        usage = [l.strip() for l in log.splitlines() if "Used" in l or "spill" in l]
        print(json.dumps({"build": spec, "ptxas": usage}), flush=True)
        if proc.returncode:
            raise RuntimeError(f"{spec}: nvcc exited {proc.returncode}\n{log}")
        libs[spec] = fa.bind_fwd_library(ctypes.CDLL(str(out)))
    return libs


def use(lib: ctypes.CDLL) -> None:
    """Points the wrapper at ``lib`` for this process (``run`` restores it)."""
    fa._fwd_kernel = lambda: lib


def shapes() -> Dict[str, tuple]:
    """name -> (q, k, v, table, geometry, lengths, rate) of the main paths."""
    flagship = common.attention_inputs(common.retrieval_lengths(), seed=3)
    train_lengths = np.random.default_rng(5).integers(TRAIN_MIN_LEN, TRAIN_SEQ + 1, TRAIN_BATCH)
    train = common.attention_inputs(train_lengths.tolist(), seed=6, seq_len=TRAIN_SEQ)
    window = common.attention_inputs(common.retrieval_lengths(seed=30, batch=WINDOW_BATCH),
                                     seed=31)
    window_geo = dataclasses.replace(common.FLAGSHIP, window=WINDOW, num_global=WINDOW_GLOBAL)
    return {
        "flagship_rate_0": (*flagship[:4], common.FLAGSHIP, flagship[4], 0.0),
        "window_rate_0.1": (*window[:4], window_geo, window[4], 0.1),
        "train_rate_0.1": (*train[:4], common.FLAGSHIP, train[4], 0.1),
        "train_rate_0": (*train[:4], common.FLAGSHIP, train[4], 0.0),
    }


def kernel_errors(q, k, v, table, geometry, lengths, rate) -> Tuple[float, float]:
    """Max abs error of o and lse on real rows, kernel against plain."""
    seed = 77 if rate else None
    o, lse = fa.relative_attention_forward(q, k, v, table, geometry, lengths, "cuda", rate, seed)
    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, geometry, lengths, rate, seed)
    err_o = err_lse = 0.0
    for b, n in enumerate(lengths.tolist()):
        err_o = max(err_o, (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item())
        err_lse = max(err_lse, (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item())
    return err_o, err_lse


def bit_equal_cases() -> Dict[str, tuple]:
    """name -> (q, k, v, table, geometry, lengths, rate): the three
    main-path shapes, each at rates 0 and 0.1."""
    out = {}
    for name, args in shapes().items():
        shape = name.rsplit("_rate_", 1)[0]
        for rate in (0.0, 0.1):
            out[f"{shape}_rate_{rate:g}"] = (*args[:6], rate)
    return out


def forward_outputs(args) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of the forward kernel on one case (seed 5 with dropout)."""
    q, k, v, table, geometry, lengths, rate = args
    return fa.relative_attention_forward(q, k, v, table, geometry, lengths, "cuda", rate,
                                         5 if rate else None)


def bit_equality(reference: Dict[str, tuple], outputs: Dict[str, tuple]) -> Dict[str, bool]:
    """case -> whether o and lse of ``outputs`` equal ``reference``'s bit for
    bit (NaNs never occur: rows without a live key hold 0 and -inf)."""
    return {case: all(torch.equal(a, b) for a, b in zip(reference[case], got))
            for case, got in outputs.items()}


def kernel_ms(args, iters: int) -> float:
    """Profiler device ms per call of the forward kernel (from the trace)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, table, geometry, lengths, rate = args
    call = lambda: fa.relative_attention_forward(  # noqa: E731
        q, k, v, table, geometry, lengths, "cuda", rate, 5 if rate else None)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "trace.json")
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    total_us = sum(float(e["dur"]) for e in events
                   if e.get("cat") == "kernel" and KERNEL_NAME in e.get("name", ""))
    return total_us / 1e3 / iters


def run(specs: Sequence[str] = ("current",), device="cuda") -> dict:
    """The probe's entry point: builds, checks, compares and times every
    variant; returns the times and the comparisons.  Runs on the card."""
    from mmt_tpu_torch.device import resolve_device

    if resolve_device(device).type != "cuda":
        raise ValueError("the forward kernel's builds have no CPU version: run on the card")
    own = fa._fwd_kernel
    try:
        return _run(specs)
    finally:
        fa._fwd_kernel = own


def _run(specs: Sequence[str]) -> dict:
    print(common.card_line(), flush=True)
    libs = build_variants(specs)
    q, k, v, table, lens = common.attention_inputs(CHECK_LENGTHS, seed=1)
    cases = shapes()
    for spec, lib in libs.items():
        use(lib)
        errs = {f"check_rate_{rate}": kernel_errors(q, k, v, table, common.FLAGSHIP, lens, rate)
                for rate in (0.0, 0.1)}
        for name in ("train_rate_0.1", "window_rate_0.1"):
            errs[name] = kernel_errors(*cases[name])
        ok = all(o <= O_BOUND and l <= LSE_BOUND for o, l in errs.values())
        print(json.dumps({"variant": spec, "ok": ok, "errors": errs}), flush=True)
        if not ok:
            raise AssertionError(f"{spec} disagrees with the plain version: {errs}")
    del q, k, v, table, lens
    equal_cases = bit_equal_cases()
    reference, equal = None, {}
    for spec, lib in libs.items():
        use(lib)
        outs = {name: forward_outputs(args) for name, args in equal_cases.items()}
        if reference is None:
            reference = outs
            continue
        equal[spec] = bit_equality(reference, outs)
        print(json.dumps({"variant": spec, "against": next(iter(libs)),
                          "bit_equal": equal[spec]}), flush=True)
    del reference, equal_cases
    iters = {"flagship_rate_0": 10, "window_rate_0.1": 20, "train_rate_0.1": 50,
             "train_rate_0": 50}
    times = {spec: {name: [] for name in cases} for spec in libs}
    for order in (list(libs), list(libs)[::-1]):  # in turns
        for spec in order:
            use(libs[spec])
            for name, args in cases.items():
                times[spec][name].append(kernel_ms(args, iters[name]))
    for spec in libs:
        print(json.dumps({"variant": spec, "kernel_ms": times[spec]}), flush=True)
    return {"kernel_ms": times, "bit_equal": equal}


if __name__ == "__main__":
    run(sys.argv[1:] or ["current"])
