"""Does the toolchain build, and the card run right, each Hopper primitive
the redesigned attention kernels need?

The card's own toolchain checks, in the manner of the TPU probe script:
tiny kernels, each compiled, run and compared with a plain version, one
status per probe (``OK``, ``WRONG RESULT`` or ``FAIL`` with the error).
They replace no TPU kernel: the counterpart of ``scripts/mosaic_probe.py``
(P3) is ``probes.mosaic_probe``, whose kernels compute that script's six
functions.  ``PROBES`` lists the primitives (``wgmma``, TMA load and store,
a ``cp.async`` ring, ``ldmatrix.trans`` / ``stmatrix``, cluster shared
memory, 227 KB of shared memory, ``setmaxnreg``, ``red.add``);
``csrc/probe_hopper.cu`` holds the kernels.

Copies, permutations and integer-valued sums are compared exactly; the
``wgmma`` product to 1e-3 absolute (float32 sums of 64 exact bf16
products in another order than the plain matmul's).

Run on the card::

    python -m mmt_tpu_torch.probes.hopper_probe

A probe that fails does not stop the others; the exit code is 1 if any is
not OK.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from mmt_tpu_torch.ops import build
from mmt_tpu_torch.probes import common

SMEM_WORDS = 232448 // 4
WGMMA_ATOL = 1e-3
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load_library("probe_hopper")
    signatures = {
        "mmt_probe_wgmma": [_PTR, _PTR, _PTR, _PTR],
        "mmt_probe_tma_load": [_PTR, _PTR, _INT, _PTR],
        "mmt_probe_tma_store": [_PTR, _PTR, _INT, _PTR],
        "mmt_probe_cp_async_ring": [_PTR, _PTR, _INT, _PTR],
        "mmt_probe_ldmatrix_stmatrix": [_PTR, _PTR, _PTR],
        "mmt_probe_cluster_dsmem": [_PTR, _PTR, _INT, _PTR],
        "mmt_probe_smem_227k": [_PTR, _PTR, _PTR],
        "mmt_probe_setmaxnreg": [_PTR, _PTR, _INT, _PTR],
        "mmt_probe_red_add_v4": [_PTR, _PTR, _INT, _INT, _PTR],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(probe: str, symbol: str, *args) -> None:
    """Calls one C entry point on the current stream, raises on a non-zero
    return, and counts the launch."""
    lib = _library()
    err = getattr(lib, symbol)(*args, torch.cuda.current_stream().cuda_stream)
    common.raise_on_error(lib, err, f"probe_hopper[{probe}]")
    launches[probe] += 1


def _rng_bf16(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)


# Each probe: make_inputs(rng) -> CPU tensors; kernel(*cuda tensors) -> CUDA
# tensor; plain(*tensors) -> tensor on the inputs' device.


def wgmma_kernel(a, b):
    common.require_cuda(a=a, b=b)
    c = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    _launch("wgmma_m64n64k16_bf16", "mmt_probe_wgmma", a.data_ptr(), b.data_ptr(), c.data_ptr())
    return c


def wgmma_plain(a, b):
    return a.float() @ b.float().T


def tma_load_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("tma_load_2d", "mmt_probe_tma_load", x.data_ptr(), out.data_ptr(), x.shape[0])
    return out


def tma_store_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("tma_store_2d", "mmt_probe_tma_store", x.data_ptr(), out.data_ptr(), x.shape[0])
    return out


def cp_async_ring_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("cp_async_ring", "mmt_probe_cp_async_ring", x.data_ptr(), out.data_ptr(),
            x.shape[0])
    return out


def copy_plain(x):
    return x.clone()


def transpose_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("ldmatrix_trans_stmatrix", "mmt_probe_ldmatrix_stmatrix", x.data_ptr(),
            out.data_ptr())
    return out


def transpose_plain(x):
    return x.T.contiguous()


def cluster_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("cluster_dsmem", "mmt_probe_cluster_dsmem", x.data_ptr(), out.data_ptr(),
            x.shape[0] // 2)
    return out


def cluster_plain(x):
    return x.reshape(-1, 2, x.shape[1]).flip(1).reshape(x.shape)


def smem_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("smem_227k", "mmt_probe_smem_227k", x.data_ptr(), out.data_ptr())
    return out


def smem_plain(x):
    return x.flip(0)


def setmaxnreg_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros_like(x)
    _launch("setmaxnreg", "mmt_probe_setmaxnreg", x.data_ptr(), out.data_ptr(),
            x.numel() // 384)
    return out


def setmaxnreg_plain(x):
    return 3.0 * x + 1.0


def red_add_kernel(x):
    common.require_cuda(x=x)
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    _launch("red_add_v4_f32", "mmt_probe_red_add_v4", x.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1])
    return out


def red_add_plain(x):
    return x.sum(0)


def _small_ints(rng, *shape) -> torch.Tensor:
    """Integer-valued float32: sums of them are exact in any order."""
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32))


# name -> (make_inputs, kernel, plain, absolute tolerance; 0 = exact)
PROBES: Dict[str, Tuple[Callable, Callable, Callable, float]] = {
    "wgmma_m64n64k16_bf16": (lambda rng: (_rng_bf16(rng, 64, 64), _rng_bf16(rng, 64, 64)),
                             wgmma_kernel, wgmma_plain, WGMMA_ATOL),
    "tma_load_2d": (lambda rng: (_rng_bf16(rng, 256, 64),), tma_load_kernel, copy_plain, 0.0),
    "tma_store_2d": (lambda rng: (_rng_bf16(rng, 256, 64),), tma_store_kernel, copy_plain, 0.0),
    "cp_async_ring": (lambda rng: (_rng_bf16(rng, 16, 64, 64),), cp_async_ring_kernel,
                      copy_plain, 0.0),
    "ldmatrix_trans_stmatrix": (lambda rng: (_rng_bf16(rng, 64, 64),), transpose_kernel,
                                transpose_plain, 0.0),
    "cluster_dsmem": (lambda rng: (_small_ints(rng, 8, 256),), cluster_kernel, cluster_plain,
                      0.0),
    "smem_227k": (lambda rng: (torch.from_numpy(
        rng.integers(-2**31, 2**31, SMEM_WORDS).astype(np.int32)),), smem_kernel, smem_plain,
                  0.0),
    "setmaxnreg": (lambda rng: (_small_ints(rng, 2 * 384),), setmaxnreg_kernel,
                   setmaxnreg_plain, 0.0),
    "red_add_v4_f32": (lambda rng: (_small_ints(rng, 64, 512),), red_add_kernel, red_add_plain,
                       0.0),
}
launches = {name: 0 for name in PROBES}


def probe_inputs(name: str, seed: int = 0, device="cuda"):
    make_inputs = PROBES[name][0]
    return tuple(t.to(device) for t in make_inputs(np.random.default_rng(seed)))


def run_probe(name: str, seed: int = 0) -> float:
    """Runs one probe on the card against its plain version; returns the
    max abs error, raises AssertionError above the probe's tolerance."""
    _, kernel, plain, atol = PROBES[name]
    inputs = probe_inputs(name, seed)
    got = kernel(*inputs)
    torch.cuda.synchronize()
    want = plain(*inputs)
    err = (got.double() - want.double()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{name}: max abs error {err} > {atol}")
    return err


def run(device="cuda") -> Dict[str, str]:
    """The probe's entry point: one status line per probe, going on after a
    failure, as the TPU script does.  Runs on the card."""
    from mmt_tpu_torch.device import resolve_device

    if resolve_device(device).type != "cuda":
        raise ValueError("the probe kernels have no CPU version: run on the card")
    print(common.card_line(), flush=True)
    status = {}
    for name in PROBES:
        try:
            run_probe(name)
            status[name] = "OK"
        except AssertionError:
            status[name] = "WRONG RESULT"
        except Exception as e:  # a failed build or launch: report and go on
            status[name] = f"FAIL {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        print(f"{name}: {status[name]}", flush=True)
    return status


if __name__ == "__main__":
    result = run()
    print(json.dumps(result))
    sys.exit(0 if all(s == "OK" for s in result.values()) else 1)
