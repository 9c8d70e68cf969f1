"""The six functions of the TPU probe ``scripts/mosaic_probe.py``, on the card.

Counterpart of that script (row P3 of the port's kernel table): each
``probe_*`` there runs one ``pallas_call``; here each is a batched kernel
of ``csrc/probe_mosaic.cu`` that computes the same function on a leading
batch dimension B (B = 1 is the TPU probe's own call).  All fp32:

=========================  ======================  ==========================================
probe                      per instance            function
=========================  ======================  ==========================================
strided_roll               x [64, 256]             ``out[i, (j + i) % 256] = x[i, j]``
static_unaligned_store     x [8, 64] -> [64, 256]  zeros, ``out[8:16, 20:84] = x``
many_static_stores         x [256, 40] -> [256,    zeros, for g < 32: ``out[8g:8g+8, o:o+40] =
                           512]                    x[8g:8g+8]``, o = max(8g - 12, 0)
dynamic_lane_store         x [8, 64], off          zeros, ``out[0:8, off:off+64] = x``,
                           -> [64, 256]            0 <= off <= 192
uniform_dynamic_roll       x [64, 256], s          ``torch.roll(x, s, -1)``, any int32 s
small_matmul               x [256, 128], w [128,   ``x @ w`` to fp32 accuracy
                           64] -> [256, 64]
=========================  ======================  ==========================================

The scalars ``off`` and ``s`` are one-element int32 tensors on the card,
read inside the kernel, as the TPU's scalar prefetch reads them.  Outside
0 <= off <= 192 the dynamic store's kernel result is unspecified (its
plain version raises ``ValueError``).

The product has no fp32 ``wgmma``: the kernel splits x and w into bf16 hi
+ lo and sums lo.hi + hi.lo + hi.hi in fp32 (``small_matmul_split`` is
that arithmetic in plain PyTorch), ~2.5e-4 from the float64 product on the
TPU probe's inputs against the probe's ``atol`` of 1e-3.  Its persistent
blocks walk their instances through a ring of 32 KB slots, w once per
instance, then x's four 64-row blocks; ``small_matmul_emulated`` walks
that schedule (``small_matmul_schedule``) with the kernel's k order and
register layout in plain PyTorch.  The copies are exact.

Beside each kernel: its plain version (the same function in plain
PyTorch, on any device; the product in float64, rounded to fp32) and,
where one PyTorch call computes the function, that call
(``library_call``), a yardstick the port never calls.  ``launches``
counts each kernel's launches.

Run on the card::

    python -m mmt_tpu_torch.probes.mosaic_probe

It prints the card's ``nvidia-smi`` line and one status per probe (``OK``,
``WRONG RESULT`` or ``FAIL`` with the error), each kernel run at B = 1 on
the TPU probe's inputs and held against that script's numpy expectation;
the exit code is 1 if any is not OK.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmt_tpu_torch.ops import build
from mmt_tpu_torch.probes import common

ROLL_SHAPE = (64, 256)
BOX_SHAPE = (8, 64)  # x of the two single-box stores
BOX_OUT = (64, 256)
MANY_X, MANY_OUT = (256, 40), (256, 512)
MM_X, MM_W = (256, 128), (128, 64)
MAX_OFF = BOX_OUT[1] - BOX_SHAPE[1]  # 192
TPU_OFF, TPU_SHIFT = 36, 5  # the TPU probe's scalars
MATMUL_ATOL = 1e-3  # the TPU probe's np.allclose(..., atol=1e-3)
MM_ROWS = 64  # x's rows per block of the product kernel (one wgmma M)
MM_ITEMS = 1 + MM_X[0] // MM_ROWS  # the kernel's ring items per instance: w, then x's blocks
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load_library("probe_mosaic")
    signatures = {
        "mmt_probe_mosaic_strided_roll": [_PTR, _PTR, _INT],
        "mmt_probe_mosaic_uniform_dynamic_roll": [_PTR, _PTR, _PTR, _INT],
        "mmt_probe_mosaic_static_unaligned_store": [_PTR, _PTR, _INT],
        "mmt_probe_mosaic_many_static_stores": [_PTR, _PTR, _INT],
        "mmt_probe_mosaic_dynamic_lane_store": [_PTR, _PTR, _PTR, _INT],
        "mmt_probe_mosaic_small_matmul": [_PTR, _PTR, _PTR, _INT],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes + [_PTR], ctypes.c_int
    lib.mmt_probe_mosaic_small_matmul_grid.argtypes = [_INT]
    lib.mmt_probe_mosaic_small_matmul_grid.restype = ctypes.c_int
    lib.mmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> int:
    """Raises ValueError unless ``t`` is a contiguous [B, *shape] tensor of
    ``dtype`` with B >= 1; returns B."""
    if t.dtype != dtype or t.dim() != len(shape) + 1 or tuple(t.shape[1:]) != tuple(shape) \
            or t.shape[0] < 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor [B >= 1, "
                         f"{', '.join(map(str, shape))}], got {t.dtype} {list(t.shape)}")
    return t.shape[0]


def _check_scalar(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.numel() != 1 or t.device != like.device:
        raise ValueError(f"{name}: expected one int32 element on {like.device}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")


def _launch(probe: str, *args) -> None:
    """Calls the probe's C entry point on the current stream, raises on a
    non-zero return, and counts the launch."""
    lib = _library()
    err = getattr(lib, f"mmt_probe_mosaic_{probe}")(*args, torch.cuda.current_stream().cuda_stream)
    common.raise_on_error(lib, err, f"probe_mosaic[{probe}]")
    launches[probe] += 1


# ------------------------------------------------------------------ kernels


def strided_roll(x: torch.Tensor) -> torch.Tensor:
    """``out[b, i, (j + i) % 256] = x[b, i, j]``; x fp32 [B, 64, 256] on the card."""
    common.require_cuda(x=x)
    batch = _check("x", x, ROLL_SHAPE)
    out = torch.empty_like(x)
    _launch("strided_roll", x.data_ptr(), out.data_ptr(), batch)
    return out


def uniform_dynamic_roll(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, s, -1)``; x fp32 [B, 64, 256], s int32 [1], any value."""
    common.require_cuda(x=x, s=s)
    batch = _check("x", x, ROLL_SHAPE)
    _check_scalar("s", s, x)
    out = torch.empty_like(x)
    _launch("uniform_dynamic_roll", x.data_ptr(), s.data_ptr(), out.data_ptr(), batch)
    return out


def static_unaligned_store(x: torch.Tensor) -> torch.Tensor:
    """Zeros [B, 64, 256] with ``out[:, 8:16, 20:84] = x``; x fp32 [B, 8, 64]."""
    common.require_cuda(x=x)
    batch = _check("x", x, BOX_SHAPE)
    out = x.new_empty(batch, *BOX_OUT)
    _launch("static_unaligned_store", x.data_ptr(), out.data_ptr(), batch)
    return out


def many_static_stores(x: torch.Tensor) -> torch.Tensor:
    """Zeros [B, 256, 512] with the 32 boxes of ``many_static_stores_plain``;
    x fp32 [B, 256, 40]."""
    common.require_cuda(x=x)
    batch = _check("x", x, MANY_X)
    out = x.new_empty(batch, *MANY_OUT)
    _launch("many_static_stores", x.data_ptr(), out.data_ptr(), batch)
    return out


def dynamic_lane_store(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Zeros [B, 64, 256] with ``out[:, 0:8, off:off + 64] = x``; x fp32 [B, 8,
    64], off int32 [1] read by the kernel.  For off outside [0, 192] the
    result is unspecified: the kernel does not read off on the host."""
    common.require_cuda(x=x, off=off)
    batch = _check("x", x, BOX_SHAPE)
    _check_scalar("off", off, x)
    out = x.new_empty(batch, *BOX_OUT)
    _launch("dynamic_lane_store", x.data_ptr(), off.data_ptr(), out.data_ptr(), batch)
    return out


def small_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` per instance to fp32 accuracy (bf16 hi + lo on ``wgmma``);
    x fp32 [B, 256, 128], w fp32 [B, 128, 64]."""
    common.require_cuda(x=x, w=w)
    batch = _check("x", x, MM_X)
    if _check("w", w, MM_W) != batch or w.device != x.device:
        raise ValueError(f"w: expected [{batch}, 128, 64] on {x.device}, got "
                         f"{list(w.shape)} on {w.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:  # the kernel's bulk copies
        raise ValueError("x and w must start on 16-byte boundaries")
    out = x.new_empty(batch, MM_X[0], MM_W[1])
    _launch("small_matmul", x.data_ptr(), w.data_ptr(), out.data_ptr(), batch)
    return out


def small_matmul_grid(batch: int) -> int:
    """Blocks of the product kernel's launch at ``batch`` on the current
    card: as many as are resident at once, at most one per instance."""
    lib = _library()
    grid = lib.mmt_probe_mosaic_small_matmul_grid(batch)
    if grid < 0:
        common.raise_on_error(lib, -grid, "probe_mosaic[small_matmul_grid]")
    return grid


# ---------------------------------------------------------- plain versions


def strided_roll_plain(x: torch.Tensor) -> torch.Tensor:
    """Row i rolled right by i, row by row (the TPU probe's expectation)."""
    return torch.stack([torch.roll(x[:, i], i, -1) for i in range(x.shape[1])], 1)


def uniform_dynamic_roll_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    cols = x.shape[-1]
    src = (torch.arange(cols, device=x.device) - int(s.reshape(()))) % cols
    return x[..., src]


def _box_plain(x: torch.Tensor, out_shape, boxes) -> torch.Tensor:
    """Zeros of [B, *out_shape] with x's rows [x0, x1) stored at (row, col)
    for each (x0, x1, row, col) of ``boxes``."""
    out = x.new_zeros(x.shape[0], *out_shape)
    for x0, x1, row, col in boxes:
        out[:, row:row + x1 - x0, col:col + x.shape[2]] = x[:, x0:x1]
    return out


def static_unaligned_store_plain(x: torch.Tensor) -> torch.Tensor:
    return _box_plain(x, BOX_OUT, [(0, 8, 8, 20)])


def many_static_stores_plain(x: torch.Tensor) -> torch.Tensor:
    return _box_plain(x, MANY_OUT, [(8 * g, 8 * g + 8, 8 * g, max(8 * g - 12, 0))
                                    for g in range(32)])


def _host_off(off: torch.Tensor) -> int:
    value = int(off.reshape(()))
    if not 0 <= value <= MAX_OFF:
        raise ValueError(f"off {value} outside [0, {MAX_OFF}]: the box must lie in the tile")
    return value


def dynamic_lane_store_plain(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return _box_plain(x, BOX_OUT, [(0, 8, 0, _host_off(off))])


def small_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float64 product rounded to fp32 (no tf32 setting reaches it)."""
    return torch.bmm(x.double(), w.double()).float()


def split_bf16(t: torch.Tensor):
    """The kernel's split of fp32 ``t``: hi = bf16(t), lo = bf16(t - hi), as fp32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def small_matmul_split(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product's arithmetic in the kernel, in plain PyTorch: lo.hi +
    hi.lo + hi.hi of the bf16 split (each product exact in float64, the sum
    rounded to fp32 once; the kernel's fp32 sums round more often)."""
    (xh, xl), (wh, wl) = split_bf16(x), split_bf16(w)
    d = lambda a, b: torch.bmm(a.double(), b.double())  # noqa: E731
    return (d(xl, wh) + d(xh, wl) + d(xh, wh)).float()


def small_matmul_k(p: int) -> int:
    """The product kernel's k for x's column (w's row) p (``mm_k``): w's row
    p is stored at k, where the A registers put x's column p."""
    q, j = (p >> 2) & 3, p & 3
    return (p & ~15) + (2 * q + j if j < 2 else 6 + 2 * q + j)


def small_matmul_schedule(batch: int, grid: int):
    """The product kernel's walk at ``batch`` on ``grid`` blocks: for each
    block, its ring items in order as (block, item, instance, part), part
    0 w and part 1-4 x's 64-row blocks; block b takes instances b, b +
    grid, ..."""
    for block in range(grid):
        for t in range(MM_ITEMS * -(-(batch - block) // grid)):
            yield block, t, block + t // MM_ITEMS * grid, t % MM_ITEMS


def _a_columns() -> torch.Tensor:
    """x's column under each k of the product's A operand, from the
    registers of the m64n64k16 wgmma: thread q = lane % 4 reads x's
    columns 16 s + 4 q + j (j < 4) of its rows at step s; its register
    2 (j // 2) + (row half) holds k = 16 s + 8 (j // 2) + 2 q + j % 2."""
    cols = torch.empty(MM_X[1], dtype=torch.long)
    for s in range(MM_X[1] // 16):
        for q in range(4):
            for j in range(4):
                cols[16 * s + 8 * (j // 2) + 2 * q + j % 2] = 16 * s + 4 * q + j
    return cols


def small_matmul_emulated(x: torch.Tensor, w: torch.Tensor, grid: int) -> torch.Tensor:
    """The product kernel's schedule in plain PyTorch on ``grid`` blocks:
    per instance w split into hi / lo rows at ``small_matmul_k``, each
    64-row block of x as the A operand of ``_a_columns``, and per block
    lo.hi + hi.lo for each 16-deep step, then hi.hi, each step's product
    (exact in float64) added to the fp32 sum.  Every output row is written
    once (the rest stays NaN)."""
    out = x.new_full((x.shape[0], MM_X[0], MM_W[1]), float("nan"))
    cols = _a_columns()
    ks = torch.tensor([small_matmul_k(p) for p in range(MM_X[1])])
    w_hi = w_lo = None
    for _, _, inst, part in small_matmul_schedule(x.shape[0], grid):
        if part == 0:
            hi, lo = split_bf16(w[inst])
            w_hi, w_lo = torch.empty_like(hi), torch.empty_like(lo)
            w_hi[ks], w_lo[ks] = hi, lo
            continue
        rows = slice((part - 1) * MM_ROWS, part * MM_ROWS)
        a_hi, a_lo = split_bf16(x[inst, rows][:, cols])
        acc = x.new_zeros(MM_ROWS, MM_W[1])
        steps = [slice(16 * s, 16 * s + 16) for s in range(MM_X[1] // 16)]
        terms = [(a, b, k) for k in steps for a, b in ((a_lo, w_hi), (a_hi, w_lo))]
        for a, b, k in terms + [(a_hi, w_hi, k) for k in steps]:
            acc = (acc.double() + a[:, k].double() @ b[k].double()).float()
        if not out[inst, rows].isnan().all():
            raise AssertionError(f"instance {inst} block {part} written twice")
        out[inst, rows] = acc
    return out


# -------------------------------------------------------- library yardsticks


def _bmm_fp32(x, w):
    """torch.bmm in full fp32: tf32 off for the call."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def library_call(name: str, inputs) -> Optional[Callable[[], torch.Tensor]]:
    """A call of the one PyTorch function that computes probe ``name`` on
    ``inputs`` (host scalars read here, once), or None where there is none
    (``many_static_stores``: 32 boxes take 32 calls)."""
    x = inputs[0]
    if name == "strided_roll":
        rows, cols = x.shape[1:]
        idx = (torch.arange(cols, device=x.device)[None, :]
               - torch.arange(rows, device=x.device)[:, None]) % cols
        idx = idx.expand(x.shape)  # a stride-0 view: the index is read per row once
        return lambda: torch.gather(x, -1, idx)
    if name == "uniform_dynamic_roll":
        s = int(inputs[1].reshape(()))
        return lambda: torch.roll(x, s, -1)
    if name == "static_unaligned_store":
        pad = (20, BOX_OUT[1] - 84, 8, BOX_OUT[0] - 16)
        return lambda: F.pad(x, pad)
    if name == "dynamic_lane_store":
        off = _host_off(inputs[1])
        pad = (off, MAX_OFF - off, 0, BOX_OUT[0] - BOX_SHAPE[0])
        return lambda: F.pad(x, pad)
    if name == "small_matmul":
        return lambda: _bmm_fp32(x, inputs[1])
    return None


# ------------------------------------------------------------------ table


def _scalar(value: int) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.int32)


class Probe(NamedTuple):
    kernel: Callable
    plain: Callable
    tpu_inputs: Callable[[], tuple]  # the TPU probe's own inputs, B = 1, CPU tensors
    seeded: Callable  # (rng, batch, scalar) -> CPU tensors
    expected: Callable  # the TPU probe's numpy expectation of one instance
    atol: float  # 0: exact
    timing_batch: int  # B at which the kernel moves >= ~235 MB (bound >= 70 us)


def _arange(shape) -> torch.Tensor:
    return torch.from_numpy(np.arange(np.prod(shape), dtype=np.float32).reshape(1, *shape))


def _normal(rng, batch, shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal((batch, *shape), np.float32))


def _tpu_matmul_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=MM_X).astype(np.float32)
    w = rng.normal(size=MM_W).astype(np.float32)
    return torch.from_numpy(x)[None], torch.from_numpy(w)[None]


def _expect_box(x, out_shape, boxes):
    exp = np.zeros(out_shape, np.float32)
    for x0, x1, row, col in boxes:
        exp[row:row + x1 - x0, col:col + x.shape[1]] = x[x0:x1]
    return exp


PROBES: Dict[str, Probe] = {
    "strided_roll": Probe(
        strided_roll, strided_roll_plain, lambda: (_arange(ROLL_SHAPE),),
        lambda rng, b, _=None: (_normal(rng, b, ROLL_SHAPE),),
        lambda x: np.stack([np.roll(x[i], i) for i in range(x.shape[0])]), 0.0, 2048),
    "static_unaligned_store": Probe(
        static_unaligned_store, static_unaligned_store_plain, lambda: (_arange(BOX_SHAPE),),
        lambda rng, b, _=None: (_normal(rng, b, BOX_SHAPE),),
        lambda x: _expect_box(x, BOX_OUT, [(0, 8, 8, 20)]), 0.0, 4096),
    "many_static_stores": Probe(
        many_static_stores, many_static_stores_plain, lambda: (_arange(MANY_X),),
        lambda rng, b, _=None: (_normal(rng, b, MANY_X),),
        lambda x: _expect_box(x, MANY_OUT, [(8 * g, 8 * g + 8, 8 * g, max(8 * g - 12, 0))
                                            for g in range(32)]), 0.0, 512),
    "dynamic_lane_store": Probe(
        dynamic_lane_store, dynamic_lane_store_plain,
        lambda: (_arange(BOX_SHAPE), _scalar(TPU_OFF)),
        lambda rng, b, off=TPU_OFF: (_normal(rng, b, BOX_SHAPE), _scalar(off)),
        lambda x, off: _expect_box(x, BOX_OUT, [(0, 8, 0, int(off[0]))]), 0.0, 4096),
    "uniform_dynamic_roll": Probe(
        uniform_dynamic_roll, uniform_dynamic_roll_plain,
        lambda: (_arange(ROLL_SHAPE), _scalar(TPU_SHIFT)),
        lambda rng, b, s=TPU_SHIFT: (_normal(rng, b, ROLL_SHAPE), _scalar(s)),
        lambda x, s: np.roll(x, int(s[0]), axis=1), 0.0, 2048),
    "small_matmul": Probe(
        small_matmul, small_matmul_plain, _tpu_matmul_inputs,
        lambda rng, b, _=None: (_normal(rng, b, MM_X), _normal(rng, b, MM_W)),
        lambda x, w: x @ w, MATMUL_ATOL, 1024),
}
launches = {name: 0 for name in PROBES}


def tpu_probe_status(name: str, got: torch.Tensor, inputs) -> str:
    """``OK`` if the kernel's B = 1 output ``got`` passes the TPU probe's own
    check against its numpy expectation (equality; ``allclose`` at atol
    1e-3 for the product), else ``WRONG RESULT``."""
    probe = PROBES[name]
    out = got.cpu().numpy()[0]
    exp = probe.expected(*(t.cpu().numpy()[0] if t.dim() > 1 else t.cpu().numpy()
                           for t in inputs))
    if probe.atol:
        ok = np.allclose(out, exp, atol=probe.atol)
    else:
        ok = np.array_equal(out, exp)
    return "OK" if ok else "WRONG RESULT"


def run(device="cuda") -> Dict[str, str]:
    """The probe's entry point: each kernel at B = 1 on the TPU probe's own
    inputs (off = 36, s = 5), one status line each, going on after a
    failure, as the TPU script does.  Runs on the card."""
    from mmt_tpu_torch.device import resolve_device

    if resolve_device(device).type != "cuda":
        raise ValueError("the probe kernels have no CPU version: run on the card")
    print(common.card_line(), flush=True)
    status = {}
    for name, probe in PROBES.items():
        try:
            inputs = tuple(t.cuda() for t in probe.tpu_inputs())
            got = probe.kernel(*inputs)
            torch.cuda.synchronize()
            status[name] = tpu_probe_status(name, got, inputs)
        except Exception as e:  # a failed build or launch: report and go on
            status[name] = f"FAIL {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        print(f"{name}: {status[name]}", flush=True)
    return status


if __name__ == "__main__":
    result = run()
    print(json.dumps(result))
    sys.exit(0 if all(s == "OK" for s in result.values()) else 1)
