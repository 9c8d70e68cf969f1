"""The mosaic probe's plain versions on the CPU, against the TPU probe.

``scripts/mosaic_probe.py`` runs six Pallas kernels (P3); each test here
runs the script's own kernel body in interpret mode on the CPU (its
``pl.pallas_call`` replaced by one with ``interpret=True`` that records
the array it returns) and holds the port's plain version
(``mmt_tpu_torch.probes.mosaic_probe``) to it:

* on the script's own inputs (``np.arange``, ``rng(0)``, off = 36, s = 5),
  where the script's own check must pass too;
* on seeded inputs at other scalars (off 0, 36, 192; s 0, 5, 255, -3), fed
  to the same bodies in place of the script's.

Copies are exact; the product within 1e-4 (JAX's fp32 dot sums 128
products in fp32, the plain version in float64).  ``probe_strided_roll``
names ``pltpu.roll``'s ``stride_dimension``, which this JAX calls
``stride_axis``: its test runs the same body with the new keyword.

Beside that: a batched plain call equals the stacked single calls, the
kernel's bf16 hi + lo split of the product (``small_matmul_split``) is
within the TPU probe's atol of 1e-3 and one bf16 product is not, the
product kernel's schedule emulated in plain PyTorch gives the split's
product (1e-4: its fp32 sums round at every step), each
library yardstick computes the plain version's function, and the kernel
wrappers raise on CPU tensors without launching anything.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mmt_tpu_torch.probes import mosaic_probe as mp

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "mosaic_probe.py"
MATMUL_VS_JAX = 1e-4
# The scalar probes at other offsets: off at both range ends, s negative and
# past the row.
OTHER_INPUTS = [("strided_roll", None), ("static_unaligned_store", None),
                ("many_static_stores", None), ("dynamic_lane_store", 0),
                ("dynamic_lane_store", 36), ("dynamic_lane_store", 192),
                ("uniform_dynamic_roll", 0), ("uniform_dynamic_roll", 5),
                ("uniform_dynamic_roll", 255), ("uniform_dynamic_roll", -3),
                ("small_matmul", None)]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("tpu_mosaic_probe", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _InterpretPallas:
    """``pl`` for the script: ``pallas_call`` in interpret mode, recording
    each output (and calling it on ``args`` in place of the script's own
    arguments, when given); everything else is Pallas's."""

    def __init__(self, args=None):
        self.args, self.outputs = args, []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, kernel, **kwargs):
        call = pl.pallas_call(kernel, interpret=True, **kwargs)

        def run(*args):
            out = call(*(args if self.args is None else self.args))
            self.outputs.append(np.asarray(out))
            return out

        return run


def strided_roll_body(x_ref, o_ref):
    """``probe_strided_roll``'s kernel with ``stride_axis`` for
    ``stride_dimension``."""
    o_ref[...] = pltpu.roll(x_ref[...], 0, 1, stride=1, stride_axis=0)


def jax_output(script, monkeypatch, name, inputs=None):
    """The array probe ``name``'s pallas_call returns in interpret mode on
    the script's inputs, or on ``inputs`` (torch tensors of one instance,
    scalars first as the script passes them), and the script's own
    verdict."""
    if name == "strided_roll":
        x = np.arange(64 * 256, dtype=np.float32).reshape(64, 256) if inputs is None \
            else inputs[0][0].numpy()
        out = pl.pallas_call(strided_roll_body, interpret=True,
                             out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(jnp.asarray(x))
        out = np.asarray(out)
        return out, np.array_equal(out, np.stack([np.roll(x[i], i) for i in range(64)]))
    args = None
    if inputs is not None:
        tensors = [t[0] if t.dim() > 1 else t for t in inputs]
        if len(tensors) == 2 and tensors[1].dtype == torch.int32:  # (x, scalar)
            tensors = tensors[::-1]
        args = tuple(jnp.asarray(t.numpy()) for t in tensors)
    fake = _InterpretPallas(args)
    monkeypatch.setattr(script, "pl", fake)
    verdict = getattr(script, f"probe_{name}")()
    assert len(fake.outputs) == 1
    return fake.outputs[0], verdict


def assert_plain_equals_jax(name, got, want):
    if name == "small_matmul":
        np.testing.assert_allclose(got, want, rtol=0, atol=MATMUL_VS_JAX)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(mp.PROBES))
def test_plain_version_equals_jax_on_the_tpu_probe_inputs(script, monkeypatch, name):
    want, verdict = jax_output(script, monkeypatch, name)
    assert verdict, f"the script's own check of probe_{name} failed in interpret mode"
    inputs = mp.PROBES[name].tpu_inputs()
    got = mp.PROBES[name].plain(*inputs)
    assert got.shape[0] == 1 and got.dtype == torch.float32
    assert_plain_equals_jax(name, got[0].numpy(), want)
    assert mp.tpu_probe_status(name, got, inputs) == "OK"


@pytest.mark.parametrize("name,scalar", OTHER_INPUTS,
                         ids=[f"{n}-{s}" if s is not None else n for n, s in OTHER_INPUTS])
def test_plain_version_equals_jax_at_other_inputs(script, monkeypatch, name, scalar):
    probe = mp.PROBES[name]
    rng = np.random.default_rng(11)
    inputs = probe.seeded(rng, 1) if scalar is None else probe.seeded(rng, 1, scalar)
    want, _ = jax_output(script, monkeypatch, name, inputs)
    assert_plain_equals_jax(name, probe.plain(*inputs)[0].numpy(), want)


@pytest.mark.parametrize("name", list(mp.PROBES))
def test_batched_plain_equals_stacked_single_calls(name):
    probe = mp.PROBES[name]
    inputs = probe.seeded(np.random.default_rng(3), 3)
    batched = probe.plain(*inputs)
    singles = [probe.plain(*(t[b:b + 1] if t.dim() > 1 else t for t in inputs))
               for b in range(3)]
    assert torch.equal(batched, torch.cat(singles))


def test_matmul_split_within_the_tpu_gate(script, monkeypatch):
    """The kernel's arithmetic (bf16 hi + lo, three products) meets the TPU
    probe's atol of 1e-3 against JAX's product on the script's inputs; one
    bf16 product does not."""
    want, _ = jax_output(script, monkeypatch, "small_matmul")
    x, w = mp.PROBES["small_matmul"].tpu_inputs()
    split = mp.small_matmul_split(x, w)[0].numpy()
    split_err = np.abs(split - want).max()
    assert split_err <= mp.MATMUL_ATOL / 2, split_err
    one_bf16 = torch.bmm(x.bfloat16().double(), w.bfloat16().double()).float()[0].numpy()
    assert np.abs(one_bf16 - want).max() > mp.MATMUL_ATOL
    hi, lo = mp.split_bf16(x)
    assert torch.equal(hi, hi.bfloat16().float()) and torch.equal(lo, lo.bfloat16().float())
    assert (x - hi - lo).abs().max() <= x.abs().max() * 2.0**-16


# The kernel's fp32 sum of 24 rounded steps against the split's one rounding:
# a few fp32 spacings of sums of |x . w| ~ 40.
SCHEDULE_VS_SPLIT = 1e-4


@pytest.mark.parametrize("batch,grid", [(1, 1), (3, 3), (7, 3), (9, 4)])
def test_matmul_schedule_emulation_equals_split(batch, grid):
    """The product kernel's walk in plain PyTorch: each block's instances
    (w, then x's four 64-row blocks) cover every instance and block once,
    w's rows sit at the k where the wgmma A registers put x's columns, and
    lo.hi + hi.lo per step, then hi.hi, gives the split's product."""
    items = [(inst, part) for _, _, inst, part in mp.small_matmul_schedule(batch, grid)]
    assert sorted(items) == [(i, p) for i in range(batch) for p in range(mp.MM_ITEMS)]
    for block in range(grid):  # in order: w, then the blocks, per instance
        walk = [(inst, part) for b, _, inst, part in mp.small_matmul_schedule(batch, grid)
                if b == block]
        assert walk == [(i, p) for i in range(block, batch, grid) for p in range(mp.MM_ITEMS)]
    ks = torch.tensor([mp.small_matmul_k(p) for p in range(mp.MM_X[1])])
    assert torch.equal(ks.sort().values, torch.arange(mp.MM_X[1]))
    assert torch.equal(mp._a_columns()[ks], torch.arange(mp.MM_X[1]))
    x, w = mp.PROBES["small_matmul"].seeded(np.random.default_rng(batch), batch)
    got = mp.small_matmul_emulated(x, w, grid)
    assert (got - mp.small_matmul_split(x, w)).abs().max() <= SCHEDULE_VS_SPLIT
    assert (got - mp.small_matmul_plain(x, w)).abs().max() <= mp.MATMUL_ATOL


def test_library_calls_compute_the_plain_function():
    rng = np.random.default_rng(5)
    for name, probe in mp.PROBES.items():
        inputs = probe.seeded(rng, 2)
        call = mp.library_call(name, inputs)
        if name == "many_static_stores":
            assert call is None
            continue
        got, want = call(), probe.plain(*inputs)
        if probe.atol:
            assert (got - want).abs().max() <= MATMUL_VS_JAX, name
        else:
            assert torch.equal(got, want), name


def test_dynamic_store_plain_refuses_an_offset_outside_the_tile():
    x = mp.PROBES["dynamic_lane_store"].seeded(np.random.default_rng(0), 1)[0]
    for off in (-1, 193):
        with pytest.raises(ValueError, match="outside"):
            mp.dynamic_lane_store_plain(x, mp._scalar(off))
        with pytest.raises(ValueError, match="outside"):
            mp.library_call("dynamic_lane_store", (x, mp._scalar(off)))


def test_tpu_probe_status_flags_a_wrong_result():
    for name, probe in mp.PROBES.items():
        inputs = probe.tpu_inputs()
        wrong = probe.plain(*inputs).clone()
        wrong[0, 9, 21] += 0.5  # an element of every probe's output
        assert mp.tpu_probe_status(name, wrong, inputs) == "WRONG RESULT", name


def test_kernel_wrappers_raise_on_cpu_tensors():
    for name, probe in mp.PROBES.items():
        inputs = probe.tpu_inputs()
        with pytest.raises(ValueError, match="run on CUDA tensors only"):
            probe.kernel(*inputs)
    assert all(count == 0 for count in mp.launches.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mp.run()
