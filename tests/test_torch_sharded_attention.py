"""The sequence-sharded schedules over ``gloo`` against the JAX package's.

``ops/sharded_attention.py``'s ``sequence_sharded_relative_attention``
(K / V all-gather) and ``ring_sequence_sharded_relative_attention`` run on 8
CPU processes, a (2 data, 4 sequence) mesh as the JAX tests' ``create_mesh
(num_data=2, num_model=4)`` (``parallel.launch.run_local``; the ranks'
code is ``tests/torch_gloo_workers.py``).  The references are JAX's
``sequence_sharded_pallas_attention`` / ``ring_sequence_sharded_pallas_attention``
on the 8-device virtual mesh of ``tests/conftest.py``, Pallas in interpret
mode, with the shapes of ``tests/test_pallas_attention.py:247-322`` and
``tests/test_pallas_backward.py:104-175``: the output (real rows) within
2e-5 (all-gather) / 3e-5 (ring), the gradients of sum(out * w) with
respect to q, k, v and the relative table within 5e-4 (JAX's own bounds for
its sharded gradients).  The table's gradient is summed over every rank,
as JAX's ``shard_map`` transpose sums it.  The no-bias, windowed and
dropout cases (the ring's dropout against JAX's single kernel, as
``tests/test_pallas_dropout.py:150``) are slow: their JAX references take
long in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmt_tpu.ops.pallas_attention import (
    RelGeometry,
    pallas_relative_attention,
    ring_sequence_sharded_pallas_attention,
    sequence_sharded_pallas_attention,
)
from mmt_tpu.parallel import create_mesh
from mmt_tpu_torch.parallel.launch import run_local
from tests import torch_gloo_workers

NUM_DATA, NUM_SEQ = 2, 4
H, D, V = 2, 16, 24
GEO = RelGeometry(text_max_distance=5, num_patch_per_row=4, num_core_layers=1)
WINDOW_GEO = RelGeometry(text_max_distance=5, num_patch_per_row=4, num_core_layers=1,
                         window=48, num_global=18)
RATE, SEED = 0.1, 7
# name: (schedule, geometry or None, S, lengths, block_q, block_k, rate, fwd tol, seed)
FAST = {
    "all_gather": ("all_gather", GEO, 256, [256, 200], 32, 64, 0.0, 2e-5, 21),
    "ring": ("ring", GEO, 256, [256, 190], 32, 32, 0.0, 3e-5, 23),
}
SLOW = {
    "all_gather_no_rel": ("all_gather", None, 128, [128, 90], 32, 32, 0.0, 2e-5, 12),
    "ring_window": ("ring", WINDOW_GEO, 256, [256, 200], 32, 32, 0.0, 3e-5, 11),
    "ring_dropout": ("ring", GEO, 256, [256, 170], 32, 32, RATE, 3e-5, 31),
}
GRAD_TOL = 5e-4


def _inputs(S, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(NUM_DATA, S, H, D)).astype(np.float32) for _ in range(3))
    table = rng.normal(size=(V, H, D)).astype(np.float32) * 0.5
    real = (np.arange(S)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    w = np.arange(NUM_DATA * S * H * D, dtype=np.float32).reshape(NUM_DATA, S, H, D) * 1e-4
    return q, k, v, table, w * real[:, :, None, None]


def _jax_reference(schedule, geo, S, lengths, block_q, block_k, rate, seed):
    """JAX's sharded wrapper: the output and the gradients of sum(out * w)
    (with dropout, the output of JAX's single kernel too)."""
    q, k, v, table, w = _inputs(S, lengths, seed)
    lens = jnp.asarray(lengths, jnp.int32)
    mesh = create_mesh(num_data=NUM_DATA, num_model=NUM_SEQ)
    fn = (ring_sequence_sharded_pallas_attention if schedule == "ring"
          else sequence_sharded_pallas_attention)
    kw = dict(mesh=mesh, block_q=block_q, block_k=block_k, interpret=True, dropout_rate=rate,
              dropout_seed=jnp.int32(SEED) if rate else None)

    def sharded(q, k, v, t):
        return fn(q, k, v, t if geo is not None else None, geo, lens, **kw)

    with mesh:
        out = jax.jit(sharded)(q, k, v, table)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(sharded(*a) * w), argnums=(0, 1, 2, 3)))(
            q, k, v, table)
    ref = {"o": np.asarray(out), "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]),
           "dv": np.asarray(grads[2]), "drel": np.asarray(grads[3]) if geo is not None else None}
    if rate:
        ref["single"] = np.asarray(pallas_relative_attention(
            q, k, v, table, geo, lens, block_q=64, block_k=64, interpret=True,
            dropout_rate=rate, dropout_seed=jnp.int32(SEED)))
    case = {"schedule": schedule, "q": q, "k": k, "v": v, "w": w,
            "lengths": np.asarray(lengths, np.int32), "rate": rate,
            "seed": SEED if rate else None,
            "table": table if geo is not None else None,
            "geometry": dict(vars(geo)) if geo is not None else None}
    return case, ref


def _run(cases, tmp_path):
    refs, inputs = {}, {}
    for name, spec in cases.items():
        inputs[name], refs[name] = _jax_reference(*spec[:7], spec[8])
    path = str(tmp_path / "cases.npz")
    np.savez(path, cases=np.asarray(inputs, dtype=object))
    ranks = run_local(torch_gloo_workers.sharded_attention_cases, NUM_DATA * NUM_SEQ, path,
                      NUM_DATA, NUM_SEQ)
    return inputs, refs, ranks


def _assemble(ranks, name, key):
    """The ranks' [B / 2, S / 4, ...] pieces -> the global array."""
    rows = []
    for d in range(NUM_DATA):
        rows.append(np.concatenate([ranks[d * NUM_SEQ + m][name][key] for m in range(NUM_SEQ)],
                                   axis=1))
    return np.concatenate(rows, axis=0)


@pytest.fixture(scope="module")
def fast(tmp_path_factory):
    return _run(FAST, tmp_path_factory.mktemp("sharded_fast"))


@pytest.fixture(scope="module")
def slow(tmp_path_factory):
    return _run(SLOW, tmp_path_factory.mktemp("sharded_slow"))


def _check(results, cases, name):
    inputs, refs, ranks = results
    case, ref = inputs[name], refs[name]
    fwd_tol = cases[name][7]
    real = (np.arange(case["q"].shape[1])[None] < case["lengths"][:, None])[:, :, None, None]
    o = _assemble(ranks, name, "o")
    np.testing.assert_allclose(o * real, ref["o"] * real, atol=fwd_tol, rtol=fwd_tol,
                               err_msg=f"{name} output")
    if "single" in ref:
        np.testing.assert_allclose(o * real, ref["single"] * real, atol=fwd_tol, rtol=fwd_tol,
                                   err_msg=f"{name} output against the single kernel")
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(_assemble(ranks, name, key), ref[key], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"{name} {key}")
    if ref["drel"] is not None:
        for rank in ranks:  # every rank holds the global sum
            np.testing.assert_allclose(rank[name]["drel"], ref["drel"], atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=f"{name} drel")


@pytest.mark.parametrize("name", sorted(FAST))
def test_sharded_schedule_matches_jax(fast, name):
    _check(fast, FAST, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SLOW))
def test_sharded_schedule_matches_jax_slow_cases(slow, name):
    _check(slow, SLOW, name)
