"""The port's attention dropout and backward against the JAX package.

* ``dropout_keep`` / ``dropout_tile`` are bit-exact to the JAX hash
  (``_dropout_keep`` / ``_dropout_tile``).
* ``relative_attention_plain`` with dropout matches
  ``pallas_relative_attention(..., interpret=True, dropout_rate=0.1)`` in
  float32 at 2e-5 (atol = rtol) on real rows: float32 sums in another
  order.
* ``relative_attention_backward_plain`` and the autograd Function on the
  CPU match ``jax.grad`` through the Pallas interpret kernels for dq, dk,
  dv and drel at 3e-4 (atol = rtol, the bound of
  ``tests/test_pallas_backward.py:_compare``), with and without dropout,
  and torch autograd through ``relative_attention_plain`` at 1e-5 on real
  rows.  The loss weights only real rows, as the JAX tests do (pad-row
  outputs are unspecified).

Shapes: B=2, S=128 with 64-blocks (two tiles in each direction), H=2,
D=16, lengths [128, 90].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu_torch.ops import fused_attention as fa

FWD_TOL, BWD_TOL = 2e-5, 3e-4
B, S, H, D, BLOCK = 2, 128, 2, 16, 64
LENGTHS = [128, 90]
SEED = -123456789
GEOMETRIES = {
    "2d": (jax_pa.RelGeometry(text_max_distance=3, num_patch_per_row=4, num_core_layers=1), 24),
    "1d": (jax_pa.RelGeometry(text_max_distance=7), 15),
}


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 7, -1, -(2**31), 2**31 - 1, 123456789])
def test_dropout_hash_is_bit_exact(seed, rate):
    heads = np.arange(12, dtype=np.int32)[:, None, None]
    i = np.arange(0, 8192, 37, dtype=np.int32)[None, :, None]
    j = np.arange(5, 8192, 41, dtype=np.int32)[None, None, :]
    want = np.asarray(jax_pa._dropout_keep(jnp.int32(seed), jnp.asarray(heads), jnp.asarray(i),
                                           jnp.asarray(j), rate))
    got = fa.dropout_keep(seed, torch.from_numpy(heads), torch.from_numpy(i),
                          torch.from_numpy(j), rate).numpy()
    np.testing.assert_array_equal(got, want)
    want_tile = np.asarray(jax_pa._dropout_tile(jnp.int32(seed), jnp.int32(5), jnp.int32(11),
                                                jnp.int32(8064), jnp.int32(4096), (128, 96), rate))
    got_tile = fa.dropout_tile(seed, 5, 11, 8064, 4096, (128, 96), rate).numpy()
    np.testing.assert_array_equal(got_tile, want_tile)


def _inputs(V, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    table = rng.normal(size=(V, H, D)).astype(np.float32)
    real = (np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None])[:, :, None, None]
    w = (rng.normal(size=(B, S, H, D)) * real).astype(np.float32)
    return q, k, v, table, np.asarray(LENGTHS, np.int32), w


def _jax_attention(q, k, v, table, geo, lengths, rate):
    return jax_pa.pallas_relative_attention(
        q, k, v, table, geo, lengths, block_q=BLOCK, block_k=BLOCK, interpret=True,
        dropout_rate=rate, dropout_seed=jnp.int32(SEED) if rate else None)


@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
def test_plain_forward_with_dropout_matches_pallas(geo_name):
    geo, V = GEOMETRIES[geo_name]
    q, k, v, table, lengths, _ = _inputs(V)
    want = np.asarray(_jax_attention(*(jnp.asarray(x) for x in (q, k, v, table)), geo,
                                     jnp.asarray(lengths), 0.1))
    got, _ = fa.relative_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, table)), fa.RelGeometry(**vars(geo)),
        torch.from_numpy(lengths), 0.1, SEED)
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], atol=FWD_TOL, rtol=FWD_TOL)


def test_missing_seed_raises():
    q = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.relative_attention(q, q, q, None, None, torch.full((1,), 8), 0.1, device="cpu")
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.relative_attention_plain(q, q, q, None, None, torch.full((1,), 8), 0.1)


_JAX_GRADS = {}


def _jax_grads(geo_name, rate):
    """jax.grad of sum(out * w) through the Pallas interpret kernels,
    computed once per case (interpret mode takes seconds)."""
    key = (geo_name, rate)
    if key not in _JAX_GRADS:
        geo, V = GEOMETRIES[geo_name]
        q, k, v, table, lengths, w = _inputs(V)

        def loss(q, k, v, table):
            out = _jax_attention(q, k, v, table, geo, jnp.asarray(lengths), rate)
            return jnp.sum(out * w)

        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, table)))
        _JAX_GRADS[key] = [np.asarray(g) for g in grads]
    return _JAX_GRADS[key]


def _torch_case(geo_name):
    geo, V = GEOMETRIES[geo_name]
    q, k, v, table, lengths, w = _inputs(V)
    return ([torch.from_numpy(x) for x in (q, k, v, table)], fa.RelGeometry(**vars(geo)),
            torch.from_numpy(lengths), torch.from_numpy(w))


def _assert_real_rows(got, want, tol):
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else g
        if name == "drel":
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)
            continue
        for b, n in enumerate(LENGTHS):
            np.testing.assert_allclose(g[b, :n], w[b, :n], atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
def test_plain_backward_matches_jax_grad(geo_name, rate):
    (q, k, v, table), geo, lengths, w = _torch_case(geo_name)
    seed = SEED if rate else None
    o, lse = fa.relative_attention_plain(q, k, v, table, geo, lengths, rate, seed)
    delta = torch.einsum("bshd,bshd->bhs", w, o)
    got = fa.relative_attention_backward_plain(q, k, v, w, lse, delta, table, geo, lengths,
                                               rate, seed)
    _assert_real_rows(got, _jax_grads(geo_name, rate), BWD_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
def test_function_matches_jax_grad_and_autograd(geo_name, rate):
    (q, k, v, table), geo, lengths, w = _torch_case(geo_name)
    seed = SEED if rate else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    out = fa.relative_attention(*leaves, geo, lengths, rate, seed, device="cpu")
    got = torch.autograd.grad((out * w).sum(), leaves)
    _assert_real_rows(got, _jax_grads(geo_name, rate), BWD_TOL)

    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    out_plain, _ = fa.relative_attention_plain(*leaves, geo, lengths, rate, seed)
    want = torch.autograd.grad((out_plain * w).sum(), leaves)
    _assert_real_rows(got, [t.numpy() for t in want], 1e-5)


def test_function_without_table_and_pad_rows_are_zero():
    (q, k, v, _), _, lengths, w = _torch_case("1d")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.relative_attention(*leaves, None, None, lengths, device="cpu")
    grads = torch.autograd.grad((out * w).sum(), leaves)
    for g in grads:
        assert torch.all(g[1, LENGTHS[1]:] == 0)
    jax_grads = jax.grad(
        lambda q, k, v: jnp.sum(jax_pa.pallas_relative_attention(
            q, k, v, None, None, jnp.asarray(LENGTHS, jnp.int32), block_q=BLOCK,
            block_k=BLOCK, interpret=True) * w.numpy()), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, want in zip(grads, jax_grads):
        for b, n in enumerate(LENGTHS):
            np.testing.assert_allclose(g[b, :n].numpy(), np.asarray(want)[b, :n],
                                       atol=BWD_TOL, rtol=BWD_TOL)


def test_launchers_refuse_grad_and_wrong_device():
    q = torch.zeros(1, 8, 1, 4, requires_grad=True)
    lengths = torch.full((1,), 8)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.relative_attention_forward(q, q, q, None, None, lengths, device="cpu")
    x = torch.zeros(1, 8, 1, 4)
    stats = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="expected cuda"):
        fa.relative_attention_backward(x, x, x, x, stats, stats, None, None, lengths)
