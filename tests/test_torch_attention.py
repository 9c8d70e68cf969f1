"""The port's relative attention against the JAX package.

``relative_attention_plain`` (what the fused wrapper runs on CPU tensors)
is held at float32 against JAX's dense ``relative_attention_scores`` +
mask + softmax and against the Pallas kernel in interpret mode through
both of its forward schedules: the rectangular grid (K1 ``_fwd_kernel``)
and the far/structured split (K2 ``_fwd_list_kernel`` + logsumexp
combine).  Tolerance 2e-5 (atol = rtol): float32 sums in another order,
and the split schedule combines two partial softmaxes.  Only real rows
are compared: pad-row outputs are unspecified (the kernels skip tiles
past the length).

The CUDA legs (the Hopper kernel against the plain version) are in
``test_torch_cuda.py``, which imports no JAX so that it runs on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu.ops.relative_attention_ref import gather_indexes as jax_gather_indexes
from mmt_tpu.ops.relative_attention_ref import relative_attention_scores as jax_scores
from mmt_tpu_torch.ops import relative_attention_ref as torch_ref
from mmt_tpu_torch.ops import fused_attention as fa

TOL = 2e-5


def _inputs(B, S, H, D, V, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    table = rng.normal(size=(V, H, D)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _plain(q, k, v, table, geo, lengths):
    o, lse = fa.relative_attention_forward(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(table) if table is not None else None, geo,
        torch.from_numpy(lengths), device="cpu")
    return o.numpy(), lse.numpy()


def _jax_dense(q, k, v, table, geo, lengths):
    S = q.shape[1]
    ids = jnp.asarray(fa.relative_att_ids(geo, S)) if geo is not None else None
    logits = jax_scores(jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(table) if geo is not None else None, ids)
    real = np.arange(S)[None, :] < lengths[:, None]
    mask = (real[:, :, None] == real[:, None, :]).astype(np.float32)
    logits = logits + (1.0 - mask[:, None]) * -10000.0
    o = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), jnp.asarray(v))
    return np.asarray(o), np.asarray(jax.nn.logsumexp(logits, axis=-1))


def _assert_real_rows(got, want, lengths):
    (o, lse), (o_ref, lse_ref) = got, want
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(o[b, :n], o_ref[b, :n], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(lse[b, :, :n], lse_ref[b, :, :n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("geo,V", [
    (jax_pa.RelGeometry(3, 4, 1), 12),
    # part ids 31/32 in vocabulary: the learned cross-part bias applies
    (jax_pa.RelGeometry(3, 4, 1), 33),
    # the flagship geometry: part ids 229/230 out of vocabulary -> zero bias
    (jax_pa.RelGeometry(12, 14, 1), 49),
    (jax_pa.RelGeometry(5), 11),
    (None, 1),
], ids=["2d", "2d_parts_in_vocab", "flagship_2d", "1d", "no_rel"])
def test_plain_matches_jax_dense(geo, V):
    if geo is not None and V == 33:
        assert geo.text_part_id + 1 == V
    args = _inputs(2, 256, 2, 16, V, [256, 173])
    port_geo = fa.RelGeometry(**vars(geo)) if geo is not None else None
    _assert_real_rows(_plain(*args[:4], port_geo, args[4]),
                      _jax_dense(*args[:4], port_geo, args[4]), args[4])


@pytest.mark.parametrize("block,split", [(32, False), (16, True)], ids=["k1_rect", "k2_split"])
def test_plain_matches_pallas_interpret(block, split):
    geo = jax_pa.RelGeometry(text_max_distance=3, num_patch_per_row=4, num_core_layers=1)
    S = 256
    meta = jax_pa._build_tile_meta(geo, S, block, block)
    far = float((meta[3] != 2).mean())
    # The schedule switches to the split at >= 60% far tiles.
    assert (far >= 0.6) == split, far
    q, k, v, table, lengths = _inputs(2, S, 2, 16, 12, [256, 150], seed=1)
    o, lse = jax_pa._attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), geo,
        jnp.asarray(lengths), block, block, True)
    want = (np.asarray(o), np.asarray(lse)[..., 0])
    got = _plain(q, k, v, table, fa.RelGeometry(**vars(geo)), lengths)
    _assert_real_rows(got, want, lengths)


def test_wrapper_rejects_window_and_device_mismatch():
    """JAX's validation of the pattern (``tests/test_window_attention.py:
    test_window_requires_rel_and_global``): window > 0 needs the table and
    num_global > 0."""
    q = torch.zeros(1, 8, 1, 4)
    table = torch.zeros(25, 1, 4)
    lengths = torch.full((1,), 8)
    for fn in (fa.relative_attention_forward, fa.relative_attention):
        with pytest.raises(ValueError, match="num_global"):
            fn(q, q, q, table, fa.RelGeometry(5, window=4, num_global=0), lengths, device="cpu")
        with pytest.raises(ValueError, match="rel_table"):
            fn(q, q, q, None, fa.RelGeometry(5, window=4, num_global=2), lengths, device="cpu")
    with pytest.raises(ValueError, match="num_global"):
        fa.relative_attention_plain(q, q, q, table, fa.RelGeometry(5, window=4), lengths)
    with pytest.raises(ValueError):
        fa.relative_attention_forward(q, q, q, None, None, lengths, device="cuda")


def test_gather_indexes_equal():
    rng = np.random.default_rng(2)
    seq = rng.normal(size=(2, 10, 6)).astype(np.float32)
    pos = rng.integers(0, 10, (2, 4)).astype(np.int32)
    want = np.asarray(jax_gather_indexes(jnp.asarray(seq), jnp.asarray(pos)))
    got = torch_ref.gather_indexes(torch.from_numpy(seq), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)
