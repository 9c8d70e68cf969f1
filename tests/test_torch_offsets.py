"""The kernels' offset mode against the JAX package, in one process on the CPU.

A sequence shard owns query rows ``[q_start, q_start + S_q)`` against keys
``[k_start, k_start + S_k)`` (``pallas_attention.py``'s ``qoff``), and a
data-parallel shard's examples start at ``batch_start``.  The port's plain
versions and tiled schedules (``fused_attention``) take the same offsets
as JAX's ``_attention_forward`` / ``_attention_backward`` (Pallas in
interpret mode, 64-blocks as the kernels' tiles), here in the all-gather
form (S_q = S / 4 against all S keys) and in ring chunk pairs (S / 4 x S /
4), dense and windowed (window 48, 18 global tokens, as
``tests/test_window_attention.py:224``), at dropout 0 and 0.1 with a
nonzero ``batch_start``.

Compared: rows that are real and have a live key in the chunk (JAX leaves
the others' values to the logsumexp combine, which ignores them; the port
gives them o = 0 and lse = -inf, checked here too).  Tolerances: 2e-5 on o
and lse (``tests/test_torch_forward_schedule.py``), 3e-4 on the gradients
(``tests/test_torch_backward_schedule.py``); the backward runs each chunk
against the unsharded forward's lse and output, as the ring does.  The
dropout keep factors are bit-equal to ``_dropout_tile``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu_torch.ops import fused_attention as fa

FWD_TOL, GRAD_TOL = 2e-5, 3e-4
B, S, H, D, V = 3, 256, 2, 16, 24
BLOCK = 64
SEED, BATCH_START = 4242, 5
LENGTHS = [256, 150, 70]  # the last example is padding in the last two chunks
GEOMETRIES = {
    "dense": jax_pa.RelGeometry(5, 4, 1),
    "window": jax_pa.RelGeometry(5, 4, 1, window=48, num_global=18),
}
# (q_start, S_q, k_start, S_k): the all-gather form, then ring chunk pairs
# below, on and above the diagonal.
FORMS = {
    "all_gather": (128, 64, 0, 256),
    "ring_below": (128, 64, 64, 64),
    "ring_diagonal": (192, 64, 192, 64),
    "ring_above": (0, 64, 192, 64),
}


def _inputs(seed=17):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    table = rng.normal(size=(V, H, D)).astype(np.float32)
    return q, k, v, do, table, np.asarray(LENGTHS, np.int32)


def _offs(q_start, k_start, rate):
    return jnp.stack([jnp.int32(q_start), jnp.int32(k_start),
                      jnp.int32(SEED if rate else 0), jnp.int32(BATCH_START)])


def _jax_forward(q, k, v, table, geo, lengths, rate, q_start=0, k_start=0, batch_start=0):
    o, lse = jax_pa._attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), geo,
        jnp.asarray(lengths), BLOCK, BLOCK, True,
        q_start=jnp.int32(q_start) if q_start else 0,
        k_start=jnp.int32(k_start) if k_start else 0, dropout_rate=rate,
        dropout_seed=jnp.int32(SEED) if rate else None, batch_start=jnp.int32(batch_start))
    return np.asarray(o), np.asarray(lse)[..., 0]


def _live_rows(geo, lengths, q_start, seq_q, k_start, seq_k):
    """<bool>[B, S_q]: real rows with a live key in the chunk."""
    q_pos, k_pos = torch.arange(q_start, q_start + seq_q), torch.arange(k_start, k_start + seq_k)
    lengths = torch.from_numpy(lengths)
    empty = fa.empty_rows(fa.RelGeometry(**vars(geo)), lengths, q_pos, k_pos)
    return ((q_pos[None, :] < lengths[:, None]) & ~empty).numpy(), empty.numpy()


def _chunk(form):
    q_start, seq_q, k_start, seq_k = FORMS[form]
    return slice(q_start, q_start + seq_q), slice(k_start, k_start + seq_k)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_forward_with_offsets_matches_jax(form, geo_name, rate):
    geo = GEOMETRIES[geo_name]
    q, k, v, _, table, lengths = _inputs()
    qs, ks = _chunk(form)
    q_start, seq_q, k_start, seq_k = FORMS[form]
    want_o, want_lse = _jax_forward(q[:, qs], k[:, ks], v[:, ks], table, geo, lengths, rate,
                                    q_start, k_start, BATCH_START)
    live, empty = _live_rows(geo, lengths, q_start, seq_q, k_start, seq_k)
    args = [torch.from_numpy(x) for x in (q[:, qs], k[:, ks], v[:, ks], table)]
    port_geo = fa.RelGeometry(**vars(geo))
    for fn in (fa.relative_attention_plain, fa.relative_attention_forward_tiled):
        o, lse = fn(*args, port_geo, torch.from_numpy(lengths), rate, SEED if rate else None,
                    q_start, k_start, BATCH_START)
        o, lse = o.numpy(), lse.numpy()
        for b in range(B):
            rows = live[b]
            np.testing.assert_allclose(o[b, rows], want_o[b, rows], atol=FWD_TOL, rtol=FWD_TOL,
                                       err_msg=f"{fn.__name__} o, example {b}")
            np.testing.assert_allclose(lse[b][:, rows], want_lse[b][:, rows], atol=FWD_TOL,
                                       rtol=FWD_TOL, err_msg=f"{fn.__name__} lse, example {b}")
            assert np.all(o[b, empty[b]] == 0) and np.all(lse[b][:, empty[b]] == -np.inf)
    if form == "ring_above":  # keys past example 1's length: its real rows are empty
        assert empty[1].all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
@pytest.mark.parametrize("form", ["all_gather", "ring_below", "ring_above"])
def test_backward_with_offsets_matches_jax(form, geo_name, rate):
    geo = GEOMETRIES[geo_name]
    q, k, v, do, table, lengths = _inputs(seed=23)
    real = np.arange(S)[None, :] < lengths[:, None]
    do = do * real[:, :, None, None]
    qs, ks = _chunk(form)
    q_start, seq_q, k_start, seq_k = FORMS[form]
    # The unsharded forward's output and lse: the ring's global statistics.
    out, lse = _jax_forward(q, k, v, table, geo, lengths, rate, batch_start=BATCH_START)
    residuals = (jnp.asarray(q[:, qs]), jnp.asarray(k[:, ks]), jnp.asarray(v[:, ks]),
                 jnp.asarray(table), jnp.asarray(lengths), _offs(q_start, k_start, rate),
                 jnp.asarray(out[:, qs]), jnp.asarray(lse[:, :, qs])[..., None])
    want = jax_pa._attention_backward(residuals, jnp.asarray(do[:, qs]), geo, BLOCK, BLOCK,
                                      True, dropout_rate=rate)[:4]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q[:, qs], k[:, ks], v[:, ks], do[:, qs]))
    t_out, t_lse = torch.from_numpy(out[:, qs].copy()), torch.from_numpy(lse[:, :, qs].copy())
    delta = torch.einsum("bshd,bshd->bhs", tdo, t_out)
    port_geo = fa.RelGeometry(**vars(geo))
    for fn in (fa.relative_attention_backward_plain, fa.relative_attention_backward_tiled):
        got = fn(tq, tk, tv, tdo, t_lse, delta, torch.from_numpy(table), port_geo,
                 torch.from_numpy(lengths), rate, SEED if rate else None, q_start, k_start,
                 BATCH_START)
        for name, g, ref, pos0 in zip(("dq", "dk", "dv"), got, want, (q_start, k_start, k_start)):
            for b, n in enumerate(LENGTHS):
                rows = np.arange(pos0, pos0 + g.shape[1]) < n
                np.testing.assert_allclose(g[b, rows].numpy(), np.asarray(ref)[b, rows],
                                           atol=GRAD_TOL, rtol=GRAD_TOL,
                                           err_msg=f"{fn.__name__} {name}, example {b}")
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"{fn.__name__} drel")


@pytest.mark.parametrize("form", sorted(FORMS))
def test_dropout_masks_with_offsets_are_the_hash(form):
    q_start, seq_q, k_start, seq_k = FORMS[form]
    rows = torch.arange(BATCH_START, BATCH_START + B)
    got = fa._dropout_block(SEED, rows, H, torch.arange(q_start, q_start + seq_q),
                            torch.arange(k_start, k_start + seq_k), 0.1).numpy()
    for b in range(B):
        for h in range(H):
            want = jax_pa._dropout_tile(jnp.int32(SEED), jnp.int32(BATCH_START + b),
                                        jnp.int32(h), jnp.int32(q_start), jnp.int32(k_start),
                                        (seq_q, seq_k), 0.1)
            np.testing.assert_array_equal(got[b, h], np.asarray(want))


def test_chunks_assemble_the_unsharded_forward():
    """The ring's chunk outputs, combined by logsumexp, and the all-gather
    shards, concatenated, give the unsharded plain forward on real rows."""
    from mmt_tpu_torch.ops import sharded_attention as sa

    q, k, v, _, table, lengths = (torch.from_numpy(x) for x in _inputs(seed=31))
    geo = fa.RelGeometry(**vars(GEOMETRIES["window"]))
    want_o, want_lse = fa.relative_attention_plain(q, k, v, table, geo, lengths, 0.1, SEED,
                                                   batch_start=BATCH_START)
    for fn in (sa.all_gather_shards, sa.ring_shards):
        o, lse = fn(q, k, v, table, geo, lengths, 4, BATCH_START, 0.1, SEED, "cpu")
        for b, n in enumerate(LENGTHS):
            np.testing.assert_allclose(o[b, :n].numpy(), want_o[b, :n].numpy(), atol=FWD_TOL,
                                       rtol=FWD_TOL, err_msg=fn.__name__)
            np.testing.assert_allclose(lse[b, :, :n].numpy(), want_lse[b, :, :n].numpy(),
                                       atol=FWD_TOL, rtol=FWD_TOL, err_msg=fn.__name__)


def test_live_tiles_in_a_chunk_visit_every_allowed_pair_once():
    geo = fa.RelGeometry(3, 4, 1, window=24, num_global=18)
    length = 450
    pos = torch.arange(512)
    allowed = fa.window_allowed(geo, pos[:, None], pos[None, :])
    for start, end in ((128, 320), (320, 512), (0, 64)):
        real_end = min(length, end)
        for k0 in range(0, length, fa.TILE):
            tiles = fa.live_tiles(k0, real_end, geo, start)
            assert tiles == sorted(set(tiles))
            for tile in range(start // 64, -(-real_end // 64)):
                block = allowed[tile * 64:(tile + 1) * 64, k0:k0 + 64]
                assert (tile in tiles) == bool(block.any()), (start, k0, tile)
            assert all(start // 64 <= t < -(-real_end // 64) for t in tiles)


def test_kernel_offsets_must_be_tile_multiples():
    q = torch.zeros(1, 64, H, D)
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.relative_attention_forward_tiled(q, q, q, None, None, torch.tensor([64]),
                                            q_start=32)
    with pytest.raises(ValueError, match=">= 0"):
        fa.relative_attention_plain(q, q, q, None, None, torch.tensor([64]), k_start=-64)
