"""The forward kernel's decomposition against the JAX package, on the CPU.

``csrc/rel_attention_fwd.cu`` computes the attention forward per 64-row
query block over the block's live key tiles (``live_tiles``), with the bias
decided once per tile (``uniform_tile_id``: one id for the whole tile, or
per-pair ids from the image offset table and the clipped text offset), the
length and window terms only on the tiles they cut, an online softmax in
base 2, and the dropout keep factor after the row sum.
``relative_attention_forward_tiled`` is that schedule in plain PyTorch; no
card runs here, so this file holds its algebra, and the card holds the
kernel against the plain version (``tests/test_torch_cuda.py``).

References:

* the Pallas kernels in interpret mode through ``_attention_forward``, with
  64-blocks as the kernel's tiles: K1 ``_fwd_kernel`` on the rect grid
  (``MMT_ATTN_SPLIT=0``), K2 ``_fwd_list_kernel`` through the far /
  structured split with its logsumexp combine (``MMT_ATTN_SPLIT=1``), and
  K2 over the sliding-window live-tile list when the geometry has a window
  (the flagship geometry's image part needs 256-blocks there);
* JAX's dense path: ``relative_attention_scores``, the length mask, the
  window term, softmax and logsumexp (the dropout keep factors of
  ``_dropout_keep`` after the softmax).

Tolerance 2e-5 (atol = rtol) on real rows of o and lse, the bound of
``tests/test_torch_attention.py``: float32 on both sides, sums in another
order, and the kernel's schedule works in base 2.  Query blocks past a
length must give o = 0 and lse = -inf.

The last tests check ``uniform_tile_id`` exhaustively: every tile it calls
one-id holds one id in ``relative_att_ids``, and the tiles it leaves to the
per-pair path are the ones whose ids vary or that meet the image corner.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu.ops.relative_attention_ref import relative_attention_scores as jax_scores
from mmt_tpu_torch.ops import fused_attention as fa

TOL = 2e-5
H, D, BLOCK = 2, 16, 64
SEED = 97531
GEOMETRIES = {
    "2d": (jax_pa.RelGeometry(3, 4, 1), 12),
    # part ids 31/32 in vocabulary: the image x text tiles add a bias
    "2d_parts_in_vocab": (jax_pa.RelGeometry(3, 4, 1), 33),
    # the flagship geometry: a 196-slot image corner over 4 x 4 tiles, part
    # ids 229/230 out of vocabulary
    "flagship": (jax_pa.RelGeometry(12, 14, 1), 49),
    "1d": (jax_pa.RelGeometry(5), 11),
    "no_rel": (None, 1),
}
# (sequence length, lengths): full and partial tiles, far text tiles on
# both sides of the diagonal; one example shorter than a tile beside a
# fully padded one.
LAYOUTS = {"full_and_short": (384, [384, 241]), "short_and_empty": (256, [37, 0])}


def _inputs(seq_len, lengths, vocab, seed=5):
    rng = np.random.default_rng(seed)
    shape = (len(lengths), seq_len, H, D)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    table = rng.normal(size=(vocab, H, D)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _port_geo(geo):
    return fa.RelGeometry(**vars(geo)) if geo is not None else None


def _tiled(q, k, v, table, geo, lengths, rate):
    o, lse = fa.relative_attention_forward_tiled(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(table) if geo is not None else None, _port_geo(geo),
        torch.from_numpy(lengths), rate, SEED if rate else None)
    return o.numpy(), lse.numpy()


def _pallas(q, k, v, table, geo, lengths, rate, block=BLOCK):
    o, lse = jax_pa._attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table) if geo is not None else None, geo, jnp.asarray(lengths),
        block, block, True, dropout_rate=rate,
        dropout_seed=jnp.int32(SEED) if rate else None)
    return np.asarray(o), np.asarray(lse)[..., 0]


def _jax_dense(q, k, v, table, geo, lengths, rate):
    seq_len = q.shape[1]
    port = _port_geo(geo)
    ids = jnp.asarray(fa.relative_att_ids(port, seq_len)) if geo is not None else None
    logits = jax_scores(jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(table) if geo is not None else None, ids)
    pos = np.arange(seq_len)
    real = pos[None, :] < lengths[:, None]
    pad = real[:, :, None] != real[:, None, :]
    logits = logits + pad[:, None] * -10000.0
    if geo is not None and geo.window > 0:
        allowed = fa.window_allowed(port, torch.from_numpy(pos[:, None]),
                                    torch.from_numpy(pos[None, :])).numpy()
        logits = logits + np.where(allowed, 0.0, -10000.0).astype(np.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    if rate:
        b = jnp.arange(len(lengths), dtype=jnp.int32)[:, None, None, None]
        seeds = jnp.int32(SEED) + b * jnp.int32(-1771729351)
        heads = jnp.arange(H, dtype=jnp.int32)[None, :, None, None]
        probs = probs * jax_pa._dropout_keep(seeds, heads, jnp.asarray(pos)[:, None],
                                             jnp.asarray(pos)[None, :], rate)
    o = jnp.einsum("bhqk,bkhd->bqhd", probs, jnp.asarray(v))
    return np.asarray(o), np.asarray(jax.nn.logsumexp(logits, axis=-1))


def _assert_matches(got, want, lengths):
    (o, lse), (o_ref, lse_ref) = got, want
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(o[b, :n], o_ref[b, :n], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(lse[b, :, :n], lse_ref[b, :, :n], atol=TOL, rtol=TOL)
        pad_blocks = -(-n // BLOCK) * BLOCK
        assert np.all(o[b, pad_blocks:] == 0)
        assert np.all(lse[b, :, pad_blocks:] == -np.inf)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
def test_tiled_forward_matches_jax_dense(geo_name, layout, rate):
    geo, vocab = GEOMETRIES[geo_name]
    seq_len, lengths = LAYOUTS[layout]
    args = _inputs(seq_len, lengths, vocab)
    _assert_matches(_tiled(*args[:4], geo, args[4], rate),
                    _jax_dense(*args[:4], geo, args[4], rate), lengths)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo_name", ["2d", "2d_parts_in_vocab", "1d"])
@pytest.mark.parametrize("split", ["0", "1"], ids=["k1_rect", "k2_split"])
def test_tiled_forward_matches_pallas(monkeypatch, split, geo_name, rate):
    monkeypatch.setenv("MMT_ATTN_SPLIT", split)
    geo, vocab = GEOMETRIES[geo_name]
    seq_len, lengths = LAYOUTS["full_and_short"]
    if split == "1":  # the split engages at >= 4 far tiles
        meta = jax_pa._build_tile_meta(geo, seq_len, BLOCK, BLOCK)
        assert int((meta[3] != 2).sum()) >= 4
    args = _inputs(seq_len, lengths, vocab, seed=6)
    _assert_matches(_tiled(*args[:4], geo, args[4], rate),
                    _pallas(*args[:4], geo, args[4], rate), lengths)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tiled_forward_matches_pallas_flagship(monkeypatch, rate):
    """The Pallas kernels need the 196-slot image part inside one of their
    tiles, so K1 runs here with 256-blocks; the port's schedule keeps its
    64-tiles, whose image corner spans 4 x 4 of them."""
    monkeypatch.setenv("MMT_ATTN_SPLIT", "0")
    geo, vocab = GEOMETRIES["flagship"]
    args = _inputs(256, [256, 213], vocab, seed=9)
    _assert_matches(_tiled(*args[:4], geo, args[4], rate),
                    _pallas(*args[:4], geo, args[4], rate, block=256), [256, 213])


# Sliding window with a global prefix: the 2D one cuts the image corner and
# the band, the 1D one starts mid-tile; and a short example beside an empty
# one.
WINDOWS = {
    "2d_w40": (dataclasses.replace(GEOMETRIES["2d"][0], window=40, num_global=18), 12,
               384, [384, 300]),
    "1d_w70": (jax_pa.RelGeometry(5, window=70, num_global=9), 11, 384, [384, 200]),
    "2d_short_and_empty": (dataclasses.replace(GEOMETRIES["2d"][0], window=40, num_global=18),
                           12, 256, [150, 0]),
}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_tiled_window_matches_pallas_list_and_dense(case, rate):
    geo, vocab, seq_len, lengths = WINDOWS[case]
    args = _inputs(seq_len, lengths, vocab, seed=7)
    got = _tiled(*args[:4], geo, args[4], rate)
    _assert_matches(got, _pallas(*args[:4], geo, args[4], rate), lengths)
    _assert_matches(got, _jax_dense(*args[:4], geo, args[4], rate), lengths)


def test_window_at_least_seq_is_dense():
    """At window >= S the windowed schedule visits the dense tiles in their
    order and adds no window term: the same numbers bit for bit."""
    geo, vocab = GEOMETRIES["flagship"]
    args = _inputs(384, [384, 241], vocab, seed=8)
    wide = dataclasses.replace(geo, window=384, num_global=198)
    for rate in (0.0, 0.1):
        dense = _tiled(*args[:4], geo, args[4], rate)
        windowed = _tiled(*args[:4], wide, args[4], rate)
        for a, b in zip(dense, windowed):
            np.testing.assert_array_equal(a, b)


def _check_uniform_tiles(geo, seq_len):
    ids = fa.relative_att_ids(geo, seq_len)
    n = -(-seq_len // fa.TILE)
    one_id = 0
    for qi in range(n):
        for ki in range(n):
            q0, k0 = qi * fa.TILE, ki * fa.TILE
            tile = ids[q0:q0 + fa.TILE, k0:k0 + fa.TILE]
            got = fa.uniform_tile_id(q0, k0, geo)
            if got >= 0:
                one_id += 1
                assert np.all(tile == got), (q0, k0, got)
            else:
                il = geo.image_len
                # Left to the per-pair path: the tile meets the image corner
                # (or straddles its edge) or holds more than one id.
                assert (q0 < il and k0 < il) or len(np.unique(tile)) > 1, (q0, k0)
    return one_id / n**2


@pytest.mark.parametrize("seq_len", [256, 1024, 4096])
def test_uniform_tile_id_flagship(seq_len):
    share = _check_uniform_tiles(fa.RelGeometry(12, 14, 1), seq_len)
    if seq_len == 4096:  # the far tiles are most of a long sequence
        assert share > 0.9


@pytest.mark.parametrize("geo", [fa.RelGeometry(5), fa.RelGeometry(64),
                                 fa.RelGeometry(3, 4, 1), fa.RelGeometry(70, 22, 2)],
                         ids=["1d", "1d_wide_clip", "2d_parts_in_vocab", "2d_p22"])
def test_uniform_tile_id_other_geometries(geo):
    _check_uniform_tiles(geo, 1024)


def test_image_id_table_matches_relative_att_ids():
    for geo in (fa.RelGeometry(12, 14, 1), fa.RelGeometry(3, 4, 1), fa.RelGeometry(7, 5, 2)):
        il = geo.image_len
        ids = fa.relative_att_ids(geo, il + 8)
        pos = torch.arange(il + 8)
        got = fa._tile_pair_ids(geo, pos, pos, torch.from_numpy(fa.image_id_table(geo)))
        np.testing.assert_array_equal(got.numpy(), ids)
