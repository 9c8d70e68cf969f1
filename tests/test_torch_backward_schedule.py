"""The backward kernel's decomposition against the JAX package, on the CPU.

``csrc/rel_attention_bwd.cu`` computes the attention backward in one pass
over each (query, key) pair: a block owns 64 keys, sweeps their live query
tiles (``live_tiles``), keeps dk and dv, adds each tile's dq contribution
``dS . k + dSV_tile . R_h`` to the query rows and ``dSV_tile^T . q_tile`` to
dRel.  ``relative_attention_backward_tiled`` is that schedule in plain
PyTorch; no card runs here, so this file holds its algebra, and the card
holds the kernel against the plain version (``tests/test_torch_cuda.py``).

Each case goes through ``jax.grad`` of the Pallas kernels in interpret mode
(K3 dense; K4, the windowed backward over the live-tile list, when the
geometry has a window), with 64-blocks as the kernel's tiles.  Tolerance:
3e-4 (atol = rtol) on real rows of dq, dk, dv and on all of dRel, the bound
of ``tests/test_pallas_backward.py:_compare``: both sides are float32, and
the sums run in another order (per key block and per tile here, per grid
step there).  Rows past each length must be exactly 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu_torch.ops import fused_attention as fa
from tests.test_torch_attention_backward import GEOMETRIES

TOL = 3e-4
H, D, BLOCK = 2, 16, 64
SEED = 246813579
# (sequence length, lengths, window, global prefix per geometry): full and
# partial tiles; one example shorter than a tile beside a fully padded one;
# the sliding window, whose key blocks past the prefix skip query tiles.
LAYOUTS = {
    "dense": (128, [128, 90], 0, None),
    "short_and_empty": (128, [37, 0], 0, None),
    "window": (256, [256, 170], 24, {"2d": 18, "1d": 16}),
    "window_short_and_empty": (256, [150, 0], 24, {"2d": 18, "1d": 16}),
}


def _case(geo_name, layout):
    geo, vocab = GEOMETRIES[geo_name]
    seq_len, lengths, window, num_global = LAYOUTS[layout]
    if window:
        geo = dataclasses.replace(geo, window=window, num_global=num_global[geo_name])
    rng = np.random.default_rng(11)
    shape = (len(lengths), seq_len, H, D)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    table = rng.normal(size=(vocab, H, D)).astype(np.float32)
    real = (np.arange(seq_len)[None, :] < np.asarray(lengths)[:, None])[:, :, None, None]
    w = (rng.normal(size=shape) * real).astype(np.float32)
    return geo, lengths, (q, k, v, table), w


def _jax_grads(geo, lengths, arrays, w, rate):
    def loss(q, k, v, table):
        out = jax_pa.pallas_relative_attention(
            q, k, v, table, geo, jnp.asarray(lengths, jnp.int32), block_q=BLOCK,
            block_k=BLOCK, interpret=True, dropout_rate=rate,
            dropout_seed=jnp.int32(SEED) if rate else None)
        return jnp.sum(out * w)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in arrays))
    return [np.asarray(g) for g in grads]


def test_live_tiles_visit_every_allowed_pair_once():
    geo = fa.RelGeometry(3, 4, 1, window=24, num_global=18)
    seq_len, length = 512, 450
    pos = torch.arange(seq_len)
    allowed = fa.window_allowed(geo, pos[:, None], pos[None, :])
    for k0 in range(0, length, fa.TILE):
        tiles = fa.live_tiles(k0, length, geo)
        assert tiles == sorted(set(tiles)) and k0 // fa.TILE in tiles
        for tile in range(-(-length // fa.TILE)):
            block = allowed[tile * 64:(tile + 1) * 64, k0:k0 + 64]
            assert (tile in tiles) == bool(block.any()), (k0, tile)
    assert fa.live_tiles(128, length, fa.RelGeometry(3)) == list(range(8))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("geo_name", sorted(GEOMETRIES))
def test_tiled_backward_matches_jax_grad(geo_name, layout, rate):
    geo, lengths, arrays, w = _case(geo_name, layout)
    want = _jax_grads(geo, lengths, arrays, w, rate)
    q, k, v, table = (torch.from_numpy(x) for x in arrays)
    port_geo, lens, seed = fa.RelGeometry(**vars(geo)), torch.tensor(lengths), SEED if rate else None
    o, lse = fa.relative_attention_plain(q, k, v, table, port_geo, lens, rate, seed)
    w = torch.from_numpy(w)
    delta = torch.einsum("bshd,bshd->bhs", w, o)
    got = fa.relative_attention_backward_tiled(q, k, v, w, lse, delta, table, port_geo, lens,
                                               rate, seed)
    for name, g, ref in zip(("dq", "dk", "dv", "drel"), got, want):
        if name == "drel":
            np.testing.assert_allclose(g.numpy(), ref, atol=TOL, rtol=TOL, err_msg=name)
            continue
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(g[b, :n].numpy(), ref[b, :n], atol=TOL, rtol=TOL,
                                       err_msg=name)
            assert torch.all(g[b, n:] == 0), name
