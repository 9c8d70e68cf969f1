"""The probe package's plain versions on the CPU, against the JAX package.

* The 64 x 64 tile classifier against ``_build_tile_meta`` /
  ``_split_tile_lists`` of ``mmt_tpu.ops.pallas_attention`` at block 64.
* Plain far pass + plain structured pass + logsumexp combine against the
  port's plain attention and against JAX's ``_forward_split`` in interpret
  mode (float32, 2e-5 on real rows: both are float32 sums in other orders).
* Each op-cost variant's plain version: deterministic, and for ``ids`` /
  ``gather`` / ``rank1`` / ``mask`` equal to the same sum taken from the
  reference attention's bias.
* The probe wrappers raise on a CPU tensor instead of running something else.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as pa
from mmt_tpu_torch.features.attention_mask import make_att_mask_from_length
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.ops import relative_attention_ref as ref
from mmt_tpu_torch.probes import common, hopper_probe, op_cost_probe, split_probe

TILE = 64
GEOMETRIES = {
    "flagship_4096": (dict(text_max_distance=12, num_patch_per_row=14, num_core_layers=1), 4096),
    "small_2d_512": (dict(text_max_distance=3, num_patch_per_row=4, num_core_layers=1), 512),
    "text_only_320": (dict(text_max_distance=12), 320),
}


@pytest.mark.parametrize("name", GEOMETRIES)
def test_tile_classes_match_jax_tile_meta(name):
    kwargs, seq_len = GEOMETRIES[name]
    classes = split_probe.tile_classes(fa.RelGeometry(**kwargs), seq_len)
    geo = pa.RelGeometry(**kwargs)
    n = seq_len // TILE
    meta = pa._build_tile_meta(geo, seq_len, TILE, TILE)
    kind = np.asarray(meta[3]).reshape(n, n)  # 0 far right clip, 1 far left clip, 2 general
    want = np.choose(kind, [split_probe.FAR_RIGHT, split_probe.FAR_LEFT, split_probe.STRUCTURED])
    np.testing.assert_array_equal(classes, want)

    # JAX's lists are [3, T + 1]: (qi, ki, flag) columns, a flag-2 sentinel
    # for a query row without a tile of the kind, and one guard column.
    far, struct = split_probe.split_tile_lists(classes)
    for got, jax_list in zip((far, struct), pa._split_tile_lists(meta, n, n)):
        rows = np.asarray(jax_list).T
        np.testing.assert_array_equal(got, rows[rows[:, 2] != 2])
    assert len(far) + len(struct) == classes.size
    if name == "flagship_4096":  # 198 image slots: 4 structured tile rows and columns
        assert classes[:4].max() == classes[:, :4].max() == split_probe.STRUCTURED
        assert classes[4, 6] == split_probe.FAR_RIGHT and classes[6, 4] == split_probe.FAR_LEFT
        assert classes[4, 5] == split_probe.STRUCTURED  # offsets 1..127 meet the band
        share = split_probe.far_tile_share(fa.RelGeometry(**kwargs), [4096, 2048], seq_len)
        assert 0.7 < share < 0.9


def _attention_inputs(lengths, seq_len, heads, seed):
    q, k, v, table, lens = common.attention_inputs(lengths, seed, seq_len, heads, device="cpu")
    return q.float(), k.float(), v.float(), table, lens


@pytest.mark.parametrize("name,lengths", [("small_2d_512", [512, 300, 70]),
                                          ("text_only_320", [320, 129])])
def test_plain_split_forward_matches_plain_attention_and_jax_split(name, lengths):
    kwargs, seq_len = GEOMETRIES[name]
    geo = fa.RelGeometry(**kwargs)
    q, k, v, table, lens = _attention_inputs(lengths, seq_len, 2, seed=7)
    far = split_probe.split_pass_plain(q, k, v, table, geo, lens, True)
    struct = split_probe.split_pass_plain(q, k, v, table, geo, lens, False)
    o, lse = split_probe.combine(*far, *struct, dtype=torch.float32)
    assert torch.isinf(far[1]).any()  # rows without a far tile: the clamp's case
    assert torch.isfinite(o).all()

    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, geo, lens)
    jax_geo = pa.RelGeometry(**kwargs)
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    _, _, nq, nk, rel_vocab, _, rel_h, _ = pa._prepare(qj, kj, jnp.asarray(table.numpy()),
                                                       jax_geo, TILE, TILE)
    o_jax, lse_jax = pa._forward_split(
        qj, kj, vj, jnp.asarray(lens.numpy()), jnp.zeros((4,), jnp.int32), rel_h,
        pa._build_tile_meta(jax_geo, seq_len, TILE, TILE), jax_geo, rel_vocab, TILE, TILE,
        nq, nk, 2, True, far_mode="list")
    o_jax, lse_jax = np.asarray(o_jax), np.asarray(lse_jax).reshape(lse_ref.shape)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(o[b, :n], o_ref[b, :n], atol=2e-5)
        np.testing.assert_allclose(lse[b, :, :n], lse_ref[b, :, :n], atol=2e-5)
        np.testing.assert_allclose(o[b, :n], o_jax[b, :n], atol=2e-5)
        np.testing.assert_allclose(lse[b, :, :n], lse_jax[b, :, :n], atol=2e-5)


def test_combine_keeps_rows_without_any_tile_finite():
    neg = torch.full((1, 2, 3), -math.inf)
    o, lse = split_probe.combine(torch.zeros(1, 3, 2, 4), neg, torch.zeros(1, 3, 2, 4), neg,
                                 dtype=torch.float32)
    assert torch.isfinite(o).all() and torch.isinf(lse).all()


def _op_cost_inputs():
    shape = op_cost_probe.CHECK_SHAPE
    q, k, v, table, lens = common.attention_inputs(shape["lengths"], 11, shape["seq_len"],
                                                   shape["heads"], device="cpu")
    return q, k, v, table, lens


@pytest.mark.parametrize("variant", op_cost_probe.VARIANTS)
def test_op_cost_plain_is_deterministic_and_finite(variant):
    args = _op_cost_inputs()
    pattern = dict(window=op_cost_probe.CHECK_WINDOW, num_global=op_cost_probe.CHECK_NUM_GLOBAL)
    first = op_cost_probe.op_cost_plain(variant, *args[:4], common.FLAGSHIP, args[4], **pattern)
    again = op_cost_probe.op_cost_plain(variant, *args[:4], common.FLAGSHIP, args[4], **pattern)
    assert torch.equal(first[0], again[0]) and torch.isfinite(first[0]).all()
    assert (first[1] is None) == (variant != "atomics")
    if first[1] is not None:
        assert torch.equal(first[1], again[1])
        assert first[1][:, :, op_cost_probe.ATOMIC_ROWS:].abs().max() == 0
    visited = -(-431 // TILE) * TILE
    assert first[0][..., visited:].abs().max() == 0 and first[0][..., :visited].abs().max() > 0
    base = op_cost_probe.op_cost_plain("base", *args[:4], common.FLAGSHIP, args[4])[0]
    same = torch.allclose(first[0], base)
    assert same == (variant in ("base", "atomics") + op_cost_probe.SAME_AS_BASE), variant


@pytest.mark.parametrize("variant", ["ids", "gather", "rank1", "mask"])
def test_op_cost_plain_terms_match_the_reference_bias(variant):
    """x + term summed over the visited keys, with the term taken from the
    reference attention's own pieces (id map, gathered bias, length mask)."""
    q, k, v, table, lens = _op_cost_inputs()
    geo, seq_len, length = common.FLAGSHIP, q.shape[1], int(lens[0])
    visited = -(-length // TILE) * TILE
    got = op_cost_probe.op_cost_plain(variant, q, k, v, table, geo, lens)[0][0]

    qf, kf = q[0].float(), k[0].float()
    table_c = table.to(q.dtype).float()
    x = torch.einsum("ihd,jhd->hij", qf, kf)
    qr = torch.einsum("ihd,vhd->hiv", qf, table_c)
    ids = torch.from_numpy(fa.relative_att_ids(geo, seq_len)).long()
    if variant == "ids":
        term = ids.float()[None]
    elif variant == "gather":
        # relative_attention_scores = (q . k + gathered bias) * scale, in q.dtype inputs.
        scores = ref.relative_attention_scores(q[:1], k[:1], table, ids)[0]
        term = scores * math.sqrt(q.shape[-1]) - x
    elif variant == "rank1":
        tiles = torch.arange(seq_len) // TILE
        d = geo.text_max_distance
        term = torch.where((tiles[None, :] > tiles[:, None])[None], qr[:, :, d, None],
                           qr[:, :, 2 * d, None])
    else:
        mask = make_att_mask_from_length(seq_len, lens[:1])[0]
        term = ((1.0 - mask.float()) * fa.NEG_INF)[None]
    want = (x + term)[..., :visited].sum(-1) + qr[..., 0]
    want[:, visited:] = 0
    scale = want.abs().max().item()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)


def test_probe_wrappers_raise_on_cpu_tensors():
    q, k, v, table, lens = common.attention_inputs([128], 0, 128, 2, device="cpu")
    with pytest.raises(ValueError, match="run on CUDA tensors only"):
        split_probe.split_pass(q, k, v, table, common.FLAGSHIP, lens, True)
    with pytest.raises(ValueError, match="run on CUDA tensors only"):
        op_cost_probe.op_cost("base", q, k, v, table, common.FLAGSHIP, lens)
    with pytest.raises(ValueError, match="unknown variant"):
        op_cost_probe.op_cost("roll", q, k, v, table, common.FLAGSHIP, lens)
    for name, (_, kernel, plain, _) in hopper_probe.PROBES.items():
        inputs = hopper_probe.probe_inputs(name, device="cpu")
        with pytest.raises(ValueError, match="run on CUDA tensors only"):
            kernel(*inputs)
        assert plain(*inputs).shape == plain(*inputs).shape
    assert split_probe.split_pass.launches_far == 0
    assert all(count == 0 for count in hopper_probe.launches.values())
    if not torch.cuda.is_available():
        for module in (split_probe, op_cost_probe, hopper_probe):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                module.run()


@pytest.mark.parametrize("name", list(hopper_probe.PROBES))
def test_hopper_probe_plain_versions(name):
    """Each primitive's plain version is the stated function of its input."""
    inputs = hopper_probe.probe_inputs(name, seed=1, device="cpu")
    out = hopper_probe.PROBES[name][2](*inputs)
    x = inputs[0]
    if name.startswith("wgmma"):
        np.testing.assert_allclose(out, x.float().numpy() @ inputs[1].float().numpy().T,
                                   atol=1e-4)
    elif name in ("tma_load_2d", "tma_store_2d", "cp_async_ring"):
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    elif name == "ldmatrix_trans_stmatrix":
        assert torch.equal(out, x.T)
    elif name == "cluster_dsmem":
        assert torch.equal(out[0::2], x[1::2]) and torch.equal(out[1::2], x[0::2])
    elif name == "smem_227k":
        assert x.numel() * 4 == 232448 and torch.equal(out, x.flip(0))
    elif name == "setmaxnreg":
        assert torch.equal(out, 3 * x + 1)
    else:
        assert torch.equal(out, x.sum(0)) and out.shape == (512,)
