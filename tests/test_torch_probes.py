"""The probe package's plain versions on the CPU, against the JAX package.

* The 64 x 64 tile classifier against ``_build_tile_meta`` /
  ``_split_tile_lists`` of ``mmt_tpu.ops.pallas_attention`` at block 64.
* The split passes in the kernel's block schedule: each warpgroup's tiles
  of a class (``split_class_tiles``) against the JAX lists, the tiles a
  128-row block issues against the union of its warpgroups' tiles, and the
  tiled pass (``split_pass_tiled``) against the plain pass, against JAX's
  list pass ``_run_fwd_list`` on that list and, combined, against
  ``_forward_split`` (Pallas interpret mode; float32, 2e-5 on real rows).
* Plain far pass + plain structured pass + logsumexp combine against the
  port's plain attention and against JAX's ``_forward_split`` in interpret
  mode (float32, 2e-5 on real rows: both are float32 sums in other orders).
* Each op-cost variant's plain version: deterministic, for ``ids`` /
  ``gather`` / ``rank1`` / ``mask`` equal to the same sum taken from the
  reference attention's bias, and for ``full`` / ``full_hash`` to JAX's
  dense attention with ``_dropout_keep``.
* The probe wrappers raise on a CPU tensor instead of running something else.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as pa
from mmt_tpu.ops.relative_attention_ref import relative_attention_scores as jax_scores
from mmt_tpu_torch.features.attention_mask import make_att_mask_from_length
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.ops import relative_attention_ref as ref
from mmt_tpu_torch.probes import common, fwd_ab, hopper_probe, op_cost_probe, split_probe

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


# Lengths per geometry: full, no multiple of 64, a second warpgroup past
# the length, a length inside the image part (flagship 257 < 4 tiles).
SCHEDULE_LENGTHS = {"flagship_4096": [4096, 3001, 1000, 257, 100],
                    "small_2d_512": [512, 300, 70, 130],
                    "text_only_320": [320, 129, 64]}


@pytest.mark.parametrize("far", [True, False], ids=["far", "structured"])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_split_block_schedule_matches_jax_lists(name, far):
    """Each warpgroup's key tiles of the class are the JAX list's row of its
    query tile below the length (none where the list holds the sentinel),
    and a 128-row block issues the union of its warpgroups' tiles (the
    second one's only below the length), ascending, each once."""
    kwargs, seq_len = GEOMETRIES[name]
    geo, tile_class = fa.RelGeometry(**kwargs), "far" if far else "structured"
    n = seq_len // TILE
    meta = pa._build_tile_meta(pa.RelGeometry(**kwargs), seq_len, TILE, TILE)
    rows = np.asarray(pa._split_tile_lists(meta, n, n)[0 if far else 1]).T
    for length in SCHEDULE_LENGTHS[name]:
        nk = -(-length // TILE)
        for q0 in range(0, length, TILE):
            row = rows[rows[:, 0] == q0 // TILE]
            want = [int(ki) for _, ki, flag in row if flag != 2 and ki < nk]
            assert fa.split_class_tiles(q0, q0, length, geo, tile_class) == want, (length, q0)
        for gb0 in range(0, length, 2 * TILE):
            union = set()
            for q0 in (gb0, gb0 + TILE):
                if q0 < length:
                    union |= set(fa.split_class_tiles(q0, q0, length, geo, tile_class))
            assert split_probe.block_tiles(gb0, length, geo, far) == sorted(union), (length, gb0)


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


@pytest.mark.parametrize("name,lengths", [("small_2d_512", [512, 300, 70]),
                                          ("text_only_320", [320, 129])])
def test_split_pass_tiled_matches_plain_jax_list_and_split(name, lengths):
    """Each pass in the kernel's schedule against the plain pass and against
    JAX's list pass ``_run_fwd_list`` over that class's list (rows with no
    tile of the class: lse -inf in all three), and the two passes combined
    against ``_forward_split``; Pallas interpret mode, float32, 2e-5 on
    real rows."""
    kwargs, seq_len = GEOMETRIES[name]
    geo, jax_geo = fa.RelGeometry(**kwargs), pa.RelGeometry(**kwargs)
    q, k, v, table, lens = _attention_inputs(lengths, seq_len, 2, seed=7)
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    lens_j, qoff = jnp.asarray(lens.numpy()), jnp.zeros((4,), jnp.int32)
    _, _, nq, nk, rel_vocab, _, rel_h, _ = pa._prepare(qj, kj, jnp.asarray(table.numpy()),
                                                       jax_geo, TILE, TILE)
    meta = pa._build_tile_meta(jax_geo, seq_len, TILE, TILE)
    qt, kt, vt = (t.transpose(0, 2, 1, 3) for t in (qj, kj, vj))
    passes = {}
    for far, tlist in zip((True, False), pa._split_tile_lists(np.asarray(meta), nq, nk)):
        o, lse = split_probe.split_pass_tiled(q, k, v, table, geo, lens, far)
        assert o.dtype == torch.float32
        o_jax, lse_jax = pa._run_fwd_list(qt, kt, vt, rel_h, lens_j, qoff, meta, tlist, jax_geo,
                                          rel_vocab, TILE, TILE, nk, 2, True, far=far)
        refs = [split_probe.split_pass_plain(q, k, v, table, geo, lens, far),
                (np.asarray(o_jax).transpose(0, 2, 1, 3), np.asarray(lse_jax)[..., 0])]
        for o_ref, lse_ref in refs:
            o_ref, lse_ref = np.asarray(o_ref), np.asarray(lse_ref)
            for b, n in enumerate(lengths):
                got_lse, want_lse = lse[b, :, :n].numpy(), lse_ref[b, :, :n]
                np.testing.assert_array_equal(np.isinf(got_lse), np.isinf(want_lse))
                finite = np.isfinite(want_lse)
                np.testing.assert_allclose(got_lse[finite], want_lse[finite], atol=2e-5)
                np.testing.assert_allclose(o[b, :n], o_ref[b, :n], atol=2e-5)
        passes[far] = (o, lse)
    assert torch.isinf(passes[True][1]).any()  # rows without a far tile
    o, lse = split_probe.combine(*passes[True], *passes[False], dtype=torch.float32)
    o_jax, lse_jax = pa._forward_split(qj, kj, vj, lens_j, qoff, rel_h, meta, jax_geo, rel_vocab,
                                       TILE, TILE, nq, nk, 2, True, far_mode="list")
    o_jax, lse_jax = np.asarray(o_jax), np.asarray(lse_jax).reshape(lse.shape)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(o[b, :n], o_jax[b, :n], atol=2e-5)
        np.testing.assert_allclose(lse[b, :, :n], lse_jax[b, :, :n], atol=2e-5)


def test_split_pass_tiled_takes_the_dense_path_only():
    q, k, v, table, lens = _attention_inputs([128], 128, 2, seed=3)
    windowed = fa.RelGeometry(text_max_distance=12, window=64, num_global=8)
    with pytest.raises(ValueError, match="dense forward"):
        split_probe.split_pass_tiled(q, k, v, table, windowed, lens, True)
    with pytest.raises(ValueError, match="tile_class"):
        fa.split_class_tiles(0, 0, 128, common.FLAGSHIP, "all")


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
    """x + term summed over the visited keys, in the kernel's base-2 units
    (x = q . k * c2, qr2 = c2 * q . R^T), with the term taken from the
    reference attention's own pieces (id map, gathered bias, length mask)."""
    q, k, v, table, lens = _op_cost_inputs()
    geo, seq_len, length = common.FLAGSHIP, q.shape[1], int(lens[0])
    visited = -(-length // TILE) * TILE
    got = op_cost_probe.op_cost_plain(variant, q, k, v, table, geo, lens)[0][0]

    log2e = math.log2(math.e)
    c2 = log2e / math.sqrt(q.shape[-1])
    qf, kf = q[0].float(), k[0].float()
    table_c = table.to(q.dtype).float()
    x = torch.einsum("ihd,jhd->hij", qf, kf) * c2
    qr2 = torch.einsum("ihd,vhd->hiv", qf, table_c) * c2
    ids = torch.from_numpy(fa.relative_att_ids(geo, seq_len)).long()
    if variant == "ids":  # the kernel's ids, clamped to its 64 vocabulary columns
        term = ids.clamp(max=fa.MAX_KERNEL_VOCAB).float()[None]
    elif variant == "gather":
        # relative_attention_scores = (q . k + gathered bias) * scale, in q.dtype inputs.
        scores = ref.relative_attention_scores(q[:1], k[:1], table, ids)[0]
        term = scores * log2e - x
    elif variant == "rank1":
        tiles = torch.arange(seq_len) // TILE
        d = geo.text_max_distance
        term = torch.where((tiles[None, :] > tiles[:, None])[None], qr2[:, :, d, None],
                           qr2[:, :, 2 * d, None])
    else:
        mask = make_att_mask_from_length(seq_len, lens[:1])[0]
        term = ((1.0 - mask.float()) * fa.NEG_INF * log2e)[None]
    want = (x + term)[..., :visited].sum(-1) + qr2[..., 0]
    want[:, visited:] = 0
    scale = want.abs().max().item()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)


@pytest.mark.parametrize("variant", op_cost_probe.FULL)
def test_op_cost_full_plain_matches_jax_dense(variant):
    """``full`` / ``full_hash``: lse + sum_d o of the attention on real
    rows, 0 past the length; JAX's dense path (the keep factors of
    ``_dropout_keep`` after the softmax) on the same float32 inputs."""
    q, k, v, table, lens = _attention_inputs([431], 512, 2, seed=11)
    geo = common.FLAGSHIP
    got = op_cost_probe.op_cost_plain(variant, q, k, v, table, geo, lens)[0].numpy()

    seq_len, n = q.shape[1], int(lens[0])
    ids = jnp.asarray(fa.relative_att_ids(geo, seq_len))
    logits = jax_scores(*(jnp.asarray(t.numpy()) for t in (q, k, table)), ids)
    real = np.arange(seq_len) < n
    logits = logits + (real[:, None] != real[None, :])[None, None] * -10000.0
    probs = jax.nn.softmax(logits, axis=-1)
    if variant == "full_hash":
        pos = jnp.arange(seq_len, dtype=jnp.int32)
        heads = jnp.arange(q.shape[2], dtype=jnp.int32)[:, None, None]
        probs = probs * pa._dropout_keep(jnp.int32(op_cost_probe.DROPOUT_SEED), heads,
                                         pos[:, None], pos[None, :], op_cost_probe.DROPOUT_RATE)
    o = jnp.einsum("bhqk,bkhd->bhq", probs, jnp.asarray(v.numpy()))
    want = np.where(real, np.asarray(jax.nn.logsumexp(logits, axis=-1) + o), 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert np.all(got[..., n:] == 0) and np.all(np.isfinite(got))


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
        for module in (split_probe, op_cost_probe, hopper_probe, fwd_ab):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                module.run()


def test_fwd_ab_variant_specs():
    """``SOURCE[:FLAGS]``: the tree's forward source or a path, nvcc flags
    after the colon."""
    source, flags = fwd_ab.parse_variant("current:-DA=1 -DB")
    assert source == (fa.build.CSRC_DIR / "rel_attention_fwd.cu").resolve()
    assert source.exists() and flags == ["-DA=1", "-DB"]
    assert fwd_ab.parse_variant("old/fwd.cu") == (Path("old/fwd.cu").resolve(), [])


def test_fwd_ab_bit_equality():
    """Per case, o and lse equal bit for bit or not; the cases are the three
    main-path shapes at rates 0 and 0.1."""
    a = (torch.zeros(2, 3), torch.full((2,), -math.inf))
    b = (torch.zeros(2, 3), torch.full((2,), -math.inf))
    c = (torch.zeros(2, 3), torch.full((2,), -math.inf).nextafter(torch.zeros(())))
    assert fwd_ab.bit_equality({"x": a, "y": a}, {"x": b, "y": c}) == {"x": True, "y": False}


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
