"""The port's feature functions equal the JAX package's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.features import attention_mask as jax_mask
from mmt_tpu.features import relative_position as jax_rp
from mmt_tpu_torch.features import attention_mask as torch_mask
from mmt_tpu_torch.features import relative_position as torch_rp
from mmt_tpu_torch.ops.fused_attention import RelGeometry, relative_att_ids


@pytest.mark.parametrize("max_distance,seq_len", [(0, 5), (3, 40), (12, 256)])
def test_1d_ids_equal(max_distance, seq_len):
    want = jax_rp.RelativePositionGenerator(max_distance).make_relative_att_ids(seq_len, 2)
    got = torch_rp.RelativePositionGenerator(max_distance).make_relative_att_ids(seq_len, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,r,d,seq_len", [(14, 1, 12, 512), (4, 1, 3, 64), (5, 2, 4, 60)])
def test_2d_ids_equal(p, r, d, seq_len):
    want_gen = jax_rp.MmtRelativePositionGenerator(p, r, d)
    got_gen = torch_rp.MmtRelativePositionGenerator(p, r, d)
    assert (got_gen.image_part_id, got_gen.text_part_id) == (
        want_gen.image_part_id, want_gen.text_part_id)
    np.testing.assert_array_equal(
        got_gen.make_relative_att_ids(seq_len, 1), want_gen.make_relative_att_ids(seq_len, 1))


def test_geometry_ids_match_generator():
    geo = RelGeometry(text_max_distance=12, num_patch_per_row=14, num_core_layers=1)
    assert (geo.image_part_id, geo.text_part_id) == (229, 230)
    want = jax_rp.MmtRelativePositionGenerator(14, 1, 12).make_relative_att_ids(512, 1)[0]
    np.testing.assert_array_equal(relative_att_ids(geo, 512), want)


@pytest.mark.parametrize("lengths", [[128, 90, 1], [0, 64, 200]])
def test_mask_from_lengths_equal(lengths):
    seq_len = 128
    want = np.asarray(jax_mask.make_att_mask_from_length(seq_len, jnp.asarray(lengths)))
    got = torch_mask.make_att_mask_from_length(seq_len, torch.tensor(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    want1 = np.asarray(jax_mask.make_att_mask_from_length(seq_len, jnp.asarray(lengths[1])))
    got1 = torch_mask.make_att_mask_from_length(seq_len, torch.tensor(lengths[1])).numpy()
    np.testing.assert_array_equal(got1, want1)


def test_segmented_mask_equal():
    ids = np.random.default_rng(0).integers(0, 3, (2, 16)).astype(np.int32)
    want = jax_mask.make_segmented_att_mask(ids)
    got = torch_mask.make_segmented_att_mask(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
