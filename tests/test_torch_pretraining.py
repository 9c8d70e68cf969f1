"""The port's MmtPretrainingModel and heads against the JAX package.

A tiny model (hidden 64, 2 layers, 4 heads, I=128, vocab 100, P=4 so 16
patches, relative vocab 49, MPP 64 classes), S=128, B=2, lengths
[128, 90], 6 MLM and 5 MPP positions per example.  Flax initialises the
parameters; ``convert.params_from_flax`` bridges them.  MLM, MPP and ITM
logits agree at 1e-4 (absolute) in float32 with the tied and the untied
MLM table.  Dropout: ``train()`` gives another output than ``eval()``,
and the same generator seeds give the same output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.configs import ClsHeadConfig as JaxHead
from mmt_tpu.configs import MmtEncoderConfig as JaxEncoderConfig
from mmt_tpu.configs import PretrainModelConfig as JaxPretrainConfig
from mmt_tpu.configs.encoder import EncoderConfig as JaxEncoderWrapper
from mmt_tpu.models import MmtPretrainingModel as JaxModel
from mmt_tpu_torch.configs import (
    ClsHeadConfig,
    EncoderConfig,
    MmtEncoderConfig,
    PretrainModelConfig,
)
from mmt_tpu_torch.convert import flax_paths, params_from_flax
from mmt_tpu_torch.models import DropoutRngs, MmtPretrainingModel

P, PATCH_DIM, S, B, MPP_CLASSES = 4, 48, 128, 2, 64
LENGTHS = [128, 90]
ENCODER = dict(
    vocab_size=100, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=128, relative_pos_max_distance=12, relative_vocab_size=49,
    relative_att_num_core_layers=1, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0, compute_dtype="float32",
)
HEAD = dict(inner_dim=64, num_classes=2, name="itm")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        word_ids=rng.integers(0, 100, (B, S)).astype(np.int32),
        segment_ids=np.where(np.arange(S)[None] < P * P + 2, 1, 2).repeat(B, 0).astype(np.int32),
        patch_embeddings=rng.normal(size=(B, P * P, PATCH_DIM)).astype(np.float32),
        lengths=np.asarray(LENGTHS, np.int32),
        mlm_positions=rng.integers(P * P + 2, 90, (B, 6)).astype(np.int32),
        mpp_positions=rng.integers(2, P * P + 2, (B, 5)).astype(np.int32),
    )


def _jax_model(tied, **enc):
    cfg = JaxPretrainConfig(
        encoder=JaxEncoderWrapper(mmt=JaxEncoderConfig(**{**ENCODER, **enc})),
        cls_heads=[JaxHead(**HEAD)], bind_word_embedding_table=tied)
    return JaxModel(cfg, mpp_output_num_classes=MPP_CLASSES, num_patch_per_row=P)


def torch_pretraining_model(tied=True, **enc):
    cfg = PretrainModelConfig(
        encoder=EncoderConfig(mmt=MmtEncoderConfig(**{**ENCODER, **enc})),
        cls_heads=[ClsHeadConfig(**HEAD)], bind_word_embedding_table=tied)
    return MmtPretrainingModel(cfg, mpp_output_num_classes=MPP_CLASSES, num_patch_per_row=P,
                               patch_dim=PATCH_DIM, device="cpu")


_FLAX = {}


def _flax_params(tied):
    if tied not in _FLAX:
        inputs = {k: jnp.asarray(v) for k, v in _inputs().items()}
        params = _jax_model(tied).init(jax.random.PRNGKey(0), **inputs)
        _FLAX[tied] = jax.tree_util.tree_map(np.asarray, params)
    return _FLAX[tied]


@pytest.mark.parametrize("torch_impl", ["xla", "pallas"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_logits_match_fp32(tied, torch_impl):
    params = _flax_params(tied)
    inputs = _inputs()
    want = _jax_model(tied).apply(params, **{k: jnp.asarray(v) for k, v in inputs.items()},
                                  deterministic=True)
    model = torch_pretraining_model(tied, attention_impl=torch_impl).eval()
    model.load_state_dict(params_from_flax(params, model))
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    for key in ("mlm_logits", "mpp_logits", "itm_logits"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_converter_maps_back_to_every_flax_leaf():
    params = _flax_params(False)
    model = torch_pretraining_model(False)
    state = params_from_flax(params, model)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    leaves = {"/".join(k.key for k in path) for path, _ in flat}
    paths = flax_paths(model)
    assert set(paths) == set(state)
    assert set(paths.values()) == leaves
    assert paths["masked_lm.transform_layer_norm.weight"] == "masked_lm/transform_layer_norm/scale"
    assert paths["encoder.transformer.layers.1.attention.query.weight"] == \
        "encoder/transformer/layer_1/attention/query/kernel"


def test_unconsumed_leaf_still_raises():
    tree = dict(_flax_params(True)["params"])
    tree["masked_lm"] = {**tree["masked_lm"], "mystery": np.zeros(3)}
    with pytest.raises(KeyError, match="unconsumed Flax leaf"):
        params_from_flax(tree)


def test_init_is_glorot_for_the_head_transforms():
    model = torch_pretraining_model()
    w = model.masked_lm.transform_dense.weight
    limit = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert w.abs().max().item() <= limit and w.abs().max().item() > 0.9 * limit
    assert torch.all(model.masked_lm.output_bias == 0)


def _dropout_outputs(model, seed):
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    rngs = DropoutRngs(host=torch.Generator().manual_seed(seed),
                       device=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        return model(**inputs, rngs=rngs)


@pytest.mark.parametrize("torch_impl", ["xla", "pallas"])
def test_dropout_in_train_mode_only(torch_impl):
    model = torch_pretraining_model(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                    attention_impl=torch_impl)
    model.load_state_dict(params_from_flax(_flax_params(True), model))
    evaluated = _dropout_outputs(model.eval(), 1)
    trained = _dropout_outputs(model.train(), 1)
    again = _dropout_outputs(model.train(), 1)
    other = _dropout_outputs(model.train(), 2)
    for key in ("mlm_logits", "itm_logits"):
        assert not torch.allclose(trained[key], evaluated[key], atol=1e-3), key
        assert torch.equal(trained[key], again[key]), key
        assert not torch.allclose(trained[key], other[key], atol=1e-3), key
    with torch.no_grad():
        plain = model.eval()(**{k: torch.from_numpy(v) for k, v in _inputs().items()})
    assert torch.equal(plain["itm_logits"], evaluated["itm_logits"])


def test_both_attention_impls_apply_the_same_dropout():
    outs = []
    for impl in ("xla", "pallas"):
        model = torch_pretraining_model(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                        attention_impl=impl)
        model.load_state_dict(params_from_flax(_flax_params(True), model))
        outs.append(_dropout_outputs(model.train(), 3))
    for key in ("mlm_logits", "mpp_logits", "itm_logits"):
        torch.testing.assert_close(outs[0][key], outs[1][key], atol=1e-5, rtol=1e-5)
