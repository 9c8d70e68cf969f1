"""The port's MmtClassificationModel against the JAX model with bridged params.

A tiny model (hidden 64, 2 layers, 4 heads, I=128, vocab 100, P=4 so 16
patches, text distance 12, relative vocab 49 so that the part ids 49/50
are out of vocabulary as in the flagship), S=128, B=2, lengths
[128, 90].  Parameters are initialised by Flax and converted with
``convert.params_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.configs import ClassificationModelConfig as JaxModelConfig
from mmt_tpu.configs import ClsHeadConfig as JaxHead
from mmt_tpu.configs import MmtEncoderConfig as JaxEncoderConfig
from mmt_tpu.configs.encoder import EncoderConfig as JaxEncoderWrapper
from mmt_tpu.models import MmtClassificationModel as JaxModel
from mmt_tpu_torch.configs import (
    ClassificationModelConfig,
    ClsHeadConfig,
    EncoderConfig,
    MmtEncoderConfig,
)
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.models import MmtClassificationModel

P, PATCH_DIM, S, B = 4, 48, 128, 2
LENGTHS = [128, 90]
ENCODER = dict(
    vocab_size=100, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=128, relative_pos_max_distance=12, relative_vocab_size=49,
    relative_att_num_core_layers=1, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0,
)
HEAD = dict(inner_dim=64, num_classes=2, name="itm")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        word_ids=rng.integers(0, 100, (B, S)).astype(np.int32),
        segment_ids=np.where(np.arange(S)[None] < P * P + 2, 1, 2).repeat(B, 0).astype(np.int32),
        patch_embeddings=rng.normal(size=(B, P * P, PATCH_DIM)).astype(np.float32),
        lengths=np.asarray(LENGTHS, np.int32),
    )


def _jax_model(**enc):
    cfg = JaxModelConfig(
        encoder=JaxEncoderWrapper(mmt=JaxEncoderConfig(**{**ENCODER, **enc})),
        num_classes=2, cls_heads=[JaxHead(**HEAD)])
    return JaxModel(cfg, num_patch_per_row=P)


def _torch_model(**enc):
    cfg = ClassificationModelConfig(
        encoder=EncoderConfig(mmt=MmtEncoderConfig(**{**ENCODER, **enc})),
        num_classes=2, cls_heads=[ClsHeadConfig(**HEAD)])
    return MmtClassificationModel(cfg, num_patch_per_row=P, patch_dim=PATCH_DIM, device="cpu")


@pytest.fixture(scope="module")
def flax_params():
    inputs = {k: jnp.asarray(v) for k, v in _inputs().items()}
    params = _jax_model(compute_dtype="float32").init(jax.random.PRNGKey(0), **inputs)
    return jax.tree_util.tree_map(np.asarray, params)


_JAX_LOGITS = {}


def _jax_logits(params, **enc):
    """JAX itm_logits, computed once per configuration (the interpret-mode
    kernel takes seconds)."""
    key = tuple(sorted(enc.items()))
    if key not in _JAX_LOGITS:
        inputs = {k: jnp.asarray(v) for k, v in _inputs().items()}
        out = _jax_model(**enc).apply(params, **inputs, deterministic=True)
        _JAX_LOGITS[key] = np.asarray(out["itm_logits"], np.float32)
    return _JAX_LOGITS[key]


def _torch_logits(params, **enc):
    model = _torch_model(**enc)
    model.load_state_dict(params_from_flax(params, model))
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in _inputs().items()})
    return out["itm_logits"].numpy()


@pytest.mark.parametrize("jax_impl,pre_order", [
    ("xla", True), ("pallas_interpret", True), ("xla", False),
])
@pytest.mark.parametrize("torch_impl", ["xla", "pallas"])
def test_itm_logits_match_fp32(flax_params, jax_impl, pre_order, torch_impl):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = _jax_logits(flax_params, compute_dtype="float32", attention_impl=jax_impl,
                       use_pre_activation_order=pre_order)
    got = _torch_logits(flax_params, compute_dtype="float32", attention_impl=torch_impl,
                        use_pre_activation_order=pre_order)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("torch_impl", ["xla", "pallas"])
def test_itm_logits_close_bf16(flax_params, torch_impl):
    """bf16 compute in both.  The frameworks round bf16 at other places
    (bias adds, GELU, p.v), so the bound is two bf16 rounding steps at
    the logits' scale (2**-7 * max |logit|; the logits here are ~0.03)."""
    want = _jax_logits(flax_params, compute_dtype="bfloat16", attention_impl="xla")
    got = _torch_logits(flax_params, compute_dtype="bfloat16", attention_impl=torch_impl)
    np.testing.assert_allclose(got, want, atol=2**-7 * np.abs(want).max(), rtol=0)


def test_optional_embedding_parts_match_fp32():
    """Factorized word embeddings (embedding_projection), absolute
    position embeddings, the pooler and clip-mode segment lookups, each
    bridged by the converter."""
    enc = dict(compute_dtype="float32", embedding_size=32, max_absolute_position_embeddings=S,
               use_pooler_layer=True, use_one_hot_lookup=False)
    inputs = _inputs(seed=3)
    inputs["segment_ids"][:, -5:] = 20  # beyond segment_vocab_size: clamped in clip mode
    jax_model = _jax_model(**enc)
    jax_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(1), **jax_inputs))
    want = jax_model.apply(params, **jax_inputs, deterministic=True)
    model = _torch_model(**enc)
    model.load_state_dict(params_from_flax(params, model))
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    for key in ("itm_logits", "pooled_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)


def test_converter_raises_on_missing_and_extra_leaves(flax_params):
    model = _torch_model(compute_dtype="float32")
    tree = flax_params["params"]
    missing = {**tree, "encoder": {k: v for k, v in tree["encoder"].items()
                                   if k != "patch_embedding_projection"}}
    with pytest.raises(KeyError, match="unfilled"):
        params_from_flax(missing, model)
    extra = {**tree, "cls_head_other": tree["cls_head_itm"]}
    with pytest.raises(KeyError, match="unconsumed"):
        params_from_flax(extra, model)
    unknown = {**tree, "encoder": {**tree["encoder"], "mystery": {"gamma": np.zeros(3)}}}
    with pytest.raises(KeyError, match="unconsumed Flax leaf"):
        params_from_flax(unknown)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MmtClassificationModel(ClassificationModelConfig())
