"""The port's dynamic-int8 path (``mmt_tpu_torch/ops/quant.py``) against the
JAX package's (``mmt_tpu/ops/quant.py``), case for case with
``tests/test_quant.py``.

Bounds: the int8 values and scales are equal to JAX's (the same float32
arithmetic); one layer's float32 output within 1e-6 of its max |value|
(the int32 sums are exact, the dequantization the same float32 products);
the tiny int8 model's ITM probabilities within 1e-5 of JAX's int8 model
(float32 models whose attention and LayerNorm sum in another order), and
its ITM logits within JAX's own int8-vs-float bound, 10% of the logit
scale.
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
from mmt_tpu.ops import quant as jq
from mmt_tpu_torch.configs import (
    ClassificationModelConfig,
    ClsHeadConfig,
    EncoderConfig,
    MmtEncoderConfig,
)
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.models import MmtClassificationModel
from mmt_tpu_torch.ops import quant

PROB_BOUND = 1e-5


def _np(x):
    return np.asarray(x)


# (JAX kernel shape, its contracting dims): the Dense layout [in, out] and
# the DenseGeneral output projection [A, D, hidden].  The torch weight is
# the kernel flattened to [in, out] and transposed to [out, in].
LAYOUTS = [((64, 32), (0,)), ((4, 16, 48), (0, 1))]
LAYOUT_IDS = ["dense", "dense_general"]


def _weights(shape, seed=0):
    kernel = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    n_in = int(np.prod(shape[:-1]))
    return kernel, np.ascontiguousarray(kernel.reshape(n_in, shape[-1]).T)


@pytest.mark.parametrize("shape,contract", LAYOUTS, ids=LAYOUT_IDS)
def test_quantize_symmetric_equals_jax(shape, contract):
    kernel, weight = _weights(shape)
    want_q, want_scale = jq.quantize_symmetric(jnp.asarray(kernel), contracting_dims=contract)
    got_q, got_scale = quant.quantize_symmetric(torch.from_numpy(weight), contracting_dims=(1,))
    assert got_q.dtype == torch.int8 and got_scale.shape == (shape[-1], 1)
    np.testing.assert_array_equal(got_q.numpy().T, _np(want_q).reshape(-1, shape[-1]))
    np.testing.assert_array_equal(got_scale.numpy()[:, 0], _np(want_scale).reshape(-1))
    # Max error is half a quantization step per channel (tests/test_quant.py).
    err = np.abs(got_q.numpy() * got_scale.numpy() - weight)
    assert (err <= 0.5 * got_scale.numpy() + 1e-7).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_activation_range_equals_jax(dtype):
    x = np.asarray([[-3.0, 0.5], [1.0, 2.0]], np.float32)
    got_q, got_s = quant.dynamic_quantize_activations(torch.from_numpy(x))
    assert int(got_q.min()) == -127
    np.testing.assert_allclose(got_q.numpy() * got_s.item(), x, atol=got_s.item() / 2 + 1e-7)
    # Seeded activations of a layer, in the compute dtype: bf16 is cast to
    # float32 before the division on both sides.
    act = np.random.default_rng(3).normal(size=(4, 16, 64)).astype(np.float32)
    jx = jnp.asarray(act, dtype)
    tx = torch.from_numpy(act).to(getattr(torch, dtype))
    want_q, want_s = jq.dynamic_quantize_activations(jx)
    got_q, got_s = quant.dynamic_quantize_activations(tx)
    assert got_s.dtype == torch.float32 and got_s.dim() == 0
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    assert got_s.item() == float(want_s)


@pytest.mark.parametrize("shape,contract", LAYOUTS, ids=LAYOUT_IDS)
def test_int8_linear_matches_jax_and_stays_close_to_fp(shape, contract):
    kernel, weight = _weights(shape, seed=1)
    n_out = shape[-1]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16) + shape[:-1]).astype(np.float32)
    bias = rng.normal(size=(n_out,)).astype(np.float32)
    if contract == (0,):
        layer = jq.Int8Dense(n_out)
    else:
        layer = jq.Int8DenseGeneral(n_out, axis=(-2, -1))
    want = _np(layer.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    got = quant.int8_linear(torch.from_numpy(x.reshape(4, 16, -1)), torch.from_numpy(weight),
                            torch.from_numpy(bias), torch.float32).numpy()
    assert got.shape == want.shape[:2] + (n_out,)
    assert np.abs(got - want.reshape(got.shape)).max() <= 1e-6 * np.abs(want).max()
    # Quantization noise RMS of an int8 dot is ~1% of the output RMS.
    fp = x.reshape(4, 16, -1) @ weight.T + bias
    err_rms = np.sqrt(np.mean(np.square(got - fp)))
    assert err_rms / np.sqrt(np.mean(np.square(fp))) < 0.05


@pytest.mark.parametrize("m,k,n", [(40, 64, 24), (3, 20, 13), (16, 8, 8)])
def test_int_mm_path_equals_plain_product(m, k, n):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
    plain = quant.int8_matmul_plain(a, b)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    # torch._int_mm (the CUDA route) with its padding, on the CPU.
    np.testing.assert_array_equal(quant._int_mm_padded(a, b).numpy(), want)
    np.testing.assert_array_equal(quant.int8_matmul(a, b).numpy(), want)
    with pytest.raises(TypeError, match="int8"):
        quant.int8_matmul(a.float(), b)


@pytest.mark.parametrize("n_in,n_out", [(768, 12 * 64), (12 * 64, 768)])
def test_int8_linear_params_match_linear(n_in, n_out):
    """``Int8Linear`` has ``nn.Linear``'s parameters (names, shapes,
    dtypes), so float checkpoints load unchanged."""
    ref = dict(torch.nn.Linear(n_in, n_out).named_parameters())
    got = dict(quant.Int8Linear(n_in, n_out).named_parameters())
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in ref.items()}


def test_dense_cls_dispatch():
    assert quant.dense_cls("none") is torch.nn.Linear
    assert quant.dense_cls("int8_dynamic") is quant.Int8Linear
    with pytest.raises(ValueError, match="Unknown quantize mode 'int4'"):
        quant.dense_cls("int4")


ENCODER = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, relative_pos_max_distance=4, relative_vocab_size=12,
               max_absolute_position_embeddings=None, compute_dtype="float32",
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
HEAD = dict(inner_dim=32, num_classes=2, name="itm")
PATCH_DIM, N_PATCHES = 27, 4


def _jax_model(quantize):
    cfg = JaxModelConfig(
        encoder=JaxEncoderWrapper(mmt=JaxEncoderConfig(**ENCODER, attention_impl="xla",
                                                       quantize=quantize)),
        cls_heads=[JaxHead(**HEAD)])
    return JaxModel(cfg, num_patch_per_row=2)


def _torch_model(quantize, impl="xla"):
    cfg = ClassificationModelConfig(
        encoder=EncoderConfig(mmt=MmtEncoderConfig(**ENCODER, attention_impl=impl,
                                                   quantize=quantize)),
        cls_heads=[ClsHeadConfig(**HEAD)])
    return MmtClassificationModel(cfg, num_patch_per_row=2, patch_dim=PATCH_DIM, device="cpu")


def _inputs(batch=2, seq=16):
    rng = np.random.default_rng(7)
    return dict(
        word_ids=rng.integers(0, 512, (batch, seq)).astype(np.int32),
        segment_ids=np.ones((batch, seq), np.int32),
        patch_embeddings=rng.normal(size=(batch, N_PATCHES, PATCH_DIM)).astype(np.float32),
        lengths=np.asarray([seq, seq - 3], np.int32),
    )


@pytest.fixture(scope="module")
def jax_int8():
    inputs = {k: jnp.asarray(v) for k, v in _inputs().items()}
    params = _jax_model("none").init(jax.random.PRNGKey(0), **inputs)
    logits = {q: _np(_jax_model(q).apply(params, **inputs, deterministic=True)["itm_logits"])
              for q in ("none", "int8_dynamic")}
    return jax.tree_util.tree_map(np.asarray, params), logits


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_classification_model_int8_matches_jax_and_checkpoint_compatible(jax_int8, impl):
    """The same float32 parameters drive the float and the int8 model."""
    params, jax_logits = jax_int8
    fp, q = _torch_model("none", impl), _torch_model("int8_dynamic", impl)
    # Checkpoint compatibility: the int8 model takes the float state dict.
    assert {k: v.shape for k, v in fp.state_dict().items()} == \
        {k: v.shape for k, v in q.state_dict().items()}
    state = params_from_flax(params, fp)
    fp.load_state_dict(state)
    q.load_state_dict(fp.state_dict())
    assert sum(isinstance(m, quant.Int8Linear) for m in q.modules()) == 2 * 6
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.no_grad():
        out_fp = fp(**inputs)["itm_logits"].numpy()
        out_q = q(**inputs)["itm_logits"].numpy()
    probs = torch.softmax(torch.from_numpy(out_q), -1).numpy()
    want = torch.softmax(torch.tensor(jax_int8[1]["int8_dynamic"]), -1).numpy()
    print(f"{impl}: int8 ITM probabilities differ from JAX's by {np.abs(probs - want).max()}")
    assert np.abs(probs - want).max() <= PROB_BOUND
    np.testing.assert_allclose(out_fp, jax_logits["none"], atol=1e-5)
    # tests/test_quant.py's bound: int8 within 10% of the float logit scale.
    scale = max(float(np.abs(out_fp).max()), 1.0)
    assert float(np.abs(out_fp - out_q).max()) / scale < 0.1
    assert not np.array_equal(out_fp, out_q)


def test_int8_training_rejected():
    q = _torch_model("int8_dynamic")
    q.train()
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with pytest.raises(ValueError, match="inference-only"):
        q(**inputs)


def test_unknown_quantize_mode_rejected():
    with pytest.raises(ValueError, match="Unknown quantize mode 'int4'"):
        _torch_model("int4")
