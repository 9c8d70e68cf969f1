"""TF checkpoint import without TensorFlow, against TF and the JAX package.

* ``train/tf_bundle.py`` against ``tf.train.load_checkpoint`` and
  ``tf.train.latest_checkpoint`` on checkpoints TF writes (float32,
  float64, bfloat16 widened to float32, the int64 ``save_counter``) and on
  bundles ``chip_smoke.write_tf_bundle`` writes (one and three shards):
  keys, shapes, dtypes and values bit-equal; a flipped byte raises.
* ``train/tf_checkpoint.py`` and ``train/vit_checkpoint.py`` against the
  JAX package's converters on the synthetic checkpoints of
  ``tests/test_tf_checkpoint.py`` and ``tests/test_warm_start.py``: the
  port's state_dict bit-equal to ``params_from_flax`` of JAX's converted
  tree (the port's model starts from JAX's initial parameters), the same
  warnings and errors, and the warm-started model's ITM logits within
  1e-4 (absolute, float32; the tolerance of ``tests/test_torch_pretraining.py``)
  of JAX's.
* layouts: ``export_tf_layout`` equal to JAX's and inverted by the
  conversion; ``convert.flax_from_state_dict`` inverting
  ``params_from_flax``; ``interpolate_position_embeddings`` bit-equal.
"""

import logging

import numpy as np
import pytest
import torch
from torch import nn

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import tests.test_warm_start as jax_warm  # noqa: E402
from mmt_tpu.configs import ClassificationModelConfig as JaxClsConfig  # noqa: E402
from mmt_tpu.configs import ClsHeadConfig as JaxHead  # noqa: E402
from mmt_tpu.configs.encoder import EncoderConfig as JaxEncoderWrapper  # noqa: E402
from mmt_tpu.data.tfrecord import crc32c as bytewise_crc32c  # noqa: E402
from mmt_tpu.models import MmtClassificationModel as JaxClsModel  # noqa: E402
from mmt_tpu.train import tf_checkpoint as jax_tf  # noqa: E402
from mmt_tpu.train import vit_checkpoint as jax_vit  # noqa: E402
from mmt_tpu_torch.configs import (  # noqa: E402
    ClassificationModelConfig,
    ClsHeadConfig,
    EncoderConfig,
    MmtEncoderConfig,
    PretrainModelConfig,
)
from mmt_tpu_torch.convert import flax_from_state_dict, flax_paths, params_from_flax  # noqa: E402
from mmt_tpu_torch.data import tfrecord  # noqa: E402
from mmt_tpu_torch.models import MmtClassificationModel, MmtPretrainingModel  # noqa: E402
from mmt_tpu_torch.train import tf_bundle, tf_checkpoint, vit_checkpoint  # noqa: E402
from tests.test_models import tiny_encoder_config  # noqa: E402

LOGIT_ATOL = 1e-4  # tests/test_torch_pretraining.py's float32 logits tolerance
VARIABLE = "/.ATTRIBUTES/VARIABLE_VALUE"


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


# ------------------------------------------------------------------ models

def _cls_models():
    """The classification target of tests/test_tf_checkpoint.py (JAX) and
    the port's model holding JAX's initial parameters."""
    jax_cfg = JaxClsConfig(encoder=JaxEncoderWrapper(mmt=tiny_encoder_config()), num_classes=2,
                           cls_heads=[JaxHead(inner_dim=32, num_classes=2, name="itm")])
    jax_model = JaxClsModel(jax_cfg, num_patch_per_row=2)
    params = _tree_np(jax_model.init(
        jax.random.PRNGKey(0), word_ids=jnp.zeros((1, 8), jnp.int32),
        patch_embeddings=jnp.zeros((1, 4, 12), jnp.float32), lengths=jnp.full((1,), 8, jnp.int32)))
    enc = {k: v for k, v in tiny_encoder_config().__dict__.items()}
    cfg = ClassificationModelConfig(encoder=EncoderConfig(mmt=MmtEncoderConfig(**enc)),
                                    num_classes=2,
                                    cls_heads=[ClsHeadConfig(inner_dim=32, num_classes=2,
                                                             name="itm")])
    model = MmtClassificationModel(cfg, num_patch_per_row=2, patch_dim=12, device="cpu")
    model.load_state_dict(params_from_flax(params, model))
    return jax_model, params, model


def _pretrain_models(max_abs_pos=0):
    """``tests/test_warm_start.py:_tiny_model`` (JAX) and the port's model
    holding its initial parameters, with its inputs as numpy."""
    jax_model, params, inputs = jax_warm._tiny_model(max_abs_pos)
    enc = MmtEncoderConfig(
        vocab_size=40, hidden_size=jax_warm.HIDDEN, num_hidden_layers=jax_warm.LAYERS,
        num_attention_heads=jax_warm.HEADS, intermediate_size=jax_warm.INTER,
        relative_pos_max_distance=3, relative_vocab_size=jax_warm.REL_VOCAB,
        relative_att_num_core_layers=1, compute_dtype="float32",
        max_absolute_position_embeddings=max_abs_pos, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    cfg = PretrainModelConfig(encoder=EncoderConfig(mmt=enc), cls_heads=[
        ClsHeadConfig(inner_dim=jax_warm.HIDDEN, num_classes=2, name="itm")])
    model = MmtPretrainingModel(cfg, num_patch_per_row=2, patch_dim=768, device="cpu")
    params = _tree_np(params)
    model.load_state_dict(params_from_flax(params, model))
    return jax_model, params, model, {k: np.asarray(v) for k, v in inputs.items()}


def _itm_logits_close(jax_model, jax_params, model, state, inputs):
    want = jax_model.apply(jax_params, **{k: jnp.asarray(v) for k, v in inputs.items()},
                           deterministic=True)["itm_logits"]
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(**{k: torch.tensor(v) for k, v in inputs.items()})["itm_logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    return got


def _warnings(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


# ------------------------------------------------------------------ reader

def _tf_checkpoint(tmp_path):
    """A ``tf.train.CheckpointManager`` checkpoint of float32, float64,
    bfloat16 and int64 variables in nested modules."""
    rng = np.random.default_rng(0)
    root = tf.Module()
    root.encoder = tf.Module()
    root.encoder._table = tf.Variable(rng.normal(size=(37, 16)).astype(np.float32))
    root.encoder.layers = [tf.Module() for _ in range(2)]
    for i, layer in enumerate(root.encoder.layers):
        layer.kernel = tf.Variable(rng.normal(size=(16, 8 + i)).astype(np.float32))
        layer.scale = tf.Variable(tf.constant(rng.normal(size=(5, 3)), dtype=tf.bfloat16))
    root.head = tf.Module()
    root.head.bias = tf.Variable(rng.normal(size=(3,)))  # float64
    root.head.count = tf.Variable(np.int64(12))
    manager = tf.train.CheckpointManager(tf.train.Checkpoint(model=root), str(tmp_path),
                                         max_to_keep=3)
    manager.save()
    return manager.save()  # ckpt-2, the latest


def test_reader_matches_tf_load_checkpoint(tmp_path):
    path = _tf_checkpoint(tmp_path / "tf")
    assert tf_bundle.latest_checkpoint(str(tmp_path / "tf")) == path \
        == tf.train.latest_checkpoint(str(tmp_path / "tf"))
    want = tf.train.load_checkpoint(path)
    reader = tf_bundle.BundleReader(path)
    assert reader.shapes() == {k: tuple(v) for k, v in want.get_variable_to_shape_map().items()}
    dtypes = want.get_variable_to_dtype_map()
    assert reader.dtype_name("_CHECKPOINTABLE_OBJECT_GRAPH") == "string"
    seen = set()
    for key in reader.shapes():
        if key.startswith("_"):
            continue
        value, got = np.asarray(want.get_tensor(key)), reader.get_tensor(key)
        seen.add(dtypes[key].name)
        assert reader.dtype_name(key) == dtypes[key].name, key
        if dtypes[key] == tf.bfloat16:  # widened exactly
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, value.astype(np.float32))
            assert np.array_equal(got.view(np.uint32) & 0xFFFF, np.zeros(got.shape, np.uint32))
        else:
            assert got.dtype == value.dtype and got.shape == value.shape, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert seen == {"float32", "float64", "bfloat16", "int64"}
    # The JAX package's filter and key normalisation, on the same files.
    got = tf_checkpoint.load_tf_checkpoint(path)
    jax_vars = jax_tf.load_tf_checkpoint(path)
    assert list(got) == sorted(jax_vars)
    assert "save_counter" in got and "encoder/_table" in got
    for key, value in jax_vars.items():
        np.testing.assert_array_equal(got[key], np.asarray(value).astype(got[key].dtype))


@pytest.mark.parametrize("num_shards", [1, 3])
def test_writer_bundles_read_back_by_tf(tmp_path, num_shards):
    """chip_smoke's bundle writer: TF reads back every key, dtype and value
    bit-equal, and so does the port's reader (a multi-block index, 0-d,
    bool and float16 tensors, several shards)."""
    rng = np.random.default_rng(num_shards)
    variables = {f"encoder/_layers/{i}/kernel": rng.normal(size=(30, 20 + i)).astype(np.float32)
                 for i in range(40)}
    variables.update({"x/int": np.arange(5, dtype=np.int32), "x/f64": rng.normal(size=(3,)),
                      "x/flags": np.array([True, False]), "x/half": np.ones(3, np.float16),
                      "x/scalar": np.asarray(3.5, np.float32), "x/i8": np.arange(-3, 3, dtype=np.int8)})
    path = chip_smoke.write_tf_checkpoint(tmp_path, variables, num_shards=num_shards)
    assert tf.train.latest_checkpoint(str(tmp_path)) == path \
        == tf_bundle.latest_checkpoint(str(tmp_path))
    assert len(list(tmp_path.glob("ckpt-1.data-*"))) == num_shards
    want = tf.train.load_checkpoint(path)
    assert set(want.get_variable_to_shape_map()) == \
        {f"model/{k}{VARIABLE}" for k in variables} | {f"save_counter{VARIABLE}"}
    reader = tf_bundle.BundleReader(path)
    assert reader.num_shards == num_shards
    for name, value in variables.items():
        key = f"model/{name}{VARIABLE}"
        for got in (np.asarray(want.get_tensor(key)), reader.get_tensor(key)):
            assert got.dtype == value.dtype and got.shape == value.shape, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert tf_checkpoint.load_tf_checkpoint(path)["save_counter"] == 1


def test_a_flipped_byte_raises(tmp_path):
    path = _tf_checkpoint(tmp_path / "tf")
    data = f"{path}.data-00000-of-00001"
    reader = tf_bundle.BundleReader(path)
    entry = reader.entries[f"model/encoder/layers/1/kernel{VARIABLE}"]
    blob = bytearray(open(data, "rb").read())
    blob[entry.offset + 7] ^= 0x10
    open(data, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="crc32c"):
        tf_checkpoint.load_tf_checkpoint(path)
    with pytest.raises(Exception, match="(?i)checksum|crc|corrupt"):
        tf.train.load_checkpoint(path).get_tensor(f"model/encoder/layers/1/kernel{VARIABLE}")
    # One byte of the index table: its block fails its crc.
    index = bytearray(open(path + ".index", "rb").read())
    index[3] ^= 0x01
    open(path + ".index", "wb").write(bytes(index))
    with pytest.raises(ValueError, match="crc32c"):
        tf_bundle.BundleReader(path)


def test_what_the_reader_refuses(tmp_path):
    from mmt_tpu_torch.cli.train import tf_checkpoint_path

    for call in (tf_bundle.BundleReader, tf_bundle.latest_checkpoint, tf_checkpoint_path,
                 tf_checkpoint.load_tf_checkpoint):
        with pytest.raises(ValueError, match="local checkpoint paths only"):
            call("gs://bucket/vit/ckpt-1")
    with pytest.raises(FileNotFoundError, match="no TF checkpoint"):
        tf_bundle.BundleReader(str(tmp_path / "nothing"))
    assert tf_bundle.latest_checkpoint(str(tmp_path)) is None
    (tmp_path / "checkpoint").write_text('model_checkpoint_path: "ckpt-7"\n')
    with pytest.raises(FileNotFoundError, match="ckpt-7"):
        tf_bundle.latest_checkpoint(str(tmp_path))
    # A partitioned variable's entry, and the object graph (a string).
    prefix = str(tmp_path / "sliced")
    chip_smoke.write_tf_bundle(prefix, {"a": np.ones(4, np.float32), "b": np.zeros(2, np.float32)},
                               sliced={"b"})
    reader = tf_bundle.BundleReader(prefix)
    np.testing.assert_array_equal(reader.get_tensor("a"), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="'b' is a sliced"):
        reader.get_tensor("b")
    path = _tf_checkpoint(tmp_path / "tf")
    with pytest.raises(ValueError, match="dtype string"):
        tf_bundle.BundleReader(path).get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH")


@pytest.mark.parametrize("size", [0, 1, 7, 1023, 1024, 4100, 65543, 1 << 20, 3_000_017])
def test_crc32c_matches_the_bytewise_crc(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert tfrecord.crc32c(data) == bytewise_crc32c(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# -------------------------------------------------------------- converters

def _reference_checkpoint(tmp_path, flat):
    """tests/test_tf_checkpoint.py:29's checkpoint: the embeddings and the
    embedding norm under the reference's attribute names, seeded values."""

    class Obj(tf.Module):
        pass

    rng = np.random.default_rng(0)

    def var(shape):
        return tf.Variable(rng.normal(size=shape).astype(np.float32))

    model = Obj()
    model.encoder = enc = Obj()
    enc._word_embedding_layer = Obj()
    enc._word_embedding_layer.embedding_table = var(
        flat[("encoder", "word_embeddings", "embedding_table")].shape)
    enc._segment_embedding_layer = Obj()
    enc._segment_embedding_layer.embedding_table = var(
        flat[("encoder", "segment_embeddings", "embedding_table")].shape)
    enc._patch_embedding_projection = Obj()
    enc._patch_embedding_projection.kernel = var(
        flat[("encoder", "patch_embedding_projection", "kernel")].shape)
    enc._patch_embedding_projection.bias = var(
        flat[("encoder", "patch_embedding_projection", "bias")].shape)
    enc._embedding_norm_layer = Obj()
    enc._embedding_norm_layer.gamma = var(flat[("encoder", "embeddings_layer_norm", "scale")].shape)
    enc._embedding_norm_layer.beta = var(flat[("encoder", "embeddings_layer_norm", "bias")].shape)
    return tf.train.Checkpoint(model=model).write(str(tmp_path / "ref_ckpt"))


def test_reference_checkpoint_converts_as_jax(tmp_path, caplog):
    import flax

    _, params, model = _cls_models()
    flat = flax.traverse_util.flatten_dict(params["params"])
    tf_vars = tf_checkpoint.load_tf_checkpoint(_reference_checkpoint(tmp_path, flat))
    caplog.set_level(logging.WARNING)
    want = params_from_flax(jax_tf.convert_tf_checkpoint(tf_vars, params, strict=False), model)
    jax_warnings = _warnings(caplog, "mmt_tpu")
    caplog.clear()
    assigned = set()
    got = tf_checkpoint.convert_tf_checkpoint(tf_vars, model, strict=False, assigned=assigned)
    _assert_state_equal(got, want)
    assert _warnings(caplog, "mmt_tpu_torch") == jax_warnings
    assert any("target params unmatched" in w for w in jax_warnings)
    assert assigned == {"encoder.word_embeddings.embedding_table",
                        "encoder.segment_embeddings.embedding_table",
                        "encoder.patch_embedding_projection.weight",
                        "encoder.patch_embedding_projection.bias",
                        "encoder.embeddings_layer_norm.weight",
                        "encoder.embeddings_layer_norm.bias"}


def test_strict_unmatched_raises_as_jax():
    _, params, model = _cls_models()
    with pytest.raises(ValueError) as want:
        jax_tf.convert_tf_checkpoint({}, params, strict=True)
    with pytest.raises(ValueError) as got:
        tf_checkpoint.convert_tf_checkpoint({}, model, strict=True)
    assert str(got.value) == str(want.value)
    assert "target params unmatched" in str(got.value)


def test_etcmodel_shaped_conversion_matches_jax(tmp_path, caplog):
    """tests/test_warm_start.py:174: etcmodel-internals naming, strict over
    the encoder; then the whole model's ITM logits against JAX's."""
    jax_model, params, model, inputs = _pretrain_models()
    tf_vars = tf_checkpoint.load_tf_checkpoint(jax_warm.TestEtcmodelShapedConversion()._etc_ckpt(
        tmp_path))
    caplog.set_level(logging.WARNING)
    jax_enc = jax_tf.convert_tf_checkpoint(
        tf_vars, {"params": {"encoder": params["params"]["encoder"]}}, strict=True)
    jax_warnings = _warnings(caplog, "mmt_tpu")
    caplog.clear()
    holder = nn.Module()  # the encoder alone, named encoder.* as in the model
    holder.encoder = model.encoder
    got = tf_checkpoint.convert_tf_checkpoint(tf_vars, holder, strict=True)
    _assert_state_equal(got, params_from_flax(jax_enc, holder))
    assert _warnings(caplog, "mmt_tpu_torch") == jax_warnings
    merged = {"params": {**params["params"], "encoder": jax_enc["params"]["encoder"]}}
    with torch.no_grad():
        fresh = model(**{k: torch.tensor(v) for k, v in inputs.items()})["itm_logits"]
    state = {**model.state_dict(), **got}
    logits = _itm_logits_close(jax_model, merged, model, state, inputs)
    assert not torch.allclose(logits, fresh)


@pytest.mark.parametrize("src_grid,conv", [(8, True), (4, False)], ids=["grid8_conv", "grid4"])
def test_vit_conversion_matches_jax(tmp_path, caplog, src_grid, conv):
    """tests/test_warm_start.py:73: an image-only checkpoint in the MMT
    layout into a 2 + 4^2 position table (8x8 interpolated, or copied),
    conv-style or flat patch kernels."""
    jax_model, params, model, inputs = _pretrain_models(max_abs_pos=2 + 16)
    path, _ = jax_warm.TestVitWarmStart()._vit_ckpt(tmp_path, src_grid=src_grid, conv=conv)
    tf_vars = tf_checkpoint.load_tf_checkpoint(path)
    caplog.set_level(logging.WARNING)
    jax_out = jax_vit.convert_vit_checkpoint(tf_vars, params)
    jax_warnings = _warnings(caplog, "mmt_tpu")
    caplog.clear()
    assigned = set()
    got = vit_checkpoint.convert_vit_checkpoint(tf_vars, model, assigned=assigned)
    _assert_state_equal(got, params_from_flax(_tree_np(jax_out), model))
    assert _warnings(caplog, "mmt_tpu_torch") == jax_warnings
    text_only = {n for n, p in flax_paths(model).items()
                 if vit_checkpoint._is_text_only(tuple(p.split("/")))}
    assert assigned == set(got) - text_only
    assert "encoder.word_embeddings.embedding_table" in text_only
    _itm_logits_close(jax_model, jax_out, model, got, inputs)


def test_vit_missing_block_raises_as_jax(tmp_path):
    _, params, model, _ = _pretrain_models(max_abs_pos=2 + 16)
    path, _ = jax_warm.TestVitWarmStart()._vit_ckpt(tmp_path, src_grid=4)
    dropped = {k: v for k, v in tf_checkpoint.load_tf_checkpoint(path).items()
               if "layer_1/intermediate" not in k}
    with pytest.raises(ValueError) as want:
        jax_vit.convert_vit_checkpoint(dropped, params)
    with pytest.raises(ValueError) as got:
        vit_checkpoint.convert_vit_checkpoint(dropped, model)
    assert str(got.value) == str(want.value)
    assert "layer_1/intermediate" in str(got.value)


# ----------------------------------------------------------------- layouts

@pytest.mark.parametrize("kind", ["classification", "pretraining"])
def test_export_tf_layout_round_trip(kind):
    """JAX -> TF layout equal in both packages; TF layout -> port is the
    identity, strict, from a template whose every value differs."""
    if kind == "classification":
        _, params, model = _cls_models()
    else:
        _, params, model, _ = _pretrain_models(max_abs_pos=18)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    exported = tf_checkpoint.export_tf_layout(state, model)
    want = jax_tf.export_tf_layout(params)
    assert set(exported) == set(want)
    for name, value in want.items():
        assert exported[name].dtype == value.dtype and exported[name].shape == value.shape
        np.testing.assert_array_equal(exported[name], value, err_msg=name)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0).sub_(1.0)
    _assert_state_equal(tf_checkpoint.convert_tf_checkpoint(exported, model, strict=True), state)


@pytest.mark.parametrize("kind", ["classification", "pretraining"])
def test_flax_from_state_dict_inverts_params_from_flax(kind):
    import flax

    if kind == "classification":
        _, params, model = _cls_models()
    else:
        _, params, model, _ = _pretrain_models(max_abs_pos=18)
    want = flax.traverse_util.flatten_dict(params["params"])
    got = flax.traverse_util.flatten_dict(flax_from_state_dict(model.state_dict(), model))
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


@pytest.mark.parametrize("src_len,target_len", [(2 + 14 * 14, 2 + 24 * 24),
                                                (2 + 24 * 24, 2 + 14 * 14),
                                                (2 + 24 * 24 + 30, 2 + 14 * 14),
                                                (50, 77)])
def test_interpolate_position_embeddings_is_jax_bit_for_bit(src_len, target_len):
    table = np.random.default_rng(src_len).normal(size=(src_len, 768)).astype(np.float32)
    want = jax_vit.interpolate_position_embeddings(table, target_len)
    got = vit_checkpoint.interpolate_position_embeddings(table, target_len)
    assert got.dtype == want.dtype == np.float32 and got.shape == (target_len, 768)
    assert got.tobytes() == want.tobytes()
