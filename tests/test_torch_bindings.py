"""The port's gin-style bindings and ``encoder_cls`` injection point.

Every case of ``tests/test_bindings.py`` in torch terms (literals, ``@``
references in both styles, the errors, module attributes, configurable
parameters, file-then-params order, ``clear_bindings``, snapshot replay,
the transitive import error), and parse results and error messages equal
to the JAX package's on the same lines.  Then ``build_encoder``: a binding
(short and fully qualified) and a dotted ``encoder_cls`` in the config
each build ``TinyTorchEncoder`` inside both models, which run; one CLI
training step runs with it (classification from records with the binding,
pretraining on dummy input with the config's path); and a loader process
sees a binding made in its parent.
"""

import pytest
import torch
import yaml

from mmt_tpu.utils import bindings as jax_bindings
from mmt_tpu_torch.configs import (
    ClassificationModelConfig,
    ClsHeadConfig,
    EncoderConfig,
    MmtEncoderConfig,
    PretrainModelConfig,
)
from mmt_tpu_torch.configs.encoder import build_encoder
from mmt_tpu_torch.models import MmtClassificationModel, MmtEncoder, MmtPretrainingModel
from mmt_tpu_torch.utils import bindings
from mmt_tpu_torch.utils.bindings import (
    apply_bindings,
    clear_bindings,
    configurable,
    parse_bindings,
    resolve_reference,
)
from tests import test_torch_bindings_fixture as fixture

ENCODER_PATH = "tests.test_torch_bindings_fixture.TinyTorchEncoder"


@pytest.fixture(autouse=True)
def _reset():
    yield
    clear_bindings()
    fixture.TUNABLE = 1.0


LITERAL_LINES = [
    "a.x = 3e-4",
    "a.y = True   # trailing comment",
    "a.z = 'text'",
    "a.w = [1, 2, 3]",
    "a.n = None",
    "",
    "# full-line comment",
    'a.run = "run#1"  # this part IS a comment',
    "a.tag = 'x#y#z'",
    "a.d = {'k': (1, 2.5)}",
]


def test_literals_match_jax():
    got = dict(parse_bindings(LITERAL_LINES))
    assert got == {"a.x": 3e-4, "a.y": True, "a.z": "text", "a.w": [1, 2, 3], "a.n": None,
                   "a.run": "run#1", "a.tag": "x#y#z", "a.d": {"k": (1, 2.5)}}
    assert got == dict(jax_bindings.parse_bindings(LITERAL_LINES))


def test_reference_both_styles():
    (key, value), = parse_bindings([f"enc.cls = @{ENCODER_PATH}"])
    assert key == "enc.cls" and value is fixture.TinyTorchEncoder
    assert resolve_reference("tests.test_torch_bindings_fixture:TinyTorchEncoder") \
        is fixture.TinyTorchEncoder
    with pytest.raises(ImportError, match="cannot resolve"):
        resolve_reference("@nomodule_xyz.Thing")


@pytest.mark.parametrize("line,error,match", [
    ("a.x = not a literal", ValueError, "unparseable"),
    ("a.x", ValueError, "without '='"),
    ("x = 1", ValueError, "scope.attr"),
])
def test_parse_errors_match_jax(line, error, match):
    with pytest.raises(error, match=match) as got:
        parse_bindings([line])
    with pytest.raises(error) as want:
        jax_bindings.parse_bindings([line])
    assert str(got.value) == str(want.value)


def test_module_attribute():
    assert apply_bindings(params=["tests.test_torch_bindings_fixture.TUNABLE = 2.5"]) == 1
    assert fixture.TUNABLE == 2.5


def test_unknown_module_attribute():
    with pytest.raises(AttributeError, match="no attribute"):
        apply_bindings(params=["tests.test_torch_bindings_fixture.NOPE = 1"])


def test_unknown_target():
    with pytest.raises(ValueError, match="unknown binding target"):
        apply_bindings(params=["no_such_configurable.param = 1"])


def test_configurable_param():
    @configurable(name="torch_fn")
    def torch_fn(a, b=10):
        return a + b

    assert torch_fn(1) == 11
    apply_bindings(params=["torch_fn.b = 100"])
    assert torch_fn(1) == 101
    assert torch_fn(1, b=5) == 6  # an explicit argument beats the binding
    with pytest.raises(ValueError, match="no parameter"):
        apply_bindings(params=["torch_fn.zzz = 1"])


def test_file_then_params_order(tmp_path):
    path = tmp_path / "b.gin"
    path.write_text("tests.test_torch_bindings_fixture.TUNABLE = 3.0\n")
    apply_bindings(files=[str(path)], params=["tests.test_torch_bindings_fixture.TUNABLE = 4.0"])
    assert fixture.TUNABLE == 4.0  # later bindings win


def test_clear_bindings_restores_module_attribute():
    apply_bindings(params=["tests.test_torch_bindings_fixture.TUNABLE = 9.0"])
    assert fixture.TUNABLE == 9.0
    clear_bindings()
    assert fixture.TUNABLE == 1.0


def test_snapshot_replays_in_fresh_state(tmp_path):
    path = tmp_path / "b.gin"
    path.write_text("tests.test_torch_bindings_fixture.TUNABLE = 6.0  # from a file\n")
    apply_bindings(files=[str(path)], params=["tests.test_torch_bindings_fixture.TUNABLE = 7.0"])
    snap = bindings.snapshot_bindings()
    assert snap == ["tests.test_torch_bindings_fixture.TUNABLE = 6.0",
                    "tests.test_torch_bindings_fixture.TUNABLE = 7.0"]
    clear_bindings()
    assert fixture.TUNABLE == 1.0 and bindings.snapshot_bindings() == []
    apply_bindings(params=snap)  # what a spawned worker does
    assert fixture.TUNABLE == 7.0


def test_transitive_import_error_propagates(tmp_path, monkeypatch):
    (tmp_path / "broken_torch_mod.py").write_text("import no_such_dependency_xyz\nX = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ModuleNotFoundError, match="no_such_dependency_xyz"):
        apply_bindings(params=["broken_torch_mod.X = 2"])
    with pytest.raises(ModuleNotFoundError, match="no_such_dependency_xyz"):
        resolve_reference("@broken_torch_mod.X")


# ------------------------------------------------------------ build_encoder

TINY = dict(vocab_size=40, hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=16, relative_vocab_size=49, relative_att_num_core_layers=1,
            compute_dtype="float32", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _encoder_config(encoder_cls=""):
    return EncoderConfig(mmt=MmtEncoderConfig(**TINY), encoder_cls=encoder_cls)


def _inputs(batch=2, seq=12, patches=4, patch_dim=6):
    gen = torch.Generator().manual_seed(0)
    return dict(word_ids=torch.randint(0, 40, (batch, seq), generator=gen),
                patch_embeddings=torch.randn(batch, patches, patch_dim, generator=gen),
                lengths=torch.full((batch,), seq, dtype=torch.int32))


def test_unbound_build_encoder_is_mmt_encoder():
    assert type(build_encoder(_encoder_config(), 2, 6, device="cpu")) is MmtEncoder


@pytest.mark.parametrize("route", ["binding", "qualified_binding", "config", "argument"])
def test_build_encoder_takes_the_custom_class(route):
    if route == "binding":
        apply_bindings(params=[f"build_encoder.encoder_cls = @{ENCODER_PATH}"])
    elif route == "qualified_binding":
        apply_bindings(params=["mmt_tpu_torch.configs.encoder.build_encoder.encoder_cls = "
                               f"@{ENCODER_PATH}"])
    config = _encoder_config(ENCODER_PATH if route == "config" else "")
    kw = {"encoder_cls": fixture.TinyTorchEncoder} if route == "argument" else {}
    enc = build_encoder(config, num_patch_per_row=2, patch_dim=6, device="cpu", **kw)
    assert type(enc) is fixture.TinyTorchEncoder
    assert enc.config == config.mmt and enc.num_patch_per_row == 2
    assert enc.patch_proj.in_features == 6


@pytest.mark.parametrize("model", ["classification", "pretraining"])
@pytest.mark.parametrize("route", ["binding", "config"])
def test_both_models_build_and_run_the_custom_encoder(model, route):
    if route == "binding":
        apply_bindings(params=[f"build_encoder.encoder_cls = @{ENCODER_PATH}"])
    encoder = _encoder_config(ENCODER_PATH if route == "config" else "")
    heads = [ClsHeadConfig(inner_dim=8, num_classes=2, name="itm")]
    inputs = _inputs()
    if model == "classification":
        m = MmtClassificationModel(ClassificationModelConfig(encoder=encoder, cls_heads=heads),
                                   num_patch_per_row=2, patch_dim=6, device="cpu", seed=3)
        out = m(**inputs)
    else:
        m = MmtPretrainingModel(PretrainModelConfig(encoder=encoder, cls_heads=heads),
                                mpp_output_num_classes=8, num_patch_per_row=2, patch_dim=6,
                                device="cpu", seed=3)
        out = m(**inputs, mlm_positions=torch.tensor([[5, 7], [6, 8]]),
                mpp_positions=torch.tensor([[2, 3], [4, 5]]))
        assert out["mlm_logits"].shape == (2, 2, 40) and out["mpp_logits"].shape == (2, 2, 8)
    assert type(m.encoder) is fixture.TinyTorchEncoder
    assert out["sequence_output"].shape == (2, 12, 8) and out["itm_logits"].shape == (2, 2)
    assert torch.isfinite(out["itm_logits"]).all()
    # init_params filled the custom encoder's parameters from the seed too.
    table = m.encoder.word_embeddings.embedding_table
    assert 0 < table.std().item() < 0.05 and m.device == torch.device("cpu")


def test_pretraining_model_needs_a_word_table_to_share():
    apply_bindings(params=["build_encoder.encoder_cls = "
                           "@tests.test_torch_bindings_fixture.NoWordTableEncoder"])
    with pytest.raises(ValueError, match="word_embeddings.embedding_table"):
        MmtPretrainingModel(PretrainModelConfig(encoder=_encoder_config()), device="cpu")


# -------------------------------------------------------------------- CLI


def test_cli_step_with_a_bound_encoder(tmp_path):
    from mmt_tpu_torch.cli.train import main
    from tests.test_torch_finetune import cli_yaml, write_paired_records, write_vocab

    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 16, seed=0)
    config = tmp_path / "itm.yaml"
    config.write_text(yaml.safe_dump(cli_yaml(vocab, train, train, "pallas", steps=1)))
    gin = tmp_path / "encoder.gin"
    gin.write_text(f"build_encoder.encoder_cls = @{ENCODER_PATH}\n")
    state = main(["--experiment=mmt/classification", "--mode=train",
                  f"--model_dir={tmp_path / 'model'}", f"--config_file={config}",
                  f"--gin_file={gin}", "--device=cpu"])
    assert state.step == 1 and type(state.model.encoder) is fixture.TinyTorchEncoder
    assert (tmp_path / "model" / "1" / "model.pt").exists()
    assert "encoder.mix.weight" in state.model.state_dict()


def test_cli_step_with_encoder_cls_in_the_config(tmp_path):
    from mmt_tpu_torch.cli.train import main

    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump({
        "task": {"model": {"encoder": {"encoder_cls": ENCODER_PATH, "mmt": {
            "vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 1,
            "num_attention_heads": 2, "intermediate_size": 64, "relative_vocab_size": 49,
            "relative_att_num_core_layers": 1}},
            "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]},
            "train_data": {"input_path": "dummy", "max_seq_len": 32, "image_size": 32,
                           "patch_size": 16, "global_batch_size": 4,
                           "mlm_max_selections_per_seq": 5, "mpp_max_selections_per_seq": 3}},
        "trainer": {"train_steps": 1, "steps_per_loop": 1, "summary_interval": 1,
                    "micro_batch_size": 2}}))
    state = main(["--experiment=mmt/pretraining", "--mode=train",
                  f"--model_dir={tmp_path / 'model'}", f"--config_file={config}", "--device=cpu",
                  "--gin_params=tests.test_torch_bindings_fixture.TUNABLE = 5.0"])
    assert state.step == 1 and type(state.model.encoder) is fixture.TinyTorchEncoder
    assert fixture.TUNABLE == 5.0


def test_loader_process_sees_a_parent_binding():
    from mmt_tpu_torch.data.prefetch import multiprocess_batches

    apply_bindings(params=["tests.test_torch_bindings_fixture.TUNABLE = 7.0"])
    batches = multiprocess_batches(fixture.TunableLoader(), num_workers=2)
    try:
        got = [next(batches) for _ in range(2)]
    finally:
        batches.close()
    assert [float(b["tunable"][0]) for b in got] == [7.0, 7.0]
    assert sorted(int(b["shard"][0]) for b in got) == [0, 1]
