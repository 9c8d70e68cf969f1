"""The port's configs load the JAX package's yaml to the same field values."""

from pathlib import Path

import pytest
import yaml

from mmt_tpu.configs import ClassificationModelConfig as JaxModelConfig
from mmt_tpu.configs import MmtEncoderConfig as JaxEncoderConfig
from mmt_tpu.configs.base import from_yaml_file as jax_from_yaml_file
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.configs.base import parse_params_override as jax_parse_params_override
from mmt_tpu_torch.configs import (
    ClassificationModelConfig,
    MmtEncoderConfig,
    from_yaml_file,
    override,
    parse_params_override,
)

FINETUNE_YAMLS = sorted((Path(__file__).resolve().parent.parent / "configs" / "exp_yamls"
                         / "finetune").rglob("*.yaml"))


def test_defaults_equal():
    assert MmtEncoderConfig().as_dict() == JaxEncoderConfig().as_dict()
    assert ClassificationModelConfig().as_dict() == JaxModelConfig().as_dict()


@pytest.mark.parametrize("path", FINETUNE_YAMLS, ids=lambda p: p.stem)
def test_finetune_model_section_loads_equal(path):
    model_section = yaml.safe_load(path.read_text())["task"]["model"]
    got = override(ClassificationModelConfig(), model_section)
    want = jax_override(JaxModelConfig(), model_section)
    assert got.as_dict() == want.as_dict()
    assert got.cls_heads[0].name == "itm"


def test_from_yaml_file_equal(tmp_path):
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(yaml.safe_load(FINETUNE_YAMLS[0].read_text())["task"]["model"]))
    got = from_yaml_file(ClassificationModelConfig(), str(path))
    assert got.as_dict() == jax_from_yaml_file(JaxModelConfig(), str(path)).as_dict()
    path.write_text("encoder:\n  mmt:\n    nope: 1\n")
    with pytest.raises(KeyError, match="Unknown config key: encoder.mmt.nope"):
        from_yaml_file(ClassificationModelConfig(), str(path))


def test_params_override_strict():
    text = "encoder.mmt.attention_impl=pallas,encoder.mmt.num_hidden_layers=2"
    got = parse_params_override(ClassificationModelConfig(), text)
    want = jax_parse_params_override(JaxModelConfig(), text)
    assert got.as_dict() == want.as_dict()
    assert got.encoder.mmt.attention_impl == "pallas"
    with pytest.raises(KeyError, match="Unknown config key: encoder.mmt.nope"):
        parse_params_override(ClassificationModelConfig(), "encoder.mmt.nope=1")


PRETRAIN_YAMLS = sorted((Path(__file__).resolve().parent.parent / "configs" / "exp_yamls"
                         / "pretrain").rglob("*.yaml"))


def test_experiment_defaults_equal():
    from mmt_tpu.configs import get_experiment_config as jax_get_experiment_config
    from mmt_tpu_torch.configs import get_experiment_config

    got = get_experiment_config("mmt/pretraining").as_dict()
    assert got == jax_get_experiment_config("mmt/pretraining").as_dict()
    with pytest.raises(NotImplementedError, match="not ported"):
        get_experiment_config("mmt/classification")
    with pytest.raises(KeyError, match="Unknown experiment"):
        get_experiment_config("mmt/nope")


@pytest.mark.parametrize("path", PRETRAIN_YAMLS, ids=lambda p: p.stem)
def test_pretrain_yaml_loads_equal(path):
    from mmt_tpu.configs import get_experiment_config as jax_get_experiment_config
    from mmt_tpu_torch.configs import get_experiment_config

    got = from_yaml_file(get_experiment_config("mmt/pretraining"), str(path))
    want = jax_from_yaml_file(jax_get_experiment_config("mmt/pretraining"), str(path))
    assert got.as_dict() == want.as_dict()
    data = got.task.train_data
    assert (data.num_patch_per_row, data.num_patches) == (14, 196)


def test_chip_smoke_config_is_the_wit_2d_yaml():
    """chip_smoke.py builds mlm_itm_2d.yaml in Python (the card's machine has
    no yaml); it differs only in the input paths and the run's length."""
    import chip_smoke
    from mmt_tpu_torch.configs import get_experiment_config

    path = next(p for p in PRETRAIN_YAMLS if p.stem == "mlm_itm_2d")
    want = from_yaml_file(get_experiment_config("mmt/pretraining"), str(path)).as_dict()
    got = chip_smoke.pretrain_experiment().as_dict()
    for section in (want, got):
        section["task"]["train_data"].update(input_path=None, vocab_filename=None,
                                             text_special_token_field_dict=None)
        section["task"]["validation_data"] = None
        for key in ("train_steps", "steps_per_loop", "summary_interval"):
            section["trainer"][key] = None
    assert got == want
