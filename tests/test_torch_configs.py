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
