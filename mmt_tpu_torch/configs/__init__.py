"""Typed configuration: dataclasses with strict yaml / dict overrides."""

from mmt_tpu_torch.configs.base import (  # noqa: F401
    Config,
    from_yaml_file,
    override,
    parse_params_override,
    to_dict,
)
from mmt_tpu_torch.configs.encoder import EncoderConfig, MmtEncoderConfig  # noqa: F401
from mmt_tpu_torch.configs.model import (  # noqa: F401
    ClassificationModelConfig,
    ClsHeadConfig,
)
