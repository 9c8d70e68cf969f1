"""Typed configuration: dataclasses with strict yaml / dict overrides."""

from mmt_tpu_torch.configs.base import (  # noqa: F401
    Config,
    from_yaml_file,
    override,
    parse_params_override,
    to_dict,
)
from mmt_tpu_torch.configs.data import (  # noqa: F401
    MmtClassificationDataConfig,
    MmtDataConfig,
    MmtPretrainDataConfig,
    MmtRetrievalDataConfig,
)
from mmt_tpu_torch.configs.encoder import EncoderConfig, MmtEncoderConfig  # noqa: F401
from mmt_tpu_torch.configs.experiments import (  # noqa: F401
    ClassificationTaskConfig,
    ExperimentConfig,
    PretrainingTaskConfig,
    RuntimeConfig,
    TrainerConfig,
    get_experiment_config,
    register_experiment,
)
from mmt_tpu_torch.configs.model import (  # noqa: F401
    ClassificationModelConfig,
    ClsHeadConfig,
    PretrainModelConfig,
)
from mmt_tpu_torch.configs.optimization import (  # noqa: F401
    AdamWConfig,
    OptimizationConfig,
    PolynomialLrConfig,
    PolynomialWarmupConfig,
)
