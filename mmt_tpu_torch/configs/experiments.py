"""Experiment registry and trainer configs (fields of ``mmt_tpu/configs/experiments.py``).

The three experiments of the JAX package load here to the same values.
The port trains ``mmt/pretraining`` (from records or dummy input) and
``mmt/classification`` (ITM finetuning from records), and runs
``mmt/retrieval`` through ``cli.predict``.  ``RuntimeConfig`` keeps the
JAX package's mesh fields for yaml compatibility: the port trains on one
card and refuses the multi-device runtimes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from mmt_tpu_torch.configs.base import Config
from mmt_tpu_torch.configs.data import (
    MmtClassificationDataConfig,
    MmtPretrainDataConfig,
    MmtRetrievalDataConfig,
)
from mmt_tpu_torch.configs.model import ClassificationModelConfig, PretrainModelConfig
from mmt_tpu_torch.configs.optimization import OptimizationConfig, PolynomialLrConfig


@dataclasses.dataclass
class RuntimeConfig(Config):
    num_data_parallel: int = 0
    num_model_parallel: int = 1
    num_pipeline_stages: int = 1
    num_pipeline_microbatches: int = 0
    zero_sharded_optimizer: bool = False
    mixed_precision_dtype: str = "bfloat16"
    enable_xla: bool = True


@dataclasses.dataclass
class TrainerConfig(Config):
    """Training-loop knobs (same fields and defaults as the JAX package).

    ``async_checkpointing``: checkpoints are written by a background thread
    after a copy to host memory; ``tensorboard_summaries``: TensorBoard
    event files beside the jsonl summaries; ``save_on_preemption``: a
    SIGTERM ends the run after the current step with a checkpoint there
    (``train/loop.py``).  ``grad_accum_dtype`` is "float32" or "bfloat16"
    (the micro-batch gradient sum of pretraining); other values raise.
    ``micro_batch_size`` applies to pretraining only: the classification
    step takes the whole batch, as JAX's does.
    """

    train_steps: int = 1000000
    validation_steps: int = -1
    validation_interval: int = 1000
    steps_per_loop: int = 1000
    summary_interval: int = 1000
    checkpoint_interval: int = 1000
    max_to_keep: int = 32
    optimizer_config: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig
    )
    best_checkpoint_export_subdir: str = ""
    best_checkpoint_eval_metric: str = ""
    best_checkpoint_metric_comp: str = "higher"
    # Micro-batch for gradient accumulation (the reference's
    # BATCH_SIZE_PER_REPLICA=64).
    micro_batch_size: int = 64
    async_checkpointing: bool = True
    tensorboard_summaries: bool = True
    save_on_preemption: bool = True
    grad_accum_dtype: str = "float32"


@dataclasses.dataclass
class PretrainingTaskConfig(Config):
    model: PretrainModelConfig = dataclasses.field(default_factory=PretrainModelConfig)
    scale_loss: bool = False
    init_checkpoint: str = ""
    train_data: MmtPretrainDataConfig = dataclasses.field(
        default_factory=MmtPretrainDataConfig
    )
    validation_data: MmtPretrainDataConfig = dataclasses.field(
        default_factory=lambda: MmtPretrainDataConfig(is_training=False)
    )


@dataclasses.dataclass
class ClassificationTaskConfig(Config):
    model: ClassificationModelConfig = dataclasses.field(
        default_factory=ClassificationModelConfig
    )
    init_checkpoint: str = ""
    init_cls_pooler: bool = False
    metric_type: str = "accuracy"  # or "auc"
    label_field: str = "label_ids"
    label_weights_field: str = "label_weights"
    logits_field: str = "logits"
    pos_weights_field: str = "pos_weights"
    train_data: MmtClassificationDataConfig = dataclasses.field(
        default_factory=MmtClassificationDataConfig
    )
    validation_data: MmtClassificationDataConfig = dataclasses.field(
        default_factory=lambda: MmtClassificationDataConfig(is_training=False)
    )


@dataclasses.dataclass
class ExperimentConfig(Config):
    task: Config = dataclasses.field(default_factory=PretrainingTaskConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)


_EXPERIMENT_REGISTRY: Dict[str, Callable[[], ExperimentConfig]] = {}


def register_experiment(name: str, factory: Optional[Callable] = None):
    def deco(fn):
        _EXPERIMENT_REGISTRY[name] = fn
        return fn

    return deco(factory) if factory else deco


def get_experiment_config(name: str) -> ExperimentConfig:
    if name not in _EXPERIMENT_REGISTRY:
        raise KeyError(
            f"Unknown experiment {name!r}; known: {sorted(_EXPERIMENT_REGISTRY)}"
        )
    return _EXPERIMENT_REGISTRY[name]()


@register_experiment("mmt/pretraining")
def mmt_pretraining() -> ExperimentConfig:
    cfg = ExperimentConfig(task=PretrainingTaskConfig())
    cfg.trainer.optimizer_config.polynomial.initial_learning_rate = 1e-4
    return cfg


@register_experiment("mmt/classification")
def mmt_classification() -> ExperimentConfig:
    cfg = ExperimentConfig(task=ClassificationTaskConfig())
    cfg.trainer.optimizer_config.polynomial = PolynomialLrConfig(
        initial_learning_rate=3e-5
    )
    return cfg


@register_experiment("mmt/retrieval")
def mmt_retrieval() -> ExperimentConfig:
    cfg = ExperimentConfig(
        task=ClassificationTaskConfig(
            train_data=MmtRetrievalDataConfig(is_training=True),
            validation_data=MmtRetrievalDataConfig(is_training=False),
        )
    )
    cfg.trainer.optimizer_config.polynomial = PolynomialLrConfig(
        initial_learning_rate=3e-5
    )
    return cfg
