"""Training command line (the port's subset of ``mmt_tpu/cli/train.py``).

    python -m mmt_tpu_torch.cli.train --experiment=mmt/pretraining \
        --mode=train --model_dir=/tmp/model --config_file=exp.yaml \
        --params_override='task.train_data.input_path=dummy'

Resolves the experiment, applies the yaml files and the string override
(strict keys), writes the merged config to ``<model_dir>/params.yaml``
(as JSON, which is valid YAML, so writing needs no yaml package), builds
``PretrainingTask`` on ``--device`` (default the card) and runs
``run_training``, which writes ``train_summaries.jsonl``.

What runs: ``--experiment=mmt/pretraining --mode=train`` with
``task.train_data.input_path: dummy``.  Everything else raises
NotImplementedError naming what is missing: other modes (eval,
train_and_eval, continuous_train_and_eval), other experiments
(classification, retrieval), record inputs (the loaders), warm starts
(``task.init_checkpoint``) and multi-stage runtimes.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

PORTED_MODES = ("train",)
JAX_MODES = ("train", "train_and_eval", "eval", "continuous_train_and_eval")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", required=True, help="registry name, e.g. mmt/pretraining")
    p.add_argument("--mode", default="train", choices=JAX_MODES)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config_file", action="append", default=[])
    p.add_argument("--params_override", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_experiment_config(args):
    from mmt_tpu_torch.configs import get_experiment_config
    from mmt_tpu_torch.configs.base import from_yaml_file, parse_params_override

    cfg = get_experiment_config(args.experiment)
    for path in args.config_file:
        cfg = from_yaml_file(cfg, path, strict=True)
    if args.params_override:
        cfg = parse_params_override(cfg, args.params_override, strict=True)
    return cfg


def _check_ported(args, cfg) -> None:
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig

    if args.mode not in PORTED_MODES:
        raise NotImplementedError(
            f"--mode={args.mode} is not ported yet (validation, eval and continuous "
            f"finetuning need the record loaders and checkpoints)")
    if not isinstance(cfg.task, PretrainingTaskConfig):
        raise NotImplementedError(
            f"task {type(cfg.task).__name__}: finetuning is not ported yet (the "
            f"classification and retrieval experiments run through cli.predict only)")
    if cfg.task.train_data.input_path != "dummy":
        raise NotImplementedError(
            f"train_data.input_path={cfg.task.train_data.input_path!r}: the record "
            f"loaders (MmtPretrainLoader, the text pipeline) are not ported yet; "
            f"only 'dummy' runs")
    if cfg.task.init_checkpoint:
        raise NotImplementedError("task.init_checkpoint: warm starts are not ported yet")
    rt = cfg.runtime
    if rt.num_pipeline_stages > 1 or rt.num_model_parallel > 1 or rt.zero_sharded_optimizer:
        raise NotImplementedError("pipeline, model-parallel and ZeRO runtimes are not ported yet")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = build_experiment_config(args)
    _check_ported(args, cfg)

    from mmt_tpu_torch.configs.base import to_dict
    from mmt_tpu_torch.data.dummy import dummy_pretrain_batches
    from mmt_tpu_torch.device import resolve_device
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.loop import run_training
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device
    from mmt_tpu_torch.train.train_state import TrainState

    device = resolve_device(args.device)
    os.makedirs(args.model_dir, exist_ok=True)
    with open(os.path.join(args.model_dir, "params.yaml"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2, sort_keys=True)

    task = PretrainingTask(cfg.task, cfg.trainer, device=device, seed=args.seed)
    optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps,
                                 task.model)
    state = TrainState.create(task.model, optimizer)
    train_step = task.make_train_step(cfg.trainer.micro_batch_size,
                                      cfg.trainer.grad_accum_dtype)
    rngs = DropoutRngs(host=torch.Generator().manual_seed(args.seed),
                       device=torch.Generator(device).manual_seed(args.seed))
    run_training(
        train_step=train_step, state=state,
        train_iter=dummy_pretrain_batches(cfg.task.train_data),
        trainer=cfg.trainer, model_dir=args.model_dir, rngs=rngs,
        place_batch=lambda b: batch_to_device(b, device),
    )
    logging.info("training complete")


if __name__ == "__main__":
    main()
