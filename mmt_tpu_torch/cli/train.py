"""Training command line (the port's counterpart of ``mmt_tpu/cli/train.py``).

    python -m mmt_tpu_torch.cli.train --experiment=mmt/classification \
        --mode=train_and_eval --model_dir=/tmp/model --config_file=itm.yaml

Resolves the experiment, applies the yaml files and the string override
(strict keys), writes the merged config to ``<model_dir>/params.yaml`` in
the train modes (as JSON, which is valid YAML, so writing needs no yaml
package), builds the task on ``--device`` (default the card) and runs
``run_training``: train summaries, checkpoints with the optimizer state
and the input stream's position (a rerun of the same command resumes from
the latest), and in ``train_and_eval`` validation summaries with ``auc``
and the best-checkpoint export.

What runs:

* ``--experiment=mmt/pretraining`` (MLM + MPP + ITM) with record inputs
  through ``MmtPretrainLoader``, or ``task.train_data.input_path: dummy``
  (no validation then), and ``--experiment=mmt/classification`` (ITM
  finetuning) with record inputs through ``MmtClassificationLoader``, each
  in the modes ``train``, ``train_and_eval`` and ``eval`` (the latest
  checkpoint in ``--model_dir`` if there is one, else the initial or
  warm-started parameters).  Validation reports the metric pairs' means,
  and for classification ``auc``.
* ``train_data.num_workers``: 0 runs the loader in this process as a
  checkpointable ``TrainStream`` (a resumed run continues the input stream
  where it stopped); N > 0 runs N loader processes
  (``data.prefetch.multiprocess_batches``), whose stream has no
  ``state()``, so a resumed run restarts it from its beginning, as the JAX
  package's does.
* ``task.init_checkpoint``: a checkpoint directory this package wrote.  A
  classification model takes the ``encoder.*`` tensors and the heads whose
  names match (``restore_encoder_and_heads``) and keeps the rest of its
  fresh initialisation; a pretraining model takes the whole checkpoint.

Everything else raises NotImplementedError naming what is missing: TF and
ViT checkpoints, ``continuous_train_and_eval``, and pipeline,
model-parallel or ZeRO runtimes.  ``--lenient_warm_start`` (it concerns TF
checkpoints) and ``--pretrain_model_dir`` (for
``continuous_train_and_eval``) are accepted so that the JAX package's
command lines parse.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

JAX_MODES = ("train", "train_and_eval", "eval", "continuous_train_and_eval")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", required=True, help="registry name, e.g. mmt/pretraining")
    p.add_argument("--mode", default="train", choices=JAX_MODES)
    p.add_argument("--pretrain_model_dir", default="")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config_file", action="append", default=[])
    p.add_argument("--params_override", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lenient_warm_start", action="store_true")
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


def _has_validation(cfg) -> bool:
    return cfg.task.validation_data.input_path not in ("", "dummy")


def _check_ported(args, cfg) -> None:
    from mmt_tpu_torch.configs.data import MmtClassificationDataConfig
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig

    if args.mode == "continuous_train_and_eval":
        raise NotImplementedError(
            "--mode=continuous_train_and_eval: continuous finetuning "
            "(train/continuous.py) is not ported yet")
    pretraining = isinstance(cfg.task, PretrainingTaskConfig)
    if not pretraining and not isinstance(cfg.task.train_data, MmtClassificationDataConfig):
        raise NotImplementedError(
            f"{args.experiment}: training on {type(cfg.task.train_data).__name__} is not "
            f"ported (the retrieval experiment runs through cli.predict)")
    if not cfg.task.train_data.input_path:
        # An empty pattern matches no file, and a repeating stream would
        # then wait for a record forever.
        raise ValueError("task.train_data.input_path is empty: name the training records")
    rt = cfg.runtime
    if rt.num_pipeline_stages > 1 or rt.num_model_parallel > 1 or rt.zero_sharded_optimizer:
        raise NotImplementedError("pipeline, model-parallel and ZeRO runtimes are not ported yet")


def _checkpoint_dir(path: str) -> str:
    """``path`` if it is a checkpoint directory of this package; TF object
    checkpoints (the reference's and the ViT warm starts) raise."""
    if os.path.exists(os.path.join(path, "checkpoint")) or os.path.exists(path + ".index"):
        raise NotImplementedError(
            f"task.init_checkpoint={path!r} is a TF checkpoint: TF and ViT warm starts "
            f"(train/tf_checkpoint.py, train/vit_checkpoint.py) are not ported yet")
    return path


def warm_start(task, path: str) -> int:
    """Loads ``path`` (a checkpoint directory of this package, its latest
    step) into ``task.model``; returns the number of tensors restored."""
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig
    from mmt_tpu_torch.train.checkpoint import (
        CheckpointManager,
        count_restored,
        restore_encoder_and_heads,
    )

    source = CheckpointManager(_checkpoint_dir(path)).restore()
    if isinstance(task.config, PretrainingTaskConfig):
        task.model.load_state_dict(source)
        restored = len(source)
    else:
        target = task.model.state_dict()
        task.model.load_state_dict(restore_encoder_and_heads(target, source))
        restored = count_restored(target, source)
    logging.info("warm-started from %s: count_restored=%d tensors", path, restored)
    return restored


def make_eval_fn(task, val_cfg, validation_steps: int, device):
    """state -> validation metrics: the metric pairs summed over
    ``validation_steps`` batches (-1: the whole split) and, for
    classification, ``auc``, the AUC-PR of the probabilities against the
    labels and their weights."""
    from mmt_tpu_torch.data.loaders import MmtClassificationLoader, MmtPretrainLoader
    from mmt_tpu_torch.eval.metrics_host import auc_pr
    from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device

    pretraining = isinstance(task, PretrainingTask)
    loader = (MmtPretrainLoader if pretraining else MmtClassificationLoader)(val_cfg)
    eval_step = task.make_eval_step()

    def eval_fn(state):
        sums = {}
        probs, labels, weights = [], [], []
        for i, batch in enumerate(loader.load()):
            if validation_steps > 0 and i >= validation_steps:
                break
            metrics = eval_step(batch_to_device(batch, device))
            if not pretraining:
                metrics, batch_probs = metrics
                probs.append(batch_probs.cpu().numpy())
                labels.append(batch["label_ids"])
                weights.append(batch["label_weights"])
            for name, (total, count) in metrics.items():
                prev = sums.get(name, (0.0, 0.0))
                sums[name] = (prev[0] + float(total), prev[1] + float(count))
        result = {n: (t / c if c else 0.0) for n, (t, c) in sums.items()}
        if probs:
            result["auc"] = auc_pr(np.concatenate(labels), np.concatenate(probs),
                                   np.concatenate(weights))
        return result

    return eval_fn


def train_batches(loader_cls, data_cfg):
    """The training batches: a checkpointable ``TrainStream`` behind
    ``ResumablePrefixed`` with ``num_workers`` 0, else the worker
    processes' round-robin stream (no ``state()``), its first batch pulled
    either way; returns (iterator, the worker stream or None, to close)."""
    import itertools
    import time

    from mmt_tpu_torch.data.loaders import ResumablePrefixed
    from mmt_tpu_torch.data.prefetch import LoaderShard, multiprocess_batches

    t0 = time.perf_counter()
    if data_cfg.num_workers <= 0:
        stream, workers = ResumablePrefixed(loader_cls(data_cfg).stream()), None
        stream.prime()
    else:
        workers = multiprocess_batches(LoaderShard(loader_cls, data_cfg),
                                       num_workers=data_cfg.num_workers)
        stream = itertools.chain([next(workers)], workers)
    logging.info("first batch after %.3f s (%d loader processes)",
                 time.perf_counter() - t0, data_cfg.num_workers)
    return stream, workers


def main(argv=None):
    """Runs the command; returns the final ``TrainState`` (train modes) or
    the validation metrics (``--mode=eval``)."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = build_experiment_config(args)
    _check_ported(args, cfg)

    from mmt_tpu_torch.configs.base import to_dict
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig
    from mmt_tpu_torch.data.dummy import dummy_pretrain_batches
    from mmt_tpu_torch.data.loaders import MmtClassificationLoader, MmtPretrainLoader
    from mmt_tpu_torch.device import resolve_device
    from mmt_tpu_torch.train.tasks import ClassificationTask, PretrainingTask

    device = resolve_device(args.device)
    os.makedirs(args.model_dir, exist_ok=True)
    if args.mode in ("train", "train_and_eval"):
        with open(os.path.join(args.model_dir, "params.yaml"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2, sort_keys=True)

    data_cfg = cfg.task.train_data
    pretraining = isinstance(cfg.task, PretrainingTaskConfig)
    # The first batch is pulled before the model is built, as the JAX
    # package does; ResumablePrefixed keeps the stream's snapshot right.
    if pretraining and data_cfg.input_path == "dummy":
        train_iter, workers = dummy_pretrain_batches(data_cfg), None
    else:
        train_iter, workers = train_batches(
            MmtPretrainLoader if pretraining else MmtClassificationLoader, data_cfg)
    try:
        if pretraining:
            task = PretrainingTask(cfg.task, cfg.trainer, device=device, seed=args.seed)
            train_step = task.make_train_step(cfg.trainer.micro_batch_size,
                                              cfg.trainer.grad_accum_dtype)
        else:
            task = ClassificationTask(cfg.task, cfg.trainer, device=device, seed=args.seed)
            train_step = task.make_train_step()
        return _run(args, cfg, task, train_step, train_iter, device)
    finally:
        if workers is not None:
            workers.close()  # stops the loader processes


def _run(args, cfg, task, train_step, train_iter, device):
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.loop import run_training
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import batch_to_device
    from mmt_tpu_torch.train.train_state import TrainState

    if cfg.task.init_checkpoint:
        warm_start(task, cfg.task.init_checkpoint)

    eval_fn = None
    if args.mode in ("train_and_eval", "eval") and _has_validation(cfg):
        eval_fn = make_eval_fn(task, cfg.task.validation_data, cfg.trainer.validation_steps,
                               device)

    optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps,
                                 task.model)
    state = TrainState.create(task.model, optimizer)

    if args.mode == "eval":
        if eval_fn is None:
            raise ValueError("--mode=eval needs task.validation_data.input_path")
        ckpt = CheckpointManager(args.model_dir)
        if ckpt.latest_step() is not None:
            task.model.load_state_dict(ckpt.restore())
            logging.info("evaluating checkpoint %d of %s", ckpt.latest_step(), args.model_dir)
        metrics = eval_fn(state)
        logging.info("eval: %s", metrics)
        print(metrics)
        return metrics

    state = run_training(
        train_step=train_step, state=state, train_iter=train_iter, trainer=cfg.trainer,
        model_dir=args.model_dir, eval_fn=eval_fn, seed=args.seed,
        place_batch=lambda b: batch_to_device(b, device),
    )
    logging.info("training complete")
    return state


if __name__ == "__main__":
    main()
