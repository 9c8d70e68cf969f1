"""Training command line (the port's counterpart of ``mmt_tpu/cli/train.py``).

    python -m mmt_tpu_torch.cli.train --experiment=mmt/classification \
        --mode=train_and_eval --model_dir=/tmp/model --config_file=itm.yaml

Applies the ``--gin_file`` / ``--gin_params`` bindings first
(``utils/bindings.py``; e.g. ``build_encoder.encoder_cls = @my.Encoder``),
then resolves the experiment, applies the yaml files and the string
override (strict keys), writes the merged config to
``<model_dir>/params.yaml`` in the train modes (as JSON, which is valid
YAML, so writing needs no yaml package), builds the task on ``--device``
(default the card) and runs ``run_training``: train summaries (jsonl, and
TensorBoard event files under ``summaries/`` with
``trainer.tensorboard_summaries``), checkpoints with the optimizer state
and the input stream's position (written by a background thread with
``trainer.async_checkpointing``; a rerun of the same command resumes from
the latest), and in ``train_and_eval`` validation summaries with ``auc``
and the best-checkpoint export.  With ``trainer.save_on_preemption`` a
SIGTERM ends the run after the current step with a checkpoint there, and
the command exits 0 ("exiting after preemption checkpoint at step k"); run
again, it resumes at k.

What runs:

* ``--experiment=mmt/pretraining`` (MLM + MPP + ITM) with record inputs
  through ``MmtPretrainLoader``, or ``task.train_data.input_path: dummy``
  (no validation then), and ``--experiment=mmt/classification`` (ITM
  finetuning) with record inputs through ``MmtClassificationLoader``, each
  in the modes ``train``, ``train_and_eval`` and ``eval`` (the latest
  checkpoint in ``--model_dir`` if there is one, else the initial or
  warm-started parameters).  Validation reports the metric pairs' means,
  and for classification ``auc``.  ``trainer.grad_accum_dtype``
  (pretraining's micro-batch sum) is read as JAX reads it:
  float16, bfloat16 or float32 (``train.tasks.accum_dtype``).
* ``--mode=continuous_train_and_eval`` with ``--pretrain_model_dir``:
  ``train.continuous.run_continuous_finetune`` watches that directory and
  finetunes each new checkpoint for ``trainer.train_steps`` steps from the
  fresh initialisation, validates, and appends a line to
  ``<model_dir>/continuous_results.jsonl``; it ends when no new checkpoint
  came for CONTINUOUS_TIMEOUT_S seconds from its start.  As in the JAX
  package, the rounds' batches start after the batch pulled to prime the
  stream.  It runs on every mesh the train modes take (below), with their
  step, their per-rank batches and their sharded optimizer: rank 0 polls
  and broadcasts what it saw, so every rank takes the same rounds, and
  rank 0 alone writes the results.
* ``train_data.num_workers``: 0 runs the loader in this process as a
  checkpointable ``TrainStream`` (a resumed run continues the input stream
  where it stopped); N > 0 runs N loader processes
  (``data.prefetch.multiprocess_batches``), whose stream has no
  ``state()``, so a resumed run restarts it from its beginning, as the JAX
  package's does.  The workers ignore SIGTERM, so a signal sent to the
  whole process group preempts the run cleanly; the command stops them.
* ``task.init_checkpoint``, detected as the JAX package's CLI detects it:
  - a directory with a ``checkpoint`` file: the TF checkpoint it names
    (``tf_bundle.latest_checkpoint``), or a path ``p`` with ``p.index``: a
    TF object checkpoint, read without tensorflow (``train/tf_bundle.py``).
    With word-embedding tables it is a full MMT checkpoint, converted into
    the whole task model (``train/tf_checkpoint.py``; strict unless
    ``--lenient_warm_start``, which keeps the fresh initialisation of what
    it does not match); without them, a ViT: the image-relevant encoder
    tensors are restored, the position grid interpolated, the text tables
    and heads stay fresh (``train/vit_checkpoint.py``).  Local paths only:
    ``gs://`` raises ValueError.
  - anything else: a checkpoint directory this package wrote.  A
    classification model takes the ``encoder.*`` tensors and the heads
    whose names match (``restore_encoder_and_heads``) and keeps the rest of
    its fresh initialisation; a pretraining model takes the whole
    checkpoint.  (``scripts/orbax_to_torch.py`` brings a JAX package
    checkpoint into this form.)
  The warm start logs ``count_restored``, the tensors it filled.

Several processes (one per card; ``torchrun --nproc_per_node=N -m
mmt_tpu_torch.cli.train ...``, or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) train
data-parallel over ``runtime.num_data_parallel`` x
``runtime.num_model_parallel`` ranks (``parallel/mesh.py``; ``nccl`` on the
card, ``gloo`` with ``--device=cpu``).  Parameters are replicated over the
model axis, as the JAX CLI replicates them, and the global batch is split
over the data axis: each rank loads ``global_batch_size / num_data``
examples from its own file shard (``base_shard`` = its data rank), and the
step is the one-process step on the global batch (``train/tasks.py``).
``runtime.zero_sharded_optimizer`` shards the AdamW moments over the data
ranks (``parallel/zero.py``).  Rank 0 writes ``params.yaml``, the
summaries, the checkpoints and the best export; a preemption signal to any
rank checkpoints every rank at the same step.  Validation needs
``trainer.validation_steps > 0`` (every rank runs the same number of
collectives) and gathers the labels, weights and probabilities step-major,
as the JAX CLI does.

``runtime.num_pipeline_stages`` S > 1 trains through the GPipe pipelined
step (``make_pipelined_train_step``, ``parallel/pipeline.py``) on a ('data',
'pipe') mesh of ``num_data_parallel`` (default world / S) x S ranks, rank r
at (r // S, r % S), as the JAX CLI lays it out; the stages of one pipeline
load the same rows.  Micro-batches: ``runtime.num_pipeline_microbatches``,
else ``max(1, global_batch // max(micro_batch_size, 1))`` for pretraining
and 2 for classification.  Validation runs unpipelined.  With
``num_model_parallel > 1`` it raises JAX's ValueError.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

JAX_MODES = ("train", "train_and_eval", "eval", "continuous_train_and_eval")
# continuous_train_and_eval: the watch ends this long after it started once
# no new checkpoint comes (the JAX CLI's 3600 s), polling at this interval
# (JAX's default).
CONTINUOUS_TIMEOUT_S = 3600.0
CONTINUOUS_POLL_S = 10.0


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
    p.add_argument("--gin_file", action="append", default=[],
                   help="binding file(s) of 'target.attr = value' lines (utils/bindings.py)")
    p.add_argument("--gin_params", action="append", default=[],
                   help='inline bindings, e.g. "build_encoder.encoder_cls = @my.Encoder"')
    p.add_argument("--lenient_warm_start", action="store_true",
                   help="convert a TF init_checkpoint that matches the model partly, keeping "
                        "the fresh initialisation of the rest")
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

    if args.mode == "continuous_train_and_eval" and not args.pretrain_model_dir:
        raise ValueError("--mode=continuous_train_and_eval needs --pretrain_model_dir")
    pretraining = isinstance(cfg.task, PretrainingTaskConfig)
    if not pretraining and not isinstance(cfg.task.train_data, MmtClassificationDataConfig):
        raise ValueError(
            f"{args.experiment}: no training loader reads its "
            f"{type(cfg.task.train_data).__name__} (the retrieval experiment runs through "
            f"cli.predict)")
    if not cfg.task.train_data.input_path:
        # An empty pattern matches no file, and a repeating stream would
        # then wait for a record forever.
        raise ValueError("task.train_data.input_path is empty: name the training records")
    if cfg.runtime.num_pipeline_stages > 1 and cfg.runtime.num_model_parallel > 1:
        raise ValueError("num_pipeline_stages > 1 is mutually exclusive with "
                         "num_model_parallel > 1")


def tf_checkpoint_path(path: str):
    """The TF checkpoint prefix ``path`` names, or None for a checkpoint
    directory of this package (``mmt_tpu/cli/train.py:84-101``)."""
    from mmt_tpu_torch.train.tf_bundle import check_local, latest_checkpoint

    if os.path.isdir(check_local(path)):
        return latest_checkpoint(path)
    return path if os.path.exists(path + ".index") else None


def warm_start(task, path: str, strict: bool = True) -> int:
    """Loads ``path`` into ``task.model`` (see the module docstring for the
    kinds of checkpoint); returns the number of tensors restored."""
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig
    from mmt_tpu_torch.train.checkpoint import (
        CheckpointManager,
        count_restored,
        restore_encoder_and_heads,
    )

    tf_path = tf_checkpoint_path(path)
    if tf_path is not None:
        from mmt_tpu_torch.train.tf_checkpoint import convert_tf_checkpoint, load_tf_checkpoint
        from mmt_tpu_torch.train.vit_checkpoint import convert_vit_checkpoint

        tf_vars = load_tf_checkpoint(tf_path)
        assigned = set()
        if any("word_embedding" in k for k in tf_vars):
            state = convert_tf_checkpoint(tf_vars, task.model, strict=strict, assigned=assigned)
            kind = "TF MMT"
        else:
            state = convert_vit_checkpoint(tf_vars, task.model, assigned=assigned)
            kind = "TF ViT"
        task.model.load_state_dict(state)
        logging.info("warm-started from %s checkpoint %s: count_restored=%d tensors", kind,
                     tf_path, len(assigned))
        return len(assigned)

    source = CheckpointManager(path).restore()
    if isinstance(task.config, PretrainingTaskConfig):
        task.model.load_state_dict(source)
        restored = len(source)
    else:
        target = task.model.state_dict()
        task.model.load_state_dict(restore_encoder_and_heads(target, source))
        restored = count_restored(target, source)
    logging.info("warm-started from %s: count_restored=%d tensors", path, restored)
    return restored


def _gather_step_major(mesh, arrays) -> np.ndarray:
    """Each rank's per-step arrays -> every rank's, flattened step-major
    (each step's rows rank-major), as ``mmt_tpu/cli/train.py:335-357``
    orders them."""
    from mmt_tpu_torch.parallel.mesh import all_gather_rows

    gathered = all_gather_rows(mesh, np.stack(arrays))  # [ranks, steps, rows]
    return gathered.transpose(1, 0, 2).reshape(-1)


def make_eval_fn(task, val_cfg, validation_steps: int, device, mesh=None):
    """state -> validation metrics: the metric pairs summed over
    ``validation_steps`` batches (-1: the whole split) and, for
    classification, ``auc``, the AUC-PR of the probabilities against the
    labels and their weights.  With a distributed ``mesh`` each data rank
    reads its own shard of the split (cycled, so that every rank runs
    ``validation_steps`` > 0 batches of ``global / num_data`` rows), the
    metric pairs are the global batches', and the (label, probability,
    weight) triples are gathered step-major."""
    import itertools

    from mmt_tpu_torch.data.loaders import MmtClassificationLoader, MmtPretrainLoader
    from mmt_tpu_torch.eval.metrics_host import auc_pr
    from mmt_tpu_torch.parallel.mesh import local_batch_size
    from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device

    pretraining = isinstance(task, PretrainingTask)
    loader = (MmtPretrainLoader if pretraining else MmtClassificationLoader)(val_cfg)
    multi = mesh is not None and mesh.distributed
    if multi and validation_steps <= 0:
        raise ValueError("several processes need trainer.validation_steps > 0 (every rank "
                         "must run the same number of collectives)")
    eval_step = task.make_eval_step(mesh=mesh if multi else None)

    def batches():
        if not multi:
            return loader.load()
        local = local_batch_size(mesh, val_cfg.global_batch_size)
        return itertools.cycle(loader.load(mesh.data_rank, mesh.num_data, batch_size=local))

    def eval_fn(state):
        sums = {}
        probs, labels, weights = [], [], []
        for i, batch in enumerate(batches()):
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
            if multi:
                labels, probs, weights = (_gather_step_major(mesh, a)
                                          for a in (labels, probs, weights))
            else:
                labels, probs, weights = (np.concatenate(a) for a in (labels, probs, weights))
            result["auc"] = auc_pr(labels, probs, weights)
        return result

    return eval_fn


def train_batches(loader_cls, data_cfg, shard: int = 0, num_shards: int = 1,
                  batch_size=None):
    """The training batches of file shard ``shard`` of ``num_shards``
    (``batch_size`` rows each, default the global batch): a checkpointable
    ``TrainStream`` behind ``ResumablePrefixed`` with ``num_workers`` 0,
    else the worker processes' round-robin stream (no ``state()``), its
    first batch pulled either way; returns (iterator, the worker stream or
    None, to close)."""
    import itertools
    import time

    from mmt_tpu_torch.data.loaders import ResumablePrefixed
    from mmt_tpu_torch.data.prefetch import LoaderShard, multiprocess_batches

    t0 = time.perf_counter()
    if data_cfg.num_workers <= 0:
        stream = ResumablePrefixed(loader_cls(data_cfg).stream(shard, num_shards, batch_size))
        workers = None
        stream.prime()
    else:
        workers = multiprocess_batches(LoaderShard(loader_cls, data_cfg, batch_size),
                                       num_workers=data_cfg.num_workers, base_shard=shard,
                                       total_shards=num_shards)
        stream = itertools.chain([next(workers)], workers)
    logging.info("first batch after %.3f s (%d loader processes)",
                 time.perf_counter() - t0, data_cfg.num_workers)
    return stream, workers


def main(argv=None):
    """Runs the command; returns the final ``TrainState`` (train modes),
    the validation metrics (``--mode=eval``), the results by pretraining
    step (``continuous_train_and_eval``), or None after a preemption."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if args.gin_file or args.gin_params:
        # Before any config or model is built (the reference's order,
        # src/train.py:48).
        from mmt_tpu_torch.utils.bindings import apply_bindings

        logging.info("applied %d gin-style binding(s)",
                     apply_bindings(args.gin_file, args.gin_params))
    cfg = build_experiment_config(args)
    _check_ported(args, cfg)

    from mmt_tpu_torch.configs.base import to_dict
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig
    from mmt_tpu_torch.data.dummy import dummy_pretrain_batches
    from mmt_tpu_torch.data.loaders import MmtClassificationLoader, MmtPretrainLoader
    from mmt_tpu_torch.device import resolve_device
    from mmt_tpu_torch.parallel.mesh import (
        create_mesh,
        create_pipe_mesh,
        init_distributed,
        launched,
        local_batch_size,
    )
    from mmt_tpu_torch.train.tasks import ClassificationTask, PretrainingTask

    if launched():  # one rank of several processes: its device and group
        device = init_distributed(args.device)
    else:
        device = resolve_device(args.device)
    num_pipe = cfg.runtime.num_pipeline_stages
    if num_pipe > 1:  # the ('data', 'pipe') mesh of mmt_tpu/cli/train.py:167-185
        mesh = create_pipe_mesh(cfg.runtime.num_data_parallel, num_pipe)
    else:
        mesh = create_mesh(cfg.runtime.num_data_parallel, cfg.runtime.num_model_parallel)
    logging.info("mesh: %s = %d x %d ranks (rank %d)", mesh.axis_names, mesh.num_data,
                 mesh.num_model * mesh.num_pipe, mesh.rank)
    os.makedirs(args.model_dir, exist_ok=True)
    if args.mode in ("train", "train_and_eval") and mesh.is_chief:
        with open(os.path.join(args.model_dir, "params.yaml"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2, sort_keys=True)

    data_cfg = cfg.task.train_data
    pretraining = isinstance(cfg.task, PretrainingTaskConfig)
    local = local_batch_size(mesh, data_cfg.global_batch_size)
    # The first batch is pulled before the model is built, as the JAX
    # package does; ResumablePrefixed keeps the stream's snapshot right.
    if pretraining and data_cfg.input_path == "dummy":
        train_iter, workers = dummy_pretrain_batches(data_cfg, batch_size=local), None
    else:
        train_iter, workers = train_batches(
            MmtPretrainLoader if pretraining else MmtClassificationLoader, data_cfg,
            mesh.data_rank, mesh.num_data, local)
    try:
        zero1 = cfg.runtime.zero_sharded_optimizer
        if pretraining:
            task = PretrainingTask(cfg.task, cfg.trainer, device=device, seed=args.seed)
            if num_pipe > 1:
                num_micro = cfg.runtime.num_pipeline_microbatches or max(
                    1, data_cfg.global_batch_size // max(cfg.trainer.micro_batch_size, 1))
                train_step = task.make_pipelined_train_step(mesh, num_micro, zero1=zero1)
            else:
                train_step = task.make_train_step(cfg.trainer.micro_batch_size,
                                                  cfg.trainer.grad_accum_dtype, mesh=mesh)
        else:
            task = ClassificationTask(cfg.task, cfg.trainer, device=device, seed=args.seed)
            if num_pipe > 1:
                train_step = task.make_pipelined_train_step(
                    mesh, cfg.runtime.num_pipeline_microbatches or 2, zero1=zero1)
            else:
                train_step = task.make_train_step(mesh=mesh)
        return _run(args, cfg, task, train_step, train_iter, device, mesh)
    finally:
        if workers is not None:
            workers.close()  # stops the loader processes


def _run(args, cfg, task, train_step, train_iter, device, mesh):
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.loop import run_training
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.preemption import TrainingPreempted
    from mmt_tpu_torch.train.tasks import batch_to_device
    from mmt_tpu_torch.train.train_state import TrainState

    continuous = args.mode == "continuous_train_and_eval"
    if continuous:  # each round starts from the fresh initialisation
        fresh = {k: v.to("cpu", copy=True) for k, v in task.model.state_dict().items()}
    if cfg.task.init_checkpoint:
        warm_start(task, cfg.task.init_checkpoint, strict=not args.lenient_warm_start)

    eval_fn = None
    if args.mode != "train" and _has_validation(cfg):
        eval_fn = make_eval_fn(task, cfg.task.validation_data, cfg.trainer.validation_steps,
                               device, mesh)
    place_batch = lambda b: batch_to_device(b, device)  # noqa: E731

    def make_state():
        optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps,
                                     task.model)
        if cfg.runtime.zero_sharded_optimizer:
            from mmt_tpu_torch.parallel.zero import shard_opt_state

            shard_opt_state(mesh, optimizer)
        return TrainState.create(task.model, optimizer)

    if continuous:
        from mmt_tpu_torch.parallel.mesh import broadcast_from_chief
        from mmt_tpu_torch.train.continuous import run_continuous_finetune

        def fresh_state():
            task.model.load_state_dict(fresh)
            return make_state()

        def sync(step, expired):  # rank 0's poll for every rank
            step, expired = broadcast_from_chief(
                [-1 if step is None else step, int(expired)], device)
            return (None if step < 0 else step), bool(expired)

        next(train_iter)  # JAX's rounds start after the batch that primed the stream
        results = run_continuous_finetune(
            pretrain_model_dir=args.pretrain_model_dir, model_dir=args.model_dir,
            make_state=fresh_state, train_step=train_step, train_iter_fn=lambda: train_iter,
            eval_fn=eval_fn, steps_per_checkpoint=cfg.trainer.train_steps, seed=args.seed,
            place_batch=place_batch, poll_interval_s=CONTINUOUS_POLL_S,
            timeout_s=CONTINUOUS_TIMEOUT_S, sync=sync,
            write_results=mesh.is_chief)
        logging.info("continuous finetune results: %s", results)
        return results

    state = make_state()

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

    try:
        state = run_training(
            train_step=train_step, state=state, train_iter=train_iter, trainer=cfg.trainer,
            model_dir=args.model_dir, eval_fn=eval_fn, seed=args.seed, place_batch=place_batch,
        )
    except TrainingPreempted as e:
        # The checkpoint at e.step is durable; rerunning this command resumes there.
        logging.warning("exiting after preemption checkpoint at step %d", e.step)
        return None
    logging.info("training complete")
    return state


if __name__ == "__main__":
    main()
