#!/usr/bin/env python3
"""Brings a checkpoint of the JAX package (``mmt_tpu``, Orbax) to the port.

    python scripts/orbax_to_torch.py --orbax_dir=JAX_MODEL_DIR \
        --experiment=mmt/classification --config_file=exp.yaml \
        [--params_override=...] [--step=N] --out=TORCH_DIR

Restores ``params`` of step N (default the latest) with
``mmt_tpu.train.checkpoint.CheckpointManager``, builds the port's model of
the same experiment (``--experiment``, ``--config_file`` and
``--params_override`` as the train and predict command lines take them),
converts with ``mmt_tpu_torch.convert.params_from_flax`` (every name and
shape checked against the model) and writes ``TORCH_DIR/<step>/model.pt``
with the port's ``CheckpointManager``: a directory that ``cli.predict
--init_checkpoint`` and ``task.init_checkpoint`` read.

It runs where jax and orbax are installed (it imports the JAX package,
which is why it lives outside ``mmt_tpu_torch``); the directory it writes
needs neither.  The restore runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--orbax_dir", required=True, help="a model directory the JAX package wrote")
    p.add_argument("--step", type=int, default=None, help="default: the latest step")
    p.add_argument("--experiment", default="mmt/classification")
    p.add_argument("--config_file", action="append", default=[])
    p.add_argument("--params_override", default="")
    p.add_argument("--out", required=True, help="the port's checkpoint directory to write")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Converts and writes the checkpoint; returns the written file."""
    args = parse_args(argv)
    import numpy as np

    from mmt_tpu.train.checkpoint import CheckpointManager as OrbaxCheckpoints
    from mmt_tpu_torch.cli.train import build_experiment_config
    from mmt_tpu_torch.configs.experiments import PretrainingTaskConfig
    from mmt_tpu_torch.convert import params_from_flax
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask, PretrainingTask

    source = OrbaxCheckpoints(args.orbax_dir)
    step = args.step if args.step is not None else source.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {os.path.abspath(args.orbax_dir)}")
    params = source.restore(step)["params"]  # untyped: nested dicts of arrays
    tree = _numpy_tree(params, np)

    cfg = build_experiment_config(args)
    task_cls = PretrainingTask if isinstance(cfg.task, PretrainingTaskConfig) else \
        ClassificationTask
    task = task_cls(cfg.task, cfg.trainer, device="cpu")
    task.model.load_state_dict(params_from_flax(tree, task.model))
    CheckpointManager(args.out).save(step, task.model)
    path = os.path.join(os.path.abspath(args.out), str(step), "model.pt")
    logging.info("wrote step %d of %s (%d tensors) to %s", step, args.orbax_dir,
                 len(task.model.state_dict()), path)
    return path


def _numpy_tree(tree, np):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, np) for k, v in tree.items()}
    return np.asarray(tree)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
