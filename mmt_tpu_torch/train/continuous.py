"""Continuous finetuning: watch a pretraining directory, finetune each checkpoint.

The port's counterpart of ``mmt_tpu/train/continuous.py``: the reference's
``--mode=continuous_train_and_eval`` (``src/train.py:57-59``, delegating
to TFM's ``continuous_finetune_lib``).  Poll a pretraining ``model_dir``
for its latest checkpoint; for each new one, start from a fresh
``TrainState`` (the same fresh head initialisation every round, a fresh
optimizer), restore the encoder and the matching heads into it, train
``steps_per_checkpoint`` steps from the one training iterator that goes on
across rounds, evaluate, and append the metrics with ``pretrain_step`` to
``<model_dir>/continuous_results.jsonl``.

Across processes every rank must take the same rounds, or the collectives
of a round hang: a checkpoint that lands between two ranks' polls would
send them into different rounds, as would two clocks passing the deadline
at different polls.  So with ``sync`` each poll's reading (the latest step,
whether the deadline passed) is rank 0's, broadcast to every rank, and only
the rank with ``write_results`` appends to the results file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Set, Tuple

from mmt_tpu_torch.models import DropoutRngs
from mmt_tpu_torch.train.checkpoint import (
    CheckpointManager,
    count_restored,
    restore_encoder_and_heads,
)

logger = logging.getLogger("mmt_tpu_torch")


def run_continuous_finetune(
    *,
    pretrain_model_dir: str,
    model_dir: str,
    make_state: Callable[[], "object"],
    train_step: Callable,
    train_iter_fn: Callable[[], "object"],
    eval_fn: Optional[Callable],
    steps_per_checkpoint: int,
    seed: int = 0,
    place_batch: Callable = lambda b: b,
    poll_interval_s: float = 10.0,
    timeout_s: float = 0.0,
    stop_after: int = 0,
    sync: Optional[Callable[[Optional[int], bool], Tuple[Optional[int], bool]]] = None,
    write_results: bool = True,
) -> Dict[int, Dict[str, float]]:
    """Returns {pretrain_step: eval metrics} for every checkpoint finetuned.

    ``make_state`` returns a fresh ``TrainState``; the previous round's is
    dropped first, so one model and one optimizer state live at a time.
    Step ``i`` of a round draws its dropout streams from (``seed``, ``i``)
    (JAX's ``fold_in(rng, i)``).  Only the latest checkpoint is watched: one
    that is superseded before a poll sees it is skipped.  The loop ends
    after ``stop_after`` rounds, or when it is idle past ``timeout_s``
    seconds from its start; with neither it runs the checkpoint there is
    (if any) and ends.  ``sync`` maps this rank's poll, (latest step or
    None, deadline passed), to the one every rank acts on (module
    docstring); ``write_results`` False leaves the results file to another
    rank.
    """
    pretrain_ckpt = CheckpointManager(pretrain_model_dir)
    seen: Set[int] = set()
    results: Dict[int, Dict[str, float]] = {}
    deadline = time.time() + timeout_s if timeout_s else None
    os.makedirs(model_dir, exist_ok=True)

    while True:
        step = pretrain_ckpt.latest_step()
        expired = bool(deadline and time.time() > deadline)
        if sync is not None:
            step, expired = sync(step, expired)
        if step is None or step in seen:
            if stop_after and len(seen) >= stop_after:
                break
            if expired:
                break
            if not timeout_s and not stop_after:
                break
            time.sleep(poll_interval_s)
            continue
        seen.add(step)
        logger.info("continuous finetune: pretrain checkpoint %d", step)

        state = None  # the previous round's model and optimizer state go first
        state = make_state()
        target = state.model.state_dict()
        restored = pretrain_ckpt.restore(step)
        state.model.load_state_dict(restore_encoder_and_heads(target, restored))
        logger.info("continuous finetune @ %d: count_restored=%d tensors", step,
                    count_restored(target, restored))
        del target, restored

        device = next(state.model.parameters()).device
        train_iter = iter(train_iter_fn())
        for i in range(steps_per_checkpoint):
            batch = place_batch(next(train_iter))
            state, _ = train_step(state, batch, DropoutRngs.for_step(seed, i, device))
            del batch

        eval_metrics = eval_fn(state) if eval_fn else {}
        eval_metrics["pretrain_step"] = step
        results[step] = eval_metrics
        if write_results:
            with open(os.path.join(model_dir, "continuous_results.jsonl"), "a") as f:
                f.write(json.dumps(eval_metrics) + "\n")
        logger.info("continuous finetune @ %d: %s", step, eval_metrics)

        if stop_after and len(seen) >= stop_after:
            break
    return results
