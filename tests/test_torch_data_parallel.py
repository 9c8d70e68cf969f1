"""Data-parallel training and ZeRO-1 over ``gloo`` against the JAX package.

Four CPU processes (``parallel.launch.run_local``; the ranks' code is
``tests/torch_gloo_workers.py``) take one pretraining step (MLM + MPP +
ITM, two micro-batches of 8, label weights that differ between ranks) of
the tiny model of ``tests/test_torch_train.py`` on their slices of a global
batch of 16 (4 rows each: micro-batch 0 spans ranks 0-1, micro-batch 1
ranks 2-3).  The reference is JAX's ``make_train_step(mesh=create_mesh(8,
1), micro_batch_size=8)`` on the global batch (dense attention, dropout
off), as ``tests/test_zero.py`` runs it:

* the loss within 1e-6 relative (``tests/test_zero.py``'s bound) and the
  other metrics within 1e-5 (``tests/test_torch_train.py``'s);
* the gradients the optimizer receives within 1e-4 of each tensor's norm
  plus 1e-6 of the whole gradient's (``tests/test_torch_train.py``'s bound
  for the port's one-process step against JAX's);
* with ZeRO-1 the parameters bit-equal to the replicated step's on every
  rank, and every moment whose leading dimension divides by 4 held as a
  quarter on each rank;
* the ZeRO-1 checkpoint (written by rank 0 from the gathered moments)
  restores in one process to the replicated AdamW's parameters and moments
  bit for bit, and in four ranks to each rank's slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmt_tpu.parallel import create_mesh, shard_batch
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.parallel.launch import run_local
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.train_state import TrainState
from tests import torch_gloo_workers
from tests.test_torch_train import (
    _TASK_CFG,
    _assert_trees_close,
    _batch,
    _bridged,
    _jax_task,
    _to_port_names,
    _torch_task,
)

RANKS, GLOBAL, MICRO = 4, 16, 8
TRAINER = {"train_steps": 3, "micro_batch_size": MICRO}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data_parallel")
    jax_task, task = _jax_task(MICRO), _torch_task(MICRO)
    params = _bridged(task, jax_task)
    initial = {k: v.clone() for k, v in task.model.state_dict().items()}
    torch.save(initial, tmp / "params.pt")
    batch = _batch(seed=3, batch=GLOBAL)
    batch["itm_label_ids"] = np.tile(np.asarray([1, 0, 1, 1], np.int32), GLOBAL // 4)
    weights = batch["mlm_label_weights"]
    assert len({float(weights[r * 4:(r + 1) * 4].sum()) for r in range(RANKS)}) > 1

    mesh = create_mesh(num_data=8, num_model=1)
    with mesh:
        jstep = jax_task.make_train_step(mesh=mesh, micro_batch_size=MICRO)
        jnew, jmetrics = jstep(JaxTrainState.create(params, optax.sgd(1.0)),
                               shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                               jax.random.PRNGKey(0))
    want_grads = _to_port_names(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, jnew.params), task.model)
    want_metrics = {k: float(t) / float(c) for k, (t, c) in jmetrics.items()}
    ranks = run_local(torch_gloo_workers.data_parallel_step, RANKS, _TASK_CFG, TRAINER,
                      str(tmp / "params.pt"), batch, str(tmp / "ckpt"))
    return {"ranks": ranks, "want_grads": want_grads, "want_metrics": want_metrics,
            "task": task, "initial": initial, "ckpt": str(tmp / "ckpt")}


def test_data_parallel_step_matches_jax_mesh_step(run):
    for rank in run["ranks"]:
        got = rank["replicated"]
        metrics = {k: t / c for k, (t, c) in got["metrics"].items()}
        np.testing.assert_allclose(metrics["total_loss"], run["want_metrics"]["total_loss"],
                                   rtol=1e-6, atol=0)
        for name, want in run["want_metrics"].items():
            np.testing.assert_allclose(metrics[name], want, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        _assert_trees_close(got["grads"], run["want_grads"], 1e-4, floor=1e-6)


def test_zero1_params_bit_equal_to_replicated_and_moments_sharded(run):
    first = run["ranks"][0]["zero1"]["params"]
    shapes = {n: p.shape for n, p in run["task"].model.named_parameters()}
    for rank in run["ranks"]:
        for name, p in rank["zero1"]["params"].items():
            np.testing.assert_array_equal(p, rank["replicated"]["params"][name], err_msg=name)
            np.testing.assert_array_equal(p, first[name], err_msg=name)
        rows = rank["zero1"]["local_moment_rows"]
        divisible = {n for n, s in shapes.items() if len(s) and s[0] % RANKS == 0}
        assert set(rows) == divisible and divisible
        assert all(rows[n] == shapes[n][0] // RANKS for n in rows)
        assert rank["replicated"]["local_moment_rows"] == {}


def test_zero1_checkpoint_restores_in_one_process_and_in_four(run):
    task = run["task"]
    # One process: the replicated AdamW on the same gradients.
    task.model.load_state_dict(run["initial"])
    replicated = create_optimizer(task.trainer.optimizer_config, task.trainer.train_steps,
                                  task.model)
    for name, p in task.model.named_parameters():
        p.grad = torch.from_numpy(run["ranks"][0]["zero1"]["grads"][name])
    replicated.step()
    want_params = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    want_state = replicated.state_dict()
    fresh = create_optimizer(task.trainer.optimizer_config, task.trainer.train_steps, task.model)
    state = CheckpointManager(run["ckpt"]).restore_train_state(
        TrainState.create(task.model, fresh))
    assert state.step == 1 and fresh.count == 1
    for name, p in task.model.named_parameters():
        assert torch.equal(p, want_params[name]), name
    for key in ("mu", "nu"):
        for name in want_state[key]:
            assert torch.equal(fresh.state_dict()[key][name], want_state[key][name]), name
    for rank in run["ranks"]:
        assert rank["restored_slices_equal"] and rank["restored_count"] == 1


# ---------------------------------------------------- dropout across ranks

DROPOUT = {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}


def _dropout_cases(tmp):
    """(id, kind, task_cfg, trainer, params_path, batch, seed): pretraining
    with micro-batches that span two ranks and with two micro-batches on
    each rank, and the classification step (one micro-batch over all
    ranks), every dropout (hidden, embedding, attention, head) at 0.1."""
    from tests.test_torch_finetune import ENCODER as CLS_ENCODER
    from tests.test_torch_finetune import make_batch, task_dict
    from mmt_tpu_torch.configs import ClassificationTaskConfig, TrainerConfig, override
    from mmt_tpu_torch.train.tasks import ClassificationTask

    pre = {**_TASK_CFG, "model": {
        "encoder": {"mmt": {**_TASK_CFG["model"]["encoder"]["mmt"], **DROPOUT}},
        "cls_heads": [{**h, "dropout_rate": 0.1} for h in _TASK_CFG["model"]["cls_heads"]]}}
    cls = task_dict(2)
    cls["model"]["encoder"]["mmt"] = {**CLS_ENCODER, **DROPOUT}
    cls["model"]["cls_heads"] = [{**h, "dropout_rate": 0.1} for h in cls["model"]["cls_heads"]]
    torch.save(_torch_task(MICRO).model.state_dict(), tmp / "pre.pt")
    torch.save(ClassificationTask(override(ClassificationTaskConfig(), cls),
                                  override(TrainerConfig(), {}), device="cpu").model.state_dict(),
               tmp / "cls.pt")
    batch = _batch(seed=3, batch=GLOBAL)
    batch["itm_label_ids"] = np.tile(np.asarray([1, 0, 1, 1], np.int32), GLOBAL // 4)
    return [
        ("pretraining_spanning", "pretraining", pre, TRAINER, str(tmp / "pre.pt"), batch, 11),
        ("pretraining_local", "pretraining", pre, {**TRAINER, "micro_batch_size": 2},
         str(tmp / "pre.pt"), batch, 12),
        ("classification", "classification", cls, {}, str(tmp / "cls.pt"),
         make_batch(seed=4, batch=2 * RANKS), 13),
    ]


@pytest.fixture(scope="module")
def dropout_run(tmp_path_factory):
    cases = _dropout_cases(tmp_path_factory.mktemp("dropout"))
    args = [c[1:] for c in cases]
    ranks = run_local(torch_gloo_workers.dropout_train_steps, RANKS, args, (RANKS, 1))
    one = torch_gloo_workers.dropout_train_steps(args)
    reseeded = torch_gloo_workers.dropout_train_steps([a[:-1] + (a[-1] + 100,) for a in args])
    return {c[0]: (i, ranks, one, reseeded) for i, c in enumerate(cases)}


@pytest.mark.parametrize("case", ["pretraining_spanning", "pretraining_local",
                                  "classification"])
def test_dropout_masks_are_the_one_process_steps(dropout_run, case):
    """Every rank's dropout masks are its rows of the one-process step's:
    the 4-rank step with every dropout at 0.1 gives the one-process step's
    loss (1e-6 relative) and gradients (1e-5 of each tensor's norm plus
    1e-7 of the whole's; the all-reduce sums in another order).  Another
    seed moves the one-process gradients far past that bound, so the masks
    are on."""
    i, ranks, one, reseeded = dropout_run[case]
    want = one[i]
    for rank in ranks:
        got = rank[i]
        for name, (t, c) in want["metrics"].items():
            gt, gc = got["metrics"][name]
            np.testing.assert_allclose(gt / gc, t / c, rtol=1e-6, atol=1e-7, err_msg=name)
        _assert_trees_close(got["grads"], want["grads"], 1e-5, floor=1e-7)
    with pytest.raises(AssertionError):
        _assert_trees_close(reseeded[i]["grads"], want["grads"], 1e-2, floor=1e-4)
