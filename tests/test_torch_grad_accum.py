"""bfloat16 and float16 gradient accumulation of the port's pretraining step.

* ``grad_accum_dtype="bfloat16"`` and ``"float16"``: three AdamW steps of the tiny
  pretraining task (batch 4 in micro-batches of 2, dropout off, lr 1e-3
  after one warmup step, as ``test_torch_train``'s three-step test) against
  JAX's steps at the same dtype from the same parameters.  The parameters at the
  tolerance of ``tests/test_train.py::test_bf16_grad_accumulation_tracks_fp32``
  (atol 5e-3, rtol 5e-2; each step's loss at rtol 1e-5), and each
  parameter's change over the three steps within GA_DELTA_TOL of that
  change's norm (the key bias against the query bias's: see
  ``test_torch_train``).  Port and JAX round the same float32 gradients
  (equal to ~1e-6) to the dtype, so they differ by ~1e-4 of the change; the
  bf16 and float32 sums differ by more than GA_DELTA_TOL on most tensors,
  so a float32 sum fails this check;
* against the port's own float32 steps: the changes agree within
  GA_BF16_TOL of their norm (bf16 roundings of ~2^-9 each, 2e-3
  measured) and differ by more than GA_DELTA_TOL on at least
  GA_MOVED_SHARE of the tensors, so a bf16 path that sums in float32
  fails;
* the summed gradient: each micro-batch's gradient rounded to bf16 (fp16)
  and added in bf16 (fp16), equal to that sum made by hand;
* ``"float32"``: bit-identical to summing the micro-batches' gradients of
  loss / k in ``.grad`` (the step as it was before bfloat16 came);
* the names read as ``jnp.dtype`` reads them: a name that is no dtype
  raises JAX's TypeError, a float64 name warns and sums in float32 (JAX
  on the CPU without x64), and a dtype that is not floating raises.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GradKeeper
from mmt_tpu.train import optimizer as jax_optimizer
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.tasks import accum_dtype, batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_train import (
    _assert_trees_close,
    _batch,
    _bridged,
    _jax_task,
    _scale,
    _to_port_names,
    _torch_task,
)

MICRO, STEPS = 2, 3
OPT = {"polynomial": {"initial_learning_rate": 1e-3, "decay_steps": 10},
       "warmup": {"warmup_steps": 1}}
GA_DELTA_TOL, GA_BF16_TOL, GA_MOVED_SHARE = 1e-3, 1e-2, 0.75


@functools.lru_cache(maxsize=None)
def _port_steps(dtype):
    """(start, end, losses) of STEPS port steps; parameters by port name."""
    jax_task, task = _jax_task(MICRO, OPT), _torch_task(MICRO, OPT)
    start = _to_port_names(_bridged(task, jax_task), task.model)
    state = TrainState.create(task.model, create_optimizer(task.trainer.optimizer_config, STEPS,
                                                           task.model))
    step = task.make_train_step(MICRO, dtype)
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, batch_to_device(_batch(seed=10 + i), "cpu"))
        losses.append(metrics["total_loss"][0].item())
    for name, p in task.model.named_parameters():
        assert p.dtype == torch.float32, name
    end = {n: p.detach().numpy().copy() for n, p in task.model.named_parameters()}
    return start, end, losses


def _deltas(start, end):
    return {n: end[n] - start[n] for n in start}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_bf16_step_matches_jax(dtype):
    jax_task, task = _jax_task(MICRO, OPT), _torch_task(MICRO, OPT)
    start, got, losses = _port_steps(dtype)
    params = _bridged(task, jax_task)
    jstate = JaxTrainState.create(params, jax_optimizer.create_optimizer(
        jax_task.trainer.optimizer_config, STEPS))
    jstep = jax_task.make_train_step(micro_batch_size=MICRO, grad_accum_dtype=dtype)
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in _batch(seed=10 + i).items()}
        jstate, jmetrics = jstep(jstate, batch, jax.random.PRNGKey(i))
        np.testing.assert_allclose(losses[i], float(jmetrics["total_loss"][0]), rtol=1e-5)
    want = _to_port_names(jax.tree_util.tree_map(np.asarray, jstate.params), task.model)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-3, rtol=5e-2, err_msg=name)
    _assert_trees_close(_deltas(start, got), _deltas(start, want), GA_DELTA_TOL)


def test_bf16_step_tracks_the_float32_step():
    start, p16, l16 = _port_steps("bfloat16")
    _, p32, l32 = _port_steps("float32")
    np.testing.assert_allclose(l16, l32, rtol=1e-5)
    d16, d32 = _deltas(start, p16), _deltas(start, p32)
    _assert_trees_close(d16, d32, GA_BF16_TOL)
    apart = [n for n in d32 if np.linalg.norm(d16[n] - d32[n]) > GA_DELTA_TOL * _scale(d32, n)]
    assert len(apart) >= GA_MOVED_SHARE * len(d32), apart


def _micro_grads(task, batch):
    """Each micro-batch's gradient of loss / k, by hand."""
    k = batch["word_ids"].shape[0] // MICRO
    out = []
    for i in range(k):
        micro = {key: v[i * MICRO:(i + 1) * MICRO] for key, v in batch.items()}
        loss, _ = task.compute_loss(micro, None, deterministic=False)
        task.model.zero_grad(set_to_none=True)
        (loss / k).backward()
        out.append({n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                    for n, p in task.model.named_parameters()})
    task.model.zero_grad(set_to_none=True)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_summed_gradient_is_the_dtype_sum(dtype):
    jax_task, task = _jax_task(MICRO), _torch_task(MICRO)
    _bridged(task, jax_task)
    batch = batch_to_device(_batch(seed=3), "cpu")
    micro = _micro_grads(task, batch)
    if dtype == "float32":  # .grad accumulates in float32, as before
        want = {n: micro[0][n] + micro[1][n] for n in micro[0]}
    else:
        low = getattr(torch, dtype)
        want = {n: (micro[0][n].to(low) + micro[1][n].to(low)).float() for n in micro[0]}
    keeper = GradKeeper(task.model)
    task.make_train_step(MICRO, dtype)(TrainState(step=0, model=task.model, optimizer=keeper),
                                       batch)
    for name, g in keeper.grads.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, want[name]), name


def test_other_accumulation_dtypes_raise():
    jax_task, task = _jax_task(MICRO), _torch_task(MICRO)
    for name in ("nope", "float17"):  # what jnp.dtype refuses, and how
        with pytest.raises(TypeError) as want:
            jax_task.make_train_step(micro_batch_size=MICRO, grad_accum_dtype=name)
        with pytest.raises(TypeError) as got:
            task.make_train_step(MICRO, name)
        assert str(got.value) == str(want.value)
    for name in ("int32", "bool", "complex64"):  # dtypes, not floating ones
        with pytest.raises(ValueError, match="float16, bfloat16 or float32"):
            task.make_train_step(MICRO, name)
    # float64: JAX on the CPU without x64 warns and sums in float32, and so
    # does the port: the step is the float32 one, bit for bit.
    assert not jax.config.jax_enable_x64
    for name in ("float64", "double"):
        with pytest.warns(UserWarning, match="float32"):
            assert accum_dtype(name) == torch.float32
    assert accum_dtype("half") == torch.float16 and accum_dtype("f4") == torch.float32
    _bridged(task, jax_task)
    batch = batch_to_device(_batch(seed=3), "cpu")
    grads = {}
    for name in ("float32", "float64"):
        keeper = GradKeeper(task.model)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step = task.make_train_step(MICRO, name)
        step(TrainState(step=0, model=task.model, optimizer=keeper), batch)
        grads[name] = keeper.grads
    for n, g in grads["float32"].items():
        assert torch.equal(grads["float64"][n], g), n
