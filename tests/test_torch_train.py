"""The port's training stack against the JAX package's.

Tolerances:

* losses: 1e-6 (float32 CE in another order);
* learning-rate schedule: 1e-7 relative (both in float32);
* decay mask: equal, parameter by parameter;
* AdamW: five steps on the same parameters and gradients, 1e-6 relative
  to each tensor's norm;
* ``PretrainingTask`` on the tiny model of ``test_torch_pretraining``
  with dropout off: loss and metrics at 1e-5, gradients within 1e-4 of
  each tensor's norm plus 1e-6 of the whole gradient's norm (float32
  through 2 layers, sums in another order: tensors whose gradient is a
  small sum of large cancelling terms, such as the relative tables and
  LayerNorm scales, carry an absolute error of the terms' scale), with
  and without micro-batches; three AdamW train steps end within 1e-5 of
  each parameter tensor's norm.  The key bias's exact gradient is 0
  (softmax is invariant to a per-row shift), so both sides give rounding
  noise there; it is measured against the same layer's query-bias norm;
* the CLI: a tiny dummy run writes ``params.yaml`` (equal to the merged
  config) and one ``train_summaries.jsonl`` line per step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mmt_tpu.configs import OptimizationConfig as JaxOptimizationConfig
from mmt_tpu.configs import PretrainingTaskConfig as JaxTaskConfig
from mmt_tpu.configs import TrainerConfig as JaxTrainerConfig
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.train import losses as jax_losses
from mmt_tpu.train import optimizer as jax_optimizer
from mmt_tpu.train.tasks import PretrainingTask as JaxTask
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.configs import (
    OptimizationConfig,
    PretrainingTaskConfig,
    TrainerConfig,
    override,
)
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.data.dummy import dummy_pretrain_batches
from mmt_tpu_torch.train import losses
from mmt_tpu_torch.train.optimizer import (
    AdamW,
    create_learning_rate_fn,
    create_optimizer,
    decay_mask,
)
from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_pretraining import ENCODER, HEAD, LENGTHS, MPP_CLASSES, P, PATCH_DIM, S

# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("zero_weights", [False, True])
def test_losses_match(zero_weights):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, (3, 5)).astype(np.int32)
    weights = (rng.random((3, 5)) < 0.6).astype(np.float32) * (not zero_weights)
    pos = rng.random((3, 5)).astype(np.float32)
    for pw in (None, pos):
        want = jax_losses.weighted_sparse_categorical_crossentropy_loss(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights),
            None if pw is None else jnp.asarray(pw))
        got = losses.weighted_sparse_categorical_crossentropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weights),
            None if pw is None else torch.from_numpy(pw))
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    blogits = rng.normal(size=(6, 1)).astype(np.float32)
    blabels = rng.integers(0, 2, (6,)).astype(np.int32)
    bweights = np.ones(6, np.float32) * (not zero_weights)
    want = jax_losses.weighted_binary_crossentropy_loss(
        jnp.asarray(blogits), jnp.asarray(blabels), jnp.asarray(bweights), jnp.ones(6, jnp.float32))
    got = losses.weighted_binary_crossentropy_loss(
        torch.from_numpy(blogits), torch.from_numpy(blabels), torch.from_numpy(bweights),
        torch.ones(6))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------- optimizer

OPT = {"polynomial": {"initial_learning_rate": 5e-4, "decay_steps": 20000},
       "warmup": {"warmup_steps": 2000}}


@pytest.mark.parametrize("opt", [OPT, {"polynomial": {"initial_learning_rate": 3e-5,
                                                      "power": 2.0}}],
                         ids=["warmup", "no_warmup"])
def test_learning_rate_schedule_matches(opt):
    want = jax_optimizer.create_learning_rate_fn(
        jax_override(JaxOptimizationConfig(), opt), 1000)
    got = create_learning_rate_fn(override(OptimizationConfig(), opt), 1000)
    for step in (0, 1, 1999, 2000, 2001, 10000, 19999, 20000, 25000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-7, atol=0)


_TASK_CFG = {
    "model": {"encoder": {"mmt": {**ENCODER, "attention_impl": "pallas"}},
              "cls_heads": [HEAD]},
    "train_data": {"input_path": "dummy", "max_seq_len": S, "image_size": 4 * P,
                   "patch_size": 4, "input_channels": 3, "global_batch_size": 4,
                   "mlm_max_selections_per_seq": 6, "mpp_max_selections_per_seq": 5,
                   "output_channel_bits": 2},
}


def _jax_task(micro=0, opt=None, steps=3):
    trainer = jax_override(JaxTrainerConfig(), {
        "train_steps": steps, "micro_batch_size": micro, "optimizer_config": opt or {}})
    cfg = jax_override(JaxTaskConfig(), _TASK_CFG)
    # JAX's dense attention: its gradients equal the Pallas kernels' (held
    # in interpret mode by test_torch_attention_backward) to float32
    # rounding, at a fraction of the interpret mode's time.
    cfg.model.encoder.mmt.attention_impl = "xla"
    return JaxTask(cfg, trainer)


def _torch_task(micro=0, opt=None, steps=3):
    trainer = override(TrainerConfig(), {
        "train_steps": steps, "micro_batch_size": micro, "optimizer_config": opt or {}})
    return PretrainingTask(override(PretrainingTaskConfig(), _TASK_CFG), trainer, device="cpu")


def _batch(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    n = P * P
    return {
        "word_ids": rng.integers(0, 100, (batch, S)).astype(np.int32),
        "segment_ids": np.where(np.arange(S)[None] < n + 2, 1, 2).repeat(batch, 0).astype(np.int32),
        "patch_embeddings": rng.normal(size=(batch, n, PATCH_DIM)).astype(np.float32),
        "lengths": np.asarray((LENGTHS * batch)[:batch], np.int32),
        "mlm_positions": rng.integers(n + 2, 90, (batch, 6)).astype(np.int32),
        "mlm_label_ids": rng.integers(0, 100, (batch, 6)).astype(np.int32),
        "mlm_label_weights": (rng.random((batch, 6)) < 0.7).astype(np.float32),
        "mpp_positions": rng.integers(2, n + 2, (batch, 5)).astype(np.int32),
        "mpp_label_ids": rng.integers(0, MPP_CLASSES, (batch, 5)).astype(np.int32),
        "mpp_label_weights": (rng.random((batch, 5)) < 0.7).astype(np.float32),
        "itm_label_ids": np.asarray([1, 0, 1, 1][:batch], np.int32),
        "itm_label_weights": np.ones(batch, np.float32),
    }


_JAX_PARAMS = {}


def _bridged(task, jax_task):
    """Flax-initialised params (numpy tree), loaded into the port's task model."""
    if "params" not in _JAX_PARAMS:
        b = {k: jnp.asarray(v) for k, v in _batch().items()}
        _JAX_PARAMS["params"] = jax.tree_util.tree_map(
            np.asarray, jax_task.init(jax.random.PRNGKey(0), b))
    params = _JAX_PARAMS["params"]
    task.model.load_state_dict(params_from_flax(params, task.model))
    return params


def _scale(tensors, name):
    if name.endswith("attention.key.bias"):
        name = name[: -len("key.bias")] + "query.bias"
    return max(np.linalg.norm(tensors[name]), 1e-30)


def _assert_trees_close(got: dict, want: dict, tol, floor=0.0):
    """Per tensor: ||got - want|| <= tol * ||want|| + floor * ||all of want||
    (key bias: see module doc)."""
    assert set(got) == set(want)
    total = np.sqrt(sum(np.sum(np.square(w)) for w in want.values()))
    errors = {n: np.linalg.norm(got[n] - want[n]) / (tol * _scale(want, n) + floor * total)
              for n in want}
    worst = sorted(errors.items(), key=lambda kv: -kv[1])[:3]
    assert worst[0][1] <= 1.0, worst


def _to_port_names(tree, model):
    return {k: v.numpy() for k, v in params_from_flax(tree, model).items()}


def test_decay_mask_matches_flax_paths():
    jax_task, task = _jax_task(), _torch_task()
    params = _bridged(task, jax_task)
    want_tree = jax_optimizer._decay_mask(params)
    flat = jax.tree_util.tree_flatten_with_path(want_tree["params"])[0]
    want = {"/".join(k.key for k in path): bool(v) for path, v in flat}
    from mmt_tpu_torch.convert import flax_paths

    paths = flax_paths(task.model)
    got = decay_mask(task.model)
    assert {paths[n]: m for n, m in got.items()} == want
    assert not got["encoder.embeddings_layer_norm.weight"]
    assert not got["masked_lm.output_bias"]
    assert got["encoder.transformer.layers.0.attention.relative_emb_table"]


@pytest.mark.parametrize("clipnorm", [0.0, 0.5])
def test_adamw_matches_optax(clipnorm):
    opt = {"polynomial": {"initial_learning_rate": 1e-2, "decay_steps": 10},
           "warmup": {"warmup_steps": 2}, "adamw": {"global_clipnorm": clipnorm}}
    jax_task, task = _jax_task(), _torch_task()
    params = _bridged(task, jax_task)
    tx = jax_optimizer.create_optimizer(jax_override(JaxOptimizationConfig(), opt), 10)
    state = JaxTrainState.create(params, tx)
    adamw = create_optimizer(override(OptimizationConfig(), opt), 10, task.model)
    assert isinstance(adamw, AdamW)
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2, params)
        state = state.apply_gradients(jax.tree_util.tree_map(jnp.asarray, grads))
        for name, g in params_from_flax(grads, task.model).items():
            dict(task.model.named_parameters())[name].grad = g
        adamw.step()
    want = _to_port_names(jax.tree_util.tree_map(np.asarray, state.params), task.model)
    got = {n: p.detach().numpy() for n, p in task.model.named_parameters()}
    _assert_trees_close(got, want, 1e-6)


# --------------------------------------------------------------------- task


class _GradRecorder:
    """An optimizer stand-in that keeps the gradients it is handed."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def step(self):
        self.grads = {n: p.grad.detach().clone().numpy() for n, p in self.model.named_parameters()}

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("micro", [0, 2], ids=["one_batch", "micro_batches"])
def test_task_loss_metrics_and_grads_match(micro):
    jax_task, task = _jax_task(micro), _torch_task(micro)
    params = _bridged(task, jax_task)
    batch = _batch()
    # JAX: one SGD step of rate 1 gives params - grads.
    jstate = JaxTrainState.create(params, optax.sgd(1.0))
    jstep = jax_task.make_train_step(micro_batch_size=micro)
    jnew, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
    want_grads = _to_port_names(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, jnew.params), task.model)

    recorder = _GradRecorder(task.model)
    state = TrainState(step=0, model=task.model, optimizer=recorder)
    state, metrics = task.make_train_step(micro)(state, batch_to_device(batch, "cpu"))
    assert state.step == 1
    for name, (total, count) in jmetrics.items():
        got = metrics[name][0].item() / metrics[name][1].item()
        np.testing.assert_allclose(got, float(total) / float(count), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    _assert_trees_close(recorder.grads, want_grads, 1e-4, floor=1e-6)


def test_eval_step_matches():
    jax_task, task = _jax_task(), _torch_task()
    params = _bridged(task, jax_task)
    batch = _batch(seed=2)
    want = jax_task.make_eval_step()(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = task.make_eval_step()(batch_to_device(batch, "cpu"))
    assert not task.model.training
    for name, (total, count) in want.items():
        np.testing.assert_allclose(got[name][0].item() / got[name][1].item(),
                                   float(total) / float(count), atol=1e-5, rtol=1e-5)


def test_three_train_steps_match_jax_params():
    opt = {"polynomial": {"initial_learning_rate": 1e-3, "decay_steps": 10},
           "warmup": {"warmup_steps": 1}}
    jax_task, task = _jax_task(2, opt), _torch_task(2, opt)
    params = _bridged(task, jax_task)
    jstate = JaxTrainState.create(params, jax_optimizer.create_optimizer(
        jax_task.trainer.optimizer_config, 3))
    jstep = jax_task.make_train_step(micro_batch_size=2)
    state = TrainState.create(task.model, create_optimizer(
        task.trainer.optimizer_config, 3, task.model))
    step = task.make_train_step(2)
    for i in range(3):
        batch = _batch(seed=10 + i)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(i))
        state, _ = step(state, batch_to_device(batch, "cpu"))
    want = _to_port_names(jax.tree_util.tree_map(np.asarray, jstate.params), task.model)
    got = {n: p.detach().numpy() for n, p in task.model.named_parameters()}
    assert not np.allclose(got["masked_lm.transform_dense.weight"],
                           _to_port_names(params, task.model)["masked_lm.transform_dense.weight"])
    _assert_trees_close(got, want, 1e-5)


# ---------------------------------------------------------------- loop / CLI


def test_dummy_batches_match():
    from mmt_tpu.configs import MmtPretrainDataConfig as JaxDataConfig
    from mmt_tpu.data.dummy import dummy_pretrain_batches as jax_dummy
    from mmt_tpu_torch.configs import MmtPretrainDataConfig

    got = next(dummy_pretrain_batches(MmtPretrainDataConfig(max_seq_len=64), batch_size=3))
    want = next(jax_dummy(JaxDataConfig(max_seq_len=64), batch_size=3))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


def test_cli_tiny_dummy_run(tmp_path):
    from mmt_tpu_torch.cli.train import main

    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump({
        "task": {"model": {"encoder": {"mmt": {
            "vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 1,
            "num_attention_heads": 2, "intermediate_size": 64, "relative_vocab_size": 49,
            "relative_att_num_core_layers": 1, "attention_impl": "pallas"}},
            "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]},
            "train_data": {"input_path": "dummy", "max_seq_len": 32, "image_size": 32,
                           "patch_size": 16, "global_batch_size": 4,
                           "mlm_max_selections_per_seq": 5, "mpp_max_selections_per_seq": 3}},
        "trainer": {"train_steps": 2, "steps_per_loop": 1, "summary_interval": 1,
                    "micro_batch_size": 2}}))
    model_dir = tmp_path / "model"
    main(["--experiment=mmt/pretraining", "--mode=train", f"--model_dir={model_dir}",
          f"--config_file={config}", "--params_override=trainer.steps_per_loop=1",
          "--device=cpu"])
    written = yaml.safe_load((model_dir / "params.yaml").read_text())
    assert written["task"]["train_data"]["max_seq_len"] == 32
    assert written["trainer"]["train_steps"] == 2
    lines = [json.loads(l) for l in (model_dir / "train_summaries.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines] == [1, 2]
    assert all(np.isfinite(l["total_loss"]) and l["steps_per_sec"] > 0 for l in lines)
    assert all(0 <= l["input_seconds"] < 1 / l["steps_per_sec"] for l in lines)

    # Record input paths run (tests/test_torch_pretrain_records.py): one
    # that matches no file raises, and eval needs validation records.
    from tests.test_torch_finetune import write_vocab

    records = ('{"task": {"train_data": {"input_path": "x", "vocab_filename": "%s"}}}'
               % write_vocab(tmp_path))
    with pytest.raises(ValueError, match="does not match any files"):
        main(["--experiment=mmt/pretraining", f"--model_dir={model_dir}",
              f"--config_file={config}", f"--params_override={records}", "--device=cpu"])
    with pytest.raises(ValueError, match="validation_data.input_path"):
        main(["--experiment=mmt/pretraining", "--mode=eval", f"--model_dir={model_dir}",
              f"--config_file={config}", "--device=cpu"])
    with pytest.raises(ValueError, match="retrieval"):
        main(["--experiment=mmt/retrieval", f"--model_dir={model_dir}", "--device=cpu"])


def test_task_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PretrainingTask(PretrainingTaskConfig(), TrainerConfig())


def test_metric_helpers_match():
    from mmt_tpu.train import metrics as jax_metrics
    from mmt_tpu_torch.train import metrics

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    weights = rng.random(6).astype(np.float32)
    want = jax_metrics.zeros_like_metrics(["acc", "loss"])
    want = jax_metrics.update_weighted_accuracy(want, "acc", jnp.asarray(labels),
                                                jnp.asarray(logits), jnp.asarray(weights))
    want = jax_metrics.update_mean(want, "loss", jnp.float32(2.5), 3.0)
    want = jax_metrics.merge(want, {"loss": (jnp.float32(1.0), jnp.float32(1.0))})
    got = metrics.zeros_like_metrics(["acc", "loss"])
    got = metrics.update_weighted_accuracy(got, "acc", torch.from_numpy(labels),
                                           torch.from_numpy(logits), torch.from_numpy(weights))
    got = metrics.update_mean(got, "loss", torch.tensor(2.5), 3.0)
    got = metrics.merge(got, {"loss": (torch.tensor(1.0), torch.tensor(1.0))})
    final_want, final_got = jax_metrics.finalize(want), metrics.finalize(got)
    assert final_got.keys() == final_want.keys()
    for name in final_want:
        np.testing.assert_allclose(final_got[name], final_want[name], rtol=1e-6)
