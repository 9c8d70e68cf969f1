"""The port's checkpoints, warm start and resume against the JAX package's.

Tolerances:

* ``restore_encoder_and_heads``: equal to JAX's on the converted trees,
  tensor for tensor; its count equal to JAX's ``count_restored``; the
  warm-started model's logits within 1e-5 of the JAX model's (float32, 2
  layers, sums in another order);
* ``BestCheckpointExporter``: the same steps exported as JAX's on one
  metric sequence, for ``higher`` and ``lower``;
* ``CheckpointManager``: ``max_to_keep`` pruning, the parameters and the
  optimizer state back exactly;
* a resume on the CPU, run as 2 + 2 steps through the CLI with hidden and
  attention dropout 0.1: parameters and optimizer state equal, bit for bit,
  to those of one 4-step run (with deterministic algorithms: the embedding
  gathers' backward sums in a run-dependent order on the CPU otherwise, so
  that two whole runs differ as well).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmt_tpu.configs import PretrainingTaskConfig as JaxPretrainConfig
from mmt_tpu.configs import TrainerConfig as JaxTrainerConfig
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.train import checkpoint as jax_checkpoint
from mmt_tpu.train.tasks import PretrainingTask as JaxPretrainTask
from mmt_tpu_torch.configs import PretrainingTaskConfig, TrainerConfig, override
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.models import DropoutRngs
from mmt_tpu_torch.train.checkpoint import (
    BestCheckpointExporter,
    CheckpointManager,
    count_restored,
    restore_encoder_and_heads,
)
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_finetune import (
    ENCODER,
    OPT,
    S,
    cli_yaml,
    make_batch,
    make_tasks,
    write_paired_records,
    write_vocab,
)


def _pretrain_dict(heads):
    return {"model": {"encoder": {"mmt": {**ENCODER, "attention_impl": "xla"}},
                      "cls_heads": heads},
            "train_data": {"input_path": "dummy", "max_seq_len": S, "image_size": 32,
                           "patch_size": 16, "mlm_max_selections_per_seq": 4,
                           "mpp_max_selections_per_seq": 3, "output_channel_bits": 2}}


def _pretrain_params(heads):
    """A JAX pretraining model's parameters (numpy tree) and the port's
    model holding them."""
    cfg = _pretrain_dict(heads)
    jax_task = JaxPretrainTask(jax_override(JaxPretrainConfig(), cfg), JaxTrainerConfig())
    batch = {k: jnp.asarray(v) for k, v in make_batch(1).items()}
    batch["mlm_positions"] = jnp.full((6, 4), 7, jnp.int32)
    batch["mpp_positions"] = jnp.full((6, 3), 2, jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, jax_task.init(jax.random.PRNGKey(3), batch))
    task = PretrainingTask(override(PretrainingTaskConfig(), cfg), TrainerConfig(), device="cpu",
                           seed=5)
    task.model.load_state_dict(params_from_flax(params, task.model))
    return params, task.model


def test_restore_encoder_and_heads_matches_jax():
    jax_task, task, cls_params = make_tasks(2)
    heads = [{"inner_dim": 32, "num_classes": 2, "name": "itm"},
             {"inner_dim": 32, "num_classes": 3, "name": "other"}]
    pre_params, pre_model = _pretrain_params(heads)
    want = jax_checkpoint.restore_encoder_and_heads(cls_params, pre_params)
    want_count = jax_checkpoint.count_restored(cls_params, pre_params)

    target = task.model.state_dict()
    source = pre_model.state_dict()
    got = restore_encoder_and_heads(target, source)
    assert count_restored(target, source) == want_count
    assert want_count == len([n for n in target if n.startswith(("encoder.", "cls_heads.itm."))])
    want_sd = params_from_flax(jax.tree_util.tree_map(np.asarray, want), task.model)
    assert got.keys() == want_sd.keys()
    for name in got:
        torch.testing.assert_close(got[name], want_sd[name], rtol=0, atol=0, msg=name)
    # The classification model's fresh tensors stay: here its own head is
    # named like the pretraining one, so every tensor comes from there.
    assert all(torch.equal(got[n], source[n]) for n in got)

    task.model.load_state_dict(got)
    batch = make_batch(4)
    want_logits = jax_task.model.apply(
        want, **{k: jnp.asarray(batch[k]) for k in ("word_ids", "segment_ids",
                                                    "patch_embeddings", "lengths")},
        deterministic=True)["itm_logits"]
    with torch.no_grad():
        _, (outputs, _) = task.compute_loss(batch_to_device(batch, "cpu"), None, True)
    np.testing.assert_allclose(outputs["itm_logits"].numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)

    # A head the pretraining model lacks keeps its fresh values; a shape
    # mismatch raises.
    fresh = {**target, "cls_heads.new.dense.weight": torch.ones(2, 2)}
    assert torch.equal(restore_encoder_and_heads(fresh, source)["cls_heads.new.dense.weight"],
                       torch.ones(2, 2))
    _, wide_head = _pretrain_params([{"inner_dim": 16, "num_classes": 2, "name": "itm"}])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_encoder_and_heads(target, wide_head.state_dict())


def test_cli_warm_start_from_a_pretraining_checkpoint(tmp_path, caplog):
    from mmt_tpu_torch.cli.train import main

    _, pre_model = _pretrain_params([{"inner_dim": 32, "num_classes": 2, "name": "itm"}])
    CheckpointManager(str(tmp_path / "pretrain")).save(7, pre_model)
    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 16, seed=0)
    val = write_paired_records(tmp_path / "val.tfrecord", 8, seed=1)
    config = tmp_path / "itm.yaml"
    config.write_text(yaml.safe_dump(cli_yaml(vocab, train, val, "pallas",
                                              init_checkpoint=str(tmp_path / "pretrain"))))
    with caplog.at_level(logging.INFO):
        metrics = main(["--experiment=mmt/classification", "--mode=eval",
                        f"--model_dir={tmp_path / 'model'}", f"--config_file={config}",
                        "--device=cpu"])
    expected = len([n for n in pre_model.state_dict() if n.startswith(("encoder.", "cls_heads."))])
    assert f"count_restored={expected} " in caplog.text
    assert np.isfinite(metrics["cls_loss"]) and 0.0 <= metrics["auc"] <= 1.0 + 1e-6


def test_warm_start_of_a_pretraining_task_takes_the_whole_checkpoint(tmp_path):
    from mmt_tpu_torch.cli.train import warm_start

    def make(seed):
        cfg = _pretrain_dict([{"inner_dim": 32, "num_classes": 2, "name": "itm"}])
        return PretrainingTask(override(PretrainingTaskConfig(), cfg), TrainerConfig(),
                               device="cpu", seed=seed)

    source = make(5).model
    CheckpointManager(str(tmp_path)).save(3, source)
    task = make(9)
    assert warm_start(task, str(tmp_path)) == len(source.state_dict())
    for name, value in source.state_dict().items():
        assert torch.equal(task.model.state_dict()[name], value), name


@pytest.mark.parametrize("comp", ["higher", "lower"])
def test_best_checkpoint_exporter_matches_jax(tmp_path, comp):
    sequence = [{"acc": 0.5}, {"acc": 0.4}, {"loss": 1.0}, {"acc": 0.7}, {"acc": 0.7},
                {"acc": 0.2}, {"acc": 0.9}]
    jax_exp = jax_checkpoint.BestCheckpointExporter(str(tmp_path / "jax"), "acc", comp)
    exp = BestCheckpointExporter(str(tmp_path / "torch"), "acc", comp)
    model = torch.nn.Linear(2, 2)
    got, want = [], []
    for step, metrics in enumerate(sequence, start=1):
        with torch.no_grad():
            model.weight.fill_(step)
        want.append(jax_exp.maybe_export(step, metrics, {"w": np.full((2,), step, np.float32)}))
        got.append(exp.maybe_export(step, metrics, model))
    assert got == want
    info = json.loads((tmp_path / "torch" / "best_info.json").read_text())
    assert info == json.loads((tmp_path / "jax" / "best_info.json").read_text())
    best = exp.checkpoints
    assert best.steps() == [info["step"]]
    assert torch.equal(best.restore()["weight"], torch.full((2, 2), float(info["step"])))


def test_checkpoint_manager_prunes_and_restores_optimizer_state(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = create_optimizer(override(TrainerConfig(), {"optimizer_config": OPT}).optimizer_config,
                           10, model)
    state = TrainState.create(model, opt)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    saved = {}
    for step in range(1, 5):
        for p in model.parameters():
            p.grad = torch.full_like(p, 0.1 * step)
        state.apply_gradients()
        mgr.save(step, model, opt)
        saved[step] = ({k: v.clone() for k, v in model.state_dict().items()},
                       {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                        for k, v in opt.state_dict().items()})
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4"]

    fresh = torch.nn.Linear(3, 2)
    fresh_state = TrainState.create(fresh, create_optimizer(
        override(TrainerConfig(), {"optimizer_config": OPT}).optimizer_config, 10, fresh))
    mgr.restore_train_state(fresh_state, 3)
    assert fresh_state.step == 3 and fresh_state.optimizer.count == 3
    for k, v in saved[3][0].items():
        assert torch.equal(fresh.state_dict()[k], v)
    for key in ("mu", "nu"):
        for n, t in saved[3][1][key].items():
            assert torch.equal(fresh_state.optimizer.state_dict()[key][n], t)
    # A parameters-only checkpoint (the predict layout) restores for
    # prediction and refuses a resume.
    params_only = CheckpointManager(str(tmp_path / "p"))
    params_only.save(0, fresh)
    assert params_only.restore().keys() == fresh.state_dict().keys()
    with pytest.raises(FileNotFoundError, match="optimizer"):
        params_only.restore_train_state(fresh_state)
    with pytest.raises(ValueError, match="other parameters"):
        fresh_state.optimizer.load_state_dict(
            {"count": 1, "mu": {"x": torch.zeros(1)}, "nu": {"x": torch.zeros(1)}})


def test_dropout_streams_depend_on_seed_and_step_only():
    draws = {}
    for seed, step in ((0, 0), (0, 1), (1, 0), (0, 0)):
        rngs = DropoutRngs.for_step(seed, step, "cpu")
        draws.setdefault((seed, step), []).append(
            (rngs.layer_seeds(), torch.rand(4, generator=rngs.device)))
    (a_seeds, a_rand), (b_seeds, b_rand) = draws[(0, 0)]
    assert a_seeds == b_seeds and torch.equal(a_rand, b_rand)
    assert draws[(0, 1)][0][0] != a_seeds and draws[(1, 0)][0][0] != a_seeds


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_resume_is_bit_equal_on_the_cpu(tmp_path, deterministic):
    """2 + 2 steps (a second command resumes from the first's checkpoint and
    input-stream snapshot) against 4 steps, with dropout 0.1."""
    from mmt_tpu_torch.cli.train import main

    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 40, seed=0)
    val = write_paired_records(tmp_path / "val.tfrecord", 16, seed=1)
    config = tmp_path / "itm.yaml"
    config.write_text(yaml.safe_dump(cli_yaml(vocab, train, val, "pallas", hidden_dropout=0.1,
                                              attention_dropout=0.1)))

    def run(model_dir, steps):
        return main(["--experiment=mmt/classification", "--mode=train_and_eval",
                     f"--model_dir={model_dir}", f"--config_file={config}", "--device=cpu",
                     f"--params_override=trainer.train_steps={steps}"])

    run(tmp_path / "whole", 4)
    run(tmp_path / "cut", 2)
    assert CheckpointManager(str(tmp_path / "cut")).steps() == [2]
    resumed = run(tmp_path / "cut", 4)
    assert resumed.step == 4
    whole, cut = (CheckpointManager(str(tmp_path / d)) for d in ("whole", "cut"))
    assert whole.steps() == cut.steps() == [2, 4]
    want, got = whole.restore(4), cut.restore(4)
    assert not torch.equal(want["encoder.embeddings_layer_norm.weight"],
                           whole.restore(2)["encoder.embeddings_layer_norm.weight"])
    for name in want:
        assert torch.equal(got[name], want[name]), name
    opt_want, opt_got = (torch.load(tmp_path / d / "4" / "optimizer.pt", weights_only=True)
                         for d in ("whole", "cut"))
    assert opt_got["count"] == opt_want["count"] == 4
    for key in ("mu", "nu"):
        for name in opt_want[key]:
            assert torch.equal(opt_got[key][name], opt_want[key][name]), (key, name)

    def lines(d, name):
        return [json.loads(l) for l in (tmp_path / d / f"{name}_summaries.jsonl").read_text()
                .splitlines()]

    assert [l["step"] for l in lines("cut", "train")] == [1, 2, 3, 4]
    for g, w in zip(lines("cut", "train"), lines("whole", "train")):
        assert {k: v for k, v in g.items() if k != "steps_per_sec"} == \
            {k: v for k, v in w.items() if k != "steps_per_sec"}
    assert lines("cut", "validation") == lines("whole", "validation")
