"""The port's continuous finetuning against the JAX package's.

* The slice as a whole: a JAX pretraining checkpoint (step 0) and its
  converted weights in the port's checkpoint format
  (``convert.params_from_flax``, restored bit for bit); then
  ``--mode=continuous_train_and_eval`` of both CLIs on the same records,
  2 steps a round with dropout 0: the port's ``continuous_results.jsonl``
  equal to JAX's within the 1e-4 of ``test_cli_train_and_eval_matches_jax``
  (every classification tensor comes from the checkpoint, so the fresh
  initialisations do not matter).  The JAX watch is shortened by wrapping
  its ``run_continuous_finetune``, the port's by its CLI constants.
* ``run_continuous_finetune`` alone: a checkpoint that appears while it
  watches is finetuned in a second round, from a fresh state (the previous
  round's freed first) and the same iterator; step ``i`` of a round draws
  the dropout streams of (seed, ``i``).
* The break rules (``stop_after``, ``timeout_s``, neither) on stub states:
  the same rounds, steps and waits as JAX's function.

The JAX package's ``CheckpointManager`` (Orbax) lists its steps once, when
it is made, so JAX's watch never sees a checkpoint written after it
started; the port lists the directory at every poll.  The comparisons with
JAX therefore use checkpoints present from the start.
"""

import functools
import gc
import json
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch
import yaml

from mmt_tpu.train import continuous as jax_continuous
from mmt_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from mmt_tpu_torch.cli import train as cli_train
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.train import continuous
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_checkpoint import _pretrain_params
from tests.test_torch_finetune import cli_yaml, write_paired_records, write_vocab

HEADS = [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]


def _read(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_continuous_matches_jax(tmp_path, monkeypatch, caplog):
    from mmt_tpu.cli.train import main as jax_main

    params, pre_model = _pretrain_params(HEADS)
    JaxCheckpointManager(str(tmp_path / "jax_pre")).save(0, params)
    CheckpointManager(str(tmp_path / "torch_pre")).save(0, pre_model)
    converted = params_from_flax(params, pre_model)
    restored = CheckpointManager(str(tmp_path / "torch_pre")).restore(0)
    assert restored.keys() == converted.keys()
    assert all(torch.equal(restored[k], v) for k, v in converted.items())

    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 40, seed=0)
    val = write_paired_records(tmp_path / "val.tfrecord", 16, seed=1)
    for name, impl in (("jax", "xla"), ("torch", "pallas")):
        (tmp_path / f"{name}.yaml").write_text(
            yaml.safe_dump(cli_yaml(vocab, train, val, impl, steps=2)))

    orig = jax_continuous.run_continuous_finetune
    monkeypatch.setattr(jax_continuous, "run_continuous_finetune", lambda **kw: orig(
        **{**kw, "timeout_s": 1e-3, "poll_interval_s": 0.01}))
    jax_main(["--experiment=mmt/classification", "--mode=continuous_train_and_eval",
              f"--pretrain_model_dir={tmp_path / 'jax_pre'}",
              f"--model_dir={tmp_path / 'jax_ft'}", f"--config_file={tmp_path / 'jax.yaml'}"])
    monkeypatch.setattr(cli_train, "CONTINUOUS_TIMEOUT_S", 1e-3)
    monkeypatch.setattr(cli_train, "CONTINUOUS_POLL_S", 0.01)
    with caplog.at_level("INFO"):
        results = cli_train.main([
            "--experiment=mmt/classification", "--mode=continuous_train_and_eval",
            f"--pretrain_model_dir={tmp_path / 'torch_pre'}",
            f"--model_dir={tmp_path / 'torch_ft'}", f"--config_file={tmp_path / 'torch.yaml'}",
            "--device=cpu"])
    want = _read(tmp_path / "jax_ft" / "continuous_results.jsonl")
    got = _read(tmp_path / "torch_ft" / "continuous_results.jsonl")
    assert list(results) == [0] and len(got) == len(want) == 1
    assert got[0].keys() == want[0].keys() >= {"cls_accuracy", "cls_loss", "auc", "pretrain_step"}
    assert got[0]["pretrain_step"] == want[0]["pretrain_step"] == 0
    for key in want[0]:
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=0, atol=1e-4, err_msg=key)
    n_tensors = len([k for k in converted if k.startswith(("encoder.", "cls_heads."))])
    assert f"count_restored={n_tensors} tensors" in caplog.text
    assert not (tmp_path / "torch_ft" / "params.yaml").exists()


def test_cli_continuous_needs_a_pretrain_model_dir(tmp_path):
    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 8, seed=0)
    (tmp_path / "itm.yaml").write_text(yaml.safe_dump(cli_yaml(vocab, train, train, "pallas")))
    with pytest.raises(ValueError, match="--pretrain_model_dir"):
        cli_train.main(["--experiment=mmt/classification", "--mode=continuous_train_and_eval",
                        f"--model_dir={tmp_path / 'ft'}", f"--config_file={tmp_path / 'itm.yaml'}",
                        "--device=cpu"])


# ------------------------------------------------------ the function alone


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(2, 2)
        self.other = torch.nn.Linear(2, 1)


def _save_pretrain(directory, step, value):
    model = _Model()
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(value)
    CheckpointManager(str(directory)).save(step, model)


def test_a_checkpoint_written_while_watching_gets_a_round(tmp_path):
    _save_pretrain(tmp_path / "pre", 0, 1.0)
    model = _Model()
    with torch.no_grad():
        model.other.weight.fill_(-3.0)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    made, trained, previous = [], [], []

    def make_state():
        # The previous round's state is gone before the next is built.
        previous.append(made[-1]() if made else None)
        model.load_state_dict(fresh)
        state = TrainState(step=0, model=model, optimizer=torch.optim.SGD(model.parameters(),
                                                                          lr=0.1))
        made.append(weakref.ref(state.optimizer))
        return state

    def train_step(state, batch, rngs):
        trained.append((batch, model.encoder.weight[0, 0].item(), model.other.weight[0, 0].item(),
                        rngs.seed()))
        with torch.no_grad():
            model.encoder.weight.add_(1.0)
            model.other.weight.add_(1.0)
        return state, {}

    def eval_fn(state):
        gc.collect()
        return {"w": model.encoder.weight[0, 0].item()}

    def save_when_first_line():
        path = tmp_path / "ft" / "continuous_results.jsonl"
        deadline = time.time() + 60
        while not path.exists() and time.time() < deadline:
            time.sleep(0.01)
        _save_pretrain(tmp_path / "pre", 5, 10.0)

    helper = threading.Thread(target=save_when_first_line)
    helper.start()
    batches = iter(range(100))
    results = continuous.run_continuous_finetune(
        pretrain_model_dir=str(tmp_path / "pre"), model_dir=str(tmp_path / "ft"),
        make_state=make_state, train_step=train_step, train_iter_fn=lambda: batches,
        eval_fn=eval_fn, steps_per_checkpoint=2, seed=4, poll_interval_s=0.01, stop_after=2)
    helper.join(timeout=60)
    assert not helper.is_alive()
    assert results == {0: {"w": 3.0, "pretrain_step": 0}, 5: {"w": 12.0, "pretrain_step": 5}}
    assert _read(tmp_path / "ft" / "continuous_results.jsonl") == [
        {"w": 3.0, "pretrain_step": 0}, {"w": 12.0, "pretrain_step": 5}]
    # One iterator across rounds; the encoder from the checkpoint and the
    # rest fresh at the start of each round.
    assert [(b, e, o) for b, e, o, _ in trained] == [
        (0, 1.0, -3.0), (1, 2.0, -2.0), (2, 10.0, -3.0), (3, 11.0, -2.0)]
    from mmt_tpu_torch.models import DropoutRngs

    seeds = [DropoutRngs.for_step(4, i, "cpu").seed() for i in (0, 1)]
    assert [s for *_, s in trained] == seeds + seeds
    assert previous == [None, None]  # round 1's optimizer was freed before round 2's


# ------------------------------------------------------------- break rules

SCENARIOS = {
    # name: (checkpoints present, timeout_s, stop_after)
    "nothing_and_no_limits": ((), 0.0, 0),
    "one_checkpoint_no_limits": ((3,), 0.0, 0),
    "stop_after_one_of_two": ((2, 7), 0.0, 1),
    "idle_until_timeout": ((3,), 0.3, 0),
    "empty_until_timeout": ((), 0.3, 0),
    "stop_after_before_timeout": ((3,), 30.0, 1),
}


def _jax_run(directory, steps, timeout_s, stop_after):
    for step in steps:
        JaxCheckpointManager(str(directory / "pre")).save(step, {"encoder": {"w": np.zeros(2)}})

    class State:
        def __init__(self, params):
            self.params = params

        def replace(self, params):
            return State(params)

    trained = []
    t0 = time.perf_counter()
    results = jax_continuous.run_continuous_finetune(
        pretrain_model_dir=str(directory / "pre"), model_dir=str(directory / "ft"),
        make_state=lambda: State({"encoder": {"w": np.ones(2)}}),
        train_step=lambda state, batch, rng: (trained.append(batch) or state, {}),
        train_iter_fn=lambda: iter(range(100)), eval_fn=lambda state: {},
        steps_per_checkpoint=2, rng=jax.random.PRNGKey(0), poll_interval_s=0.05,
        timeout_s=timeout_s, stop_after=stop_after)
    return sorted(results), len(trained), time.perf_counter() - t0


def _torch_run(directory, steps, timeout_s, stop_after):
    for step in steps:
        _save_pretrain(directory / "pre", step, 1.0)
    trained = []
    t0 = time.perf_counter()
    results = continuous.run_continuous_finetune(
        pretrain_model_dir=str(directory / "pre"), model_dir=str(directory / "ft"),
        make_state=lambda: TrainState(step=0, model=_Model(), optimizer=None),
        train_step=lambda state, batch, rngs: (trained.append(batch) or state, {}),
        train_iter_fn=lambda: iter(range(100)), eval_fn=lambda state: {},
        steps_per_checkpoint=2, poll_interval_s=0.05, timeout_s=timeout_s,
        stop_after=stop_after)
    return sorted(results), len(trained), time.perf_counter() - t0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_break_rules_match_jax(tmp_path, scenario):
    steps, timeout_s, stop_after = SCENARIOS[scenario]
    want = _jax_run(tmp_path / "jax", steps, timeout_s, stop_after)
    got = _torch_run(tmp_path / "torch", steps, timeout_s, stop_after)
    assert got[:2] == want[:2]
    assert got[0] == ([max(steps)] if steps else [])
    if timeout_s and not stop_after:
        assert got[2] >= timeout_s and want[2] >= timeout_s  # waited out the deadline
    else:
        assert got[2] < 5.0  # ended without waiting
