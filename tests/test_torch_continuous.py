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
* ``sync`` on stub states: each poll's local reading goes through it once
  and the rounds follow what it returns, where it differs from the local
  reading either way (a new step or an expired deadline seen by this rank
  alone, or by rank 0 alone); ``write_results`` False leaves no results
  file.

* Across processes (``parallel.launch.run_local``, the ranks' code in
  ``tests/torch_gloo_workers.py``): the CLI on 2 ``gloo`` ranks,
  data-parallel with ZeRO-1, a second checkpoint written once the first
  results line exists (the watch shortened to end after two rounds).  Both ranks log the same two rounds, rank 0 alone
  writes the results, and they equal a one-process port run on the ranks'
  batches (each step's global batch rank-major, as the data-parallel step
  sees it) within 1e-6; the first round equals JAX's on a 2-device mesh
  fed the same batches within 1e-4.  And one round on a 2-stage pipe
  mesh against the unpipelined one-process run, at
  ``test_torch_pipeline``'s tolerances.

The JAX package's ``CheckpointManager`` (Orbax) lists its steps once, when
it is made, so JAX's watch never sees a checkpoint written after it
started; the port lists the directory at every poll.  The comparisons with
JAX therefore use checkpoints present from the start.
"""

import copy
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
from mmt_tpu.data import loaders as jax_loaders
from mmt_tpu_torch.cli import train as cli_train
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.data import loaders
from mmt_tpu_torch.parallel.launch import run_local
from mmt_tpu_torch.train import continuous
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_checkpoint import _pretrain_params
from tests import torch_gloo_workers
from tests.test_torch_finetune import cli_yaml, write_paired_records, write_vocab

HEADS = [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A JAX pretraining checkpoint (step 0), the port's model holding it,
    the paired records and a vocab."""
    root = tmp_path_factory.mktemp("continuous")
    params, pre_model = _pretrain_params(HEADS)
    JaxCheckpointManager(str(root / "jax_pre")).save(0, params)
    return {"root": root, "params": params, "model": pre_model, "vocab": write_vocab(root),
            "train": write_paired_records(root / "train.tfrecord", 80, seed=0),
            "val": write_paired_records(root / "val.tfrecord", 48, seed=1)}


def _read(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_continuous_matches_jax(pretrained, tmp_path, monkeypatch, caplog):
    from mmt_tpu.cli.train import main as jax_main

    params, pre_model = pretrained["params"], pretrained["model"]
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


# ------------------------------------------------------- across processes

RANKS = 2
# The two-round watch of the several-process run ends after its second
# round, or this long after its start if that round never comes.
WATCH_S = 120.0


class _RankMajor:
    """The ranks' streams as one: each batch is rank 0's rows, then rank
    1's, ..., as the data-parallel step assembles the global batch."""

    def __init__(self, streams):
        self.streams = streams

    def __iter__(self):
        return self

    def __next__(self):
        parts = [next(s) for s in self.streams]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def state(self):
        return [s.state() for s in self.streams]


def _feed_rank_major(monkeypatch, loader_cls):
    """One process's ``loader_cls`` streams yield the RANKS ranks' batches,
    rank-major."""
    orig = loader_cls.stream

    def stream(self, shard_index=0, num_shards=1, batch_size=None):
        assert (shard_index, num_shards) == (0, 1)
        local = (batch_size or self.cfg.global_batch_size) // RANKS
        return _RankMajor([orig(self, r, RANKS, local) for r in range(RANKS)])

    monkeypatch.setattr(loader_cls, "stream", stream)


def _save_when_results(model_dir, pre_dir, model, step):
    """A thread that saves ``model`` as ``step`` in ``pre_dir`` once
    ``model_dir`` has its first results line."""
    def run():
        path = model_dir / "continuous_results.jsonl"
        deadline = time.time() + 120
        while not path.exists() and time.time() < deadline:
            time.sleep(0.01)
        CheckpointManager(str(pre_dir)).save(step, model)

    thread = threading.Thread(target=run)
    thread.start()
    return thread


def _continuous_argv(pre_dir, model_dir, config):
    return ["--experiment=mmt/classification", "--mode=continuous_train_and_eval",
            f"--pretrain_model_dir={pre_dir}", f"--model_dir={model_dir}",
            f"--config_file={config}", "--device=cpu"]


def _config(pretrained, path, runtime, impl="pallas", batch=64):
    cfg = cli_yaml(pretrained["vocab"], pretrained["train"], pretrained["val"], impl, steps=2)
    cfg["task"]["train_data"]["global_batch_size"] = batch
    cfg["task"]["validation_data"]["global_batch_size"] = batch
    cfg["trainer"]["validation_steps"] = 2
    cfg["runtime"] = runtime
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_two_process_continuous_zero1(pretrained, tmp_path, monkeypatch):
    from mmt_tpu.cli.train import main as jax_main

    second = copy.deepcopy(pretrained["model"])  # the second pretraining checkpoint
    with torch.no_grad():
        for p in second.parameters():
            p.mul_(0.9)
    torch_cfg = _config(pretrained, tmp_path / "torch.yaml",
                        {"num_data_parallel": 0, "zero_sharded_optimizer": True})
    jax_cfg = _config(pretrained, tmp_path / "jax.yaml",
                      {"num_data_parallel": RANKS, "zero_sharded_optimizer": True}, "xla")
    one_cfg = _config(pretrained, tmp_path / "one.yaml", {"num_data_parallel": 1})
    for name in ("mp_pre", "sp_pre"):
        CheckpointManager(str(tmp_path / name)).save(0, pretrained["model"])

    # Two ranks, the CLI's own watch; a second checkpoint once the first
    # results line exists.
    helper = _save_when_results(tmp_path / "mp", tmp_path / "mp_pre", second, 5)
    outs = run_local(torch_gloo_workers.run_continuous_cli, RANKS,
                     _continuous_argv(tmp_path / "mp_pre", tmp_path / "mp", torch_cfg), 2, WATCH_S)
    helper.join(timeout=60)
    n_tensors = len([k for k in pretrained["model"].state_dict()
                     if k.startswith(("encoder.", "cls_heads."))])
    for out in outs:
        rounds = [line for line in out["log"].splitlines() if "count_restored" in line]
        assert [r.split("@ ")[1].split(":")[0] for r in rounds] == ["0", "5"], out["log"]
        assert all(f"count_restored={n_tensors} tensors" in r for r in rounds)
        assert out["result"] == repr(dict)
    got = _read(tmp_path / "mp" / "continuous_results.jsonl")
    assert [r["pretrain_step"] for r in got] == [0, 5]  # one writer: no line twice

    # One process on the ranks' batches, rank-major, the same two rounds.
    _feed_rank_major(monkeypatch, loaders.MmtClassificationLoader)
    orig = continuous.run_continuous_finetune
    monkeypatch.setattr(continuous, "run_continuous_finetune", lambda **kw: orig(
        **{**kw, "timeout_s": 0.0, "poll_interval_s": 0.01, "stop_after": 2}))
    helper = _save_when_results(tmp_path / "sp", tmp_path / "sp_pre", second, 5)
    cli_train.main(_continuous_argv(tmp_path / "sp_pre", tmp_path / "sp", one_cfg))
    helper.join(timeout=60)
    want = _read(tmp_path / "sp" / "continuous_results.jsonl")
    assert [r["pretrain_step"] for r in want] == [0, 5]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() >= {"cls_accuracy", "cls_loss", "auc"}
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=0, err_msg=key)
    assert got[0] != got[1]

    # JAX on a 2-device mesh, the same batches: the first round.
    _feed_rank_major(monkeypatch, jax_loaders.MmtClassificationLoader)
    jax_orig = jax_continuous.run_continuous_finetune
    monkeypatch.setattr(jax_continuous, "run_continuous_finetune", lambda **kw: jax_orig(
        **{**kw, "timeout_s": 1e-3, "poll_interval_s": 0.01}))
    jax_main(_continuous_argv(pretrained["root"] / "jax_pre", tmp_path / "jax", jax_cfg)[:-1])
    jax_rows = _read(tmp_path / "jax" / "continuous_results.jsonl")
    assert len(jax_rows) == 1 and jax_rows[0].keys() == got[0].keys()
    for key in jax_rows[0]:
        np.testing.assert_allclose(got[0][key], jax_rows[0][key], rtol=0, atol=1e-4,
                                   err_msg=key)


def test_two_process_continuous_on_the_pipe_mesh(pretrained, tmp_path, monkeypatch):
    """One round on a ('data', 'pipe') mesh of 1 x 2 (one layer a stage,
    2 micro-batches) against the unpipelined one-process run: both stages
    load the one-process batches."""
    piped = _config(pretrained, tmp_path / "piped.yaml",
                    {"num_pipeline_stages": RANKS, "num_pipeline_microbatches": 2})
    one = _config(pretrained, tmp_path / "one.yaml", {"num_data_parallel": 1})
    for name in ("pp_pre", "sp_pre"):
        CheckpointManager(str(tmp_path / name)).save(0, pretrained["model"])
    # The watch ends on rank 0's deadline, broadcast: one round on both.
    run_local(torch_gloo_workers.run_continuous_cli, RANKS,
              _continuous_argv(tmp_path / "pp_pre", tmp_path / "pp", piped))
    monkeypatch.setattr(cli_train, "CONTINUOUS_TIMEOUT_S", 1e-3)
    monkeypatch.setattr(cli_train, "CONTINUOUS_POLL_S", 0.01)
    cli_train.main(_continuous_argv(tmp_path / "sp_pre", tmp_path / "sp", one))
    got, want = (_read(tmp_path / d / "continuous_results.jsonl") for d in ("pp", "sp"))
    assert [r["pretrain_step"] for r in got] == [r["pretrain_step"] for r in want] == [0]
    assert got[0].keys() == want[0].keys() >= {"cls_accuracy", "cls_loss", "auc"}
    np.testing.assert_allclose(got[0]["cls_loss"], want[0]["cls_loss"], rtol=1e-5, atol=0)
    for key in want[0]:
        np.testing.assert_allclose(got[0][key], want[0][key], atol=1e-5, rtol=1e-4,
                                   err_msg=key)


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


# ------------------------------------------------------------ rank 0's poll

SYNCED = {
    # name: (timeout_s, sync's replies in order, the rounds taken)
    # This rank's deadline passes at once and it sees step 5 from the
    # start; rank 0 sees nothing, then 0, then 5, and then its deadline.
    "rank0_behind": (1e-6, [(None, False), (0, False), (0, False), (5, False), (5, True)],
                     [0, 5]),
    # This rank sees step 5 and its deadline far off; rank 0 still sees 0,
    # and then its deadline passes.
    "rank0_expired_first": (5.0, [(0, False), (0, True)], [0]),
}


@pytest.mark.parametrize("case", sorted(SYNCED))
def test_rounds_follow_the_synced_reading(tmp_path, case):
    timeout_s, replies, rounds = SYNCED[case]
    replies = list(replies)
    _save_pretrain(tmp_path / "pre", 0, 1.0)
    _save_pretrain(tmp_path / "pre", 5, 10.0)
    local, restored = [], []

    def sync(step, expired):
        local.append((step, expired))
        return replies.pop(0)

    def train_step(state, batch, rngs):
        restored.append(state.model.encoder.weight[0, 0].item())
        return state, {}

    results = continuous.run_continuous_finetune(
        pretrain_model_dir=str(tmp_path / "pre"), model_dir=str(tmp_path / "ft"),
        make_state=lambda: TrainState(step=0, model=_Model(), optimizer=None),
        train_step=train_step, train_iter_fn=lambda: iter(range(100)),
        eval_fn=lambda state: {}, steps_per_checkpoint=1, poll_interval_s=0.01,
        timeout_s=timeout_s, sync=sync, write_results=False)
    assert replies == []  # one reading a poll, and the loop ended where rank 0's did
    assert [step for step, _ in local] == [5] * len(local)
    if timeout_s < 1:  # every poll after the first sleep is past this rank's deadline
        assert all(expired for _, expired in local[1:])
    else:
        assert not any(expired for _, expired in local)
    assert list(results) == rounds
    assert restored == [{0: 1.0, 5: 10.0}[step] for step in rounds]
    assert (tmp_path / "ft").is_dir()
    assert not (tmp_path / "ft" / "continuous_results.jsonl").exists()
