"""Asynchronous checkpoints of the port's ``CheckpointManager``.

The JAX package hands this to Orbax (``async_save``); the port writes with
one background thread after a copy to host memory.  Held here:

* an async save followed at once by an in-place update of the parameters
  and the optimizer moments: the checkpoint holds the values from before
  the update, bit for bit;
* a writer's exception is raised again by ``wait_until_finished`` and by
  the next ``save``;
* ``steps()`` never lists a step whose ``model.pt`` is still being
  written, and a second save waits for the first;
* sync and async saves give the same files' contents.
"""

import threading

import pytest
import torch

from mmt_tpu_torch.configs import TrainerConfig
from mmt_tpu_torch.train import checkpoint as checkpoint_lib
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.train_state import TrainState


def _state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.LayerNorm(8))
    opt = create_optimizer(TrainerConfig().optimizer_config, 10, model)
    state = TrainState.create(model, opt)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    return state.apply_gradients()


@pytest.fixture
def held_writes(monkeypatch):
    """torch.save blocks on model.pt until the test releases it."""
    release, writing = threading.Event(), threading.Event()
    real_save = torch.save

    def save(obj, path):
        if str(path).endswith("model.pt.tmp"):
            writing.set()
            assert release.wait(timeout=60)
        real_save(obj, path)

    monkeypatch.setattr(checkpoint_lib.torch, "save", save)
    return release, writing


def test_async_save_holds_the_values_before_an_in_place_update(tmp_path, held_writes):
    release, writing = held_writes
    state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mu_before = {k: v.clone() for k, v in state.optimizer.mu.items()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state.model, state.optimizer)
    assert writing.wait(timeout=60)
    for p in state.model.parameters():  # the next step's in-place update
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    assert not torch.equal(state.model.state_dict()["0.weight"], before["0.weight"])
    release.set()
    mgr.wait_until_finished()
    saved = mgr.restore(1)
    for k, v in before.items():
        assert torch.equal(saved[k], v), k
    opt = torch.load(tmp_path / "1" / "optimizer.pt", weights_only=True)
    assert opt["count"] == 1
    for k, v in mu_before.items():
        assert torch.equal(opt["mu"][k], v), k


def test_steps_never_lists_a_step_being_written(tmp_path, held_writes):
    release, writing = held_writes
    state = _state()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    release.set()
    mgr.save(1, state.model, state.optimizer)
    mgr.wait_until_finished()
    release.clear()
    writing.clear()
    mgr.save(2, state.model, state.optimizer)
    assert writing.wait(timeout=60)
    assert (tmp_path / "2" / "optimizer.pt").exists()
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    # A second save waits for the first before it copies anything.
    third = threading.Thread(target=mgr.save, args=(3, state.model, state.optimizer))
    third.start()
    third.join(timeout=0.5)
    assert third.is_alive() and not (tmp_path / "3").exists()
    release.set()
    third.join(timeout=60)
    assert not third.is_alive()
    mgr.wait_until_finished()
    assert mgr.steps() == [1, 2, 3]


@pytest.mark.parametrize("where", ["wait_until_finished", "save"])
def test_writer_error_is_raised_again(tmp_path, monkeypatch, where):
    def failing_save(obj, path):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpoint_lib.torch, "save", failing_save)
    state = _state()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state.model, state.optimizer)  # returns: the write fails later
    with pytest.raises(OSError, match="No space left"):
        if where == "save":
            mgr.save(2, state.model, state.optimizer)
        else:
            mgr.wait_until_finished()
    mgr.wait_until_finished()  # reported once
    assert mgr.steps() == []


@pytest.mark.parametrize("async_save", [False, True])
def test_sync_and_async_write_the_same_contents(tmp_path, async_save):
    state = _state(3)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=async_save)
    for step in (1, 2, 3):
        mgr.save(step, state.model, state.optimizer)
    mgr.wait_until_finished()
    assert mgr.steps() == [2, 3]
    fresh = _state(7)
    mgr.restore_train_state(fresh, 3)
    assert fresh.step == 3 and fresh.optimizer.count == state.optimizer.count
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in state.optimizer.nu.items():
        assert torch.equal(fresh.optimizer.nu[k], v), k
