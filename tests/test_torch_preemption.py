"""The port's preemption watcher and loop against the JAX package's rules.

The six cases of ``tests/test_preemption.py``, on the tiny pretraining
task of ``tests/test_torch_train.py`` (one batch repeated):

* a real SIGTERM before the third batch: step 3 completes, checkpoints and
  raises ``TrainingPreempted(3)``; the previous handler is back; a rerun
  resumes there and finishes;
* ``save_on_preemption`` off: no handler is installed;
* an injected watcher's ``trigger()`` preempts at the step it lands in;
* a signal during the last step ends the run normally;
* a resume continues the input stream exactly (no replayed batch);
* the preemption save includes the stream's snapshot, which the rerun
  restores.

Also the watcher alone: handlers installed and restored, off the main
thread ``trigger()`` only.
"""

import os
import signal
import threading

import pytest

from mmt_tpu_torch.configs import TrainerConfig
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.loop import run_training
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.preemption import PreemptionWatcher, TrainingPreempted
from mmt_tpu_torch.train.tasks import batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_train import _batch, _torch_task

BATCH = batch_to_device(_batch(), "cpu")


def _run(model_dir, trainer, train_iter, watcher=None):
    """run_training of a fresh tiny task (the same initialisation every
    time) with AdamW over 50 steps."""
    task = _torch_task()
    state = TrainState.create(task.model, create_optimizer(trainer.optimizer_config, 50,
                                                           task.model))
    return run_training(train_step=task.make_train_step(), state=state, train_iter=train_iter,
                        trainer=trainer, model_dir=str(model_dir), preemption_watcher=watcher)


def _trainer(**kw):
    # checkpoint_interval 100 > train_steps: only the preemption save (and
    # the last step) can make a checkpoint.
    base = dict(train_steps=50, steps_per_loop=1, summary_interval=100, checkpoint_interval=100,
                validation_interval=1000)
    return TrainerConfig(**{**base, **kw})


def _sigterm_after(n):
    """Yields the batch; sends this process a real SIGTERM before the
    (n+1)-th."""
    i = 0
    while True:
        if i == n:
            os.kill(os.getpid(), signal.SIGTERM)
        yield BATCH
        i += 1


def _repeat():
    while True:
        yield BATCH


def test_sigterm_checkpoints_and_raises(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(TrainingPreempted) as exc:
        _run(tmp_path / "m", _trainer(), _sigterm_after(2))
    # The signal lands before batch 3: step 3 completes, saves and exits.
    assert exc.value.step == 3
    assert CheckpointManager(str(tmp_path / "m")).steps() == [3]
    assert signal.getsignal(signal.SIGTERM) == before
    done = _run(tmp_path / "m", _trainer(train_steps=5), _repeat())
    assert done.step == 5
    assert CheckpointManager(str(tmp_path / "m")).latest_step() == 5


def test_save_on_preemption_off(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def watch():
        for _ in range(3):
            seen.append(signal.getsignal(signal.SIGTERM))
            yield BATCH

    done = _run(tmp_path / "m", _trainer(train_steps=2, checkpoint_interval=2,
                                         save_on_preemption=False), watch())
    assert done.step == 2
    assert seen == [before, before]  # no handler at any step
    assert signal.getsignal(signal.SIGTERM) == before


def test_injected_watcher_trigger(tmp_path):
    watcher = PreemptionWatcher()

    def gen():
        i = 0
        while True:
            if i == 1:
                watcher.trigger()
            yield BATCH
            i += 1

    with pytest.raises(TrainingPreempted) as exc:
        _run(tmp_path / "m", _trainer(train_steps=10), gen(), watcher)
    assert exc.value.step == 2
    assert CheckpointManager(str(tmp_path / "m")).latest_step() == 2


def test_no_preemption_at_final_step(tmp_path):
    done = _run(tmp_path / "m", _trainer(train_steps=2), _sigterm_after(1))
    assert done.step == 2
    assert CheckpointManager(str(tmp_path / "m")).latest_step() == 2


class _CountingStream:
    """A TrainStream-shaped stream that counts the batches taken and
    records where a restore put it."""

    def __init__(self, signal_at=None):
        self.i = 0
        self.restored_to = None
        self.signal_at = signal_at

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == self.signal_at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.i += 1
        return BATCH

    def state(self):
        return {"i": self.i}

    def restore(self, st):
        self.i = st["i"]
        self.restored_to = st["i"]


def test_resume_continues_input_stream_exactly(tmp_path):
    trainer = _trainer(train_steps=5, checkpoint_interval=2)
    first = _CountingStream()
    _run(tmp_path / "m", trainer, first)
    assert first.i == 5
    assert sorted(os.listdir(tmp_path / "m" / "data_stream")) == ["step_4.pkl", "step_5.pkl"]
    second = _CountingStream()
    done = _run(tmp_path / "m", _trainer(train_steps=8, checkpoint_interval=2), second)
    assert done.step == 8
    assert second.restored_to == 5  # moved on, not replayed
    assert second.i == 8  # took exactly batches 6, 7 and 8


def test_preemption_save_includes_stream_state(tmp_path):
    with pytest.raises(TrainingPreempted) as exc:
        _run(tmp_path / "m", _trainer(), _CountingStream(signal_at=2))
    step = exc.value.step
    assert (tmp_path / "m" / "data_stream" / f"step_{step}.pkl").exists()
    again = _CountingStream()
    _run(tmp_path / "m", _trainer(train_steps=step + 2), again)
    assert again.restored_to == step
    assert again.i == step + 2


def test_watcher_installs_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionWatcher() as watcher:
        assert signal.getsignal(signal.SIGTERM) == watcher._handle
        assert not watcher.flagged_locally and not watcher.should_save(True)
        os.kill(os.getpid(), signal.SIGTERM)
        assert watcher.flagged_locally
        assert watcher.should_save(False) and watcher.should_save(True)
    assert signal.getsignal(signal.SIGTERM) == before


def test_watcher_off_the_main_thread_is_trigger_only(caplog):
    before = signal.getsignal(signal.SIGTERM)
    out = {}

    def body():
        with PreemptionWatcher() as watcher:
            out["installed"] = signal.getsignal(signal.SIGTERM) != before
            watcher.trigger()
            out["flag"] = watcher.should_save(False)

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == {"installed": False, "flag": True}
    assert "not on the main thread" in caplog.text
