"""Faults planted in the program's timed path, for the checks that
``correct`` must catch them (the CPU tests, and ``readings.py`` on the
card).  Each is a context manager that patches the program and restores
it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged_state():
    """Every optimizer step returns its state unchanged."""
    from mmt_tpu_torch.train.train_state import TrainState

    original = TrainState.apply_gradients

    def apply_gradients(self):
        self.optimizer.zero_grad()
        self.step += 1
        return self

    TrainState.apply_gradients = apply_gradients
    try:
        yield
    finally:
        TrainState.apply_gradients = original


@contextlib.contextmanager
def half_batch():
    """Every train step sees the first half of its batch: the loss is the
    mean over that half."""
    from mmt_tpu_torch.train import tasks

    originals = {cls: cls.make_train_step for cls in (tasks.PretrainingTask,
                                                      tasks.ClassificationTask)}

    def wrap(make):
        def make_train_step(self, *args, **kwargs):
            step = make(self, *args, **kwargs)

            def halved(state, batch, rngs=None):
                rows = next(iter(batch.values())).shape[0] // 2
                return step(state, {k: v[:rows] for k, v in batch.items()}, rngs)

            return halved
        return make_train_step

    for cls, make in originals.items():
        cls.make_train_step = wrap(make)
    try:
        yield
    finally:
        for cls, make in originals.items():
            cls.make_train_step = make


@contextlib.contextmanager
def altered_answer():
    """The first score of every batch is moved by a half (up below 0.5,
    down above), so that it is altered however close to 0.5 it lies (1 - p
    barely moves a score near 0.5, as seeded weights give at small sizes)."""
    from mmt_tpu_torch.eval import predict

    original = predict.scores_from_logits

    def scores(logits, num_classes):
        s = original(logits, num_classes).clone()
        s[0] = s[0] + 0.5 if s[0] < 0.5 else s[0] - 0.5
        return s

    predict.scores_from_logits = scores
    try:
        yield
    finally:
        predict.scores_from_logits = original


@contextlib.contextmanager
def half_answers():
    """Every batch returns the scores of its first half only."""
    from mmt_tpu_torch.eval import predict

    original = predict.scores_from_logits

    def scores(logits, num_classes):
        s = original(logits, num_classes)
        return s[:len(s) // 2]

    predict.scores_from_logits = scores
    try:
        yield
    finally:
        predict.scores_from_logits = original


TRAINING = {"unchanged_state": unchanged_state, "half_batch": half_batch}
SCORING = {"altered_answer": altered_answer, "half_answers": half_answers}
