"""Drives the task's train step: ``PretrainingTask.make_train_step(
micro_batch_size)`` or ``ClassificationTask.make_train_step()``, one
optimizer step of the configuration's global batch per call.

Set-up builds one task, model and AdamW from the benchmark's weights and
drives it through the mix's ``checked_steps`` first steps, on the pool's
first batches, through the window's own call: those steps are the warm-up,
and the program's readings for ``correct`` (each step's loss, the first
gradient from AdamW's first moment, the change of every leaf) are taken
from them.  The same objects then train on in the window, cycling the pool,
each step with the dropout streams of (dropout seed, step).
"""

from __future__ import annotations

import gc
import time

import torch

from mmtbench import generate
from mmtbench.harness import phase, sync
from mmtbench.reference import compare, model as ref_model, train as ref_train
from mmtbench.weights import make_weights

TASKS = {
    "pretraining": ("PretrainingTask", generate.pretraining_batch, ref_model.pretraining_loss),
    "classification": ("ClassificationTask", generate.classification_batch,
                       ref_model.classification_loss),
}


class Session:
    rate_metric = "train_examples_per_s"
    sources = ("rel_attention_fwd", "rel_attention_bwd")

    def __init__(self, exp, mix, shape, seed, device, setup_times):
        self.exp, self.mix, self.shape, self.seed = exp, mix, shape, seed
        self.device, self.times = torch.device(device), setup_times
        self.kind = mix["task"]
        self.rows = exp.task.train_data.global_batch_size
        self.micro = exp.trainer.micro_batch_size if self.kind == "pretraining" else 0
        self.dropout_seed = generate.seed_of(seed, 4)

    def setup(self):
        with phase(self.times, "import"):
            from mmt_tpu_torch.models import DropoutRngs
            from mmt_tpu_torch.train import tasks
            from mmt_tpu_torch.train.optimizer import create_optimizer
            from mmt_tpu_torch.train.train_state import TrainState
        self.rngs = DropoutRngs.for_step
        with phase(self.times, "build"):
            build_sources(self.device, self.sources)
        with phase(self.times, "model"):
            task_cls, self.make_batch, self.ref_loss = TASKS[self.kind]
            self.task = getattr(tasks, task_cls)(self.exp.task, self.exp.trainer,
                                                 device=self.device)
            params = dict(self.task.model.named_parameters())
            self.leaf_shapes = {n: tuple(p.shape) for n, p in params.items()}
            weights = self.weights()
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(weights[name])
            optimizer = create_optimizer(self.exp.trainer.optimizer_config,
                                         self.exp.trainer.train_steps, self.task.model)
            self.state = TrainState.create(self.task.model, optimizer)
            self.step_fn = (self.task.make_train_step(micro_batch_size=self.micro)
                            if self.kind == "pretraining" else self.task.make_train_step())
        with phase(self.times, "inputs"):
            gen = torch.Generator(self.device).manual_seed(generate.seed_of(self.seed, 1))
            self.pool = [self.make_batch(self.mix, self.shape, self.rows, gen, self.device)
                         for _ in range(self.mix["pool"])]
        self.program = self.first_steps(optimizer, weights)
        del weights

    def weights(self):
        return make_weights(self.leaf_shapes, self.seed, self.shape["initializer_range"],
                            self.device)

    def run_step(self, i):
        """Step ``i`` through the window's call; its loss stays on the device."""
        self.state, sums = self.step_fn(self.state, self.pool[i % len(self.pool)],
                                        self.rngs(self.dropout_seed, i, self.device))
        return sums["total_loss"][0]

    def first_steps(self, optimizer, weights):
        losses, grads = [], None
        for i in range(self.mix["checked_steps"]):
            with phase(self.times, "first step" if i == 0 else "warmup"):
                losses.append(float(self.run_step(i)))
            if grads is None:
                grads = {n: float(torch.linalg.vector_norm(m)) / (1 - optimizer.b1)
                         for n, m in optimizer.mu.items()}
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(p - weights[n]))
                      for n, p in self.task.model.named_parameters()}
        self.next_step = self.mix["checked_steps"]
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def window(self, seconds):
        """Steps until ``seconds`` have passed, read back once after the
        closing synchronise, as the program's own loop reads them."""
        start, losses = self.next_step, []
        t0 = time.perf_counter()
        while True:
            losses.append(self.run_step(self.next_step))
            self.next_step += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        steps = self.next_step - start
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"seconds": elapsed, "attempted": steps * self.rows, "failed": failed * self.rows,
                "metrics": {self.rate_metric: steps * self.rows / elapsed},
                "work": self.work(range(start, self.next_step))}

    def work(self, steps) -> dict:
        """What the steps ``steps`` computed: each example's length, the
        MLM targets, and each attention call's lengths (one per layer and
        micro-batch)."""
        micro = self.micro or self.rows
        calls, examples, targets = [], [], 0
        for i in steps:
            batch = self.pool[i % len(self.pool)]
            lengths = batch["lengths"].tolist()
            examples += lengths
            if "mlm_label_weights" in batch:
                targets += int((batch["mlm_label_weights"] > 0).sum())
            for m in range(0, self.rows, micro):
                calls += [lengths[m:m + micro]] * self.shape["layers"]
        return {"training": True, "examples": examples, "mlm_targets": targets,
                "attention_calls": calls}

    def trace(self):
        from mmtbench.trace import trace

        n = self.mix["traced_steps"]
        start = self.next_step
        work = self.work(range(start, start + n))
        calls = len(work["attention_calls"])
        expected = {"rel_attention_fwd_kernel": calls, "rel_attention_bwd_kernel": calls}

        def run():
            for i in range(start, start + n):
                self.run_step(i)

        out = trace(run, n, work, expected, self.mix["trace_host"])
        self.next_step += n
        return out

    def release(self):
        del self.state, self.step_fn, self.task
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="fp32") -> dict:
        """The reference's readings (in ``precision``: fp8 is the control)
        over the checked steps' batches, weights and dropout."""
        steps = self.mix["checked_steps"]
        return ref_train.follow(
            self.weights(), ref_model.Geometry(self.shape["reference"], self.shape["seq_len"]),
            self.shape["optimizer"], self.ref_loss, self.micro,
            [self.pool[i % len(self.pool)] for i in range(steps)], self.dropout_seed,
            ref_model.Precision(precision))

    def check(self, limits):
        """The numbers of ``compare.training_numbers``: the program's first
        steps against the reference's; no answer of the window is judged
        one by one."""
        return compare.training_numbers(self.program, self.reference()), 0


def build_sources(device, sources):
    """Builds the port's CUDA sources (only the first run of a checkout
    compiles; later runs find the libraries in the build directory)."""
    if device.type != "cuda":
        return
    from mmt_tpu_torch.ops import build

    build.build_all(list(sources))
