"""Drives retrieval scoring: ``eval.predict.predict`` with the
classification task's inference step over batches of image-text pairs,
built in set-up as the host arrays that ``predict`` takes, so that the
copy to the card and the scores' copy back stay in the window.  The pool's
batches are cycled; set-up scores each once (the warm-up).

Every answer the window returns is held against the reference's
probability for its pair.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from mmtbench import generate
from mmtbench.drivers.train_step import build_sources
from mmtbench.harness import phase, sync
from mmtbench.reference import model as ref_model
from mmtbench.weights import make_weights

BLOCK = 128  # rows of one reference forward


class Session:
    rate_metric = "score_pairs_per_s"
    sources = ("rel_attention_fwd",)

    def __init__(self, exp, mix, shape, seed, device, setup_times):
        self.exp, self.mix, self.shape, self.seed = exp, mix, shape, seed
        self.device, self.times = torch.device(device), setup_times

    def setup(self):
        with phase(self.times, "import"):
            from mmt_tpu_torch.eval.predict import predict
            from mmt_tpu_torch.train.tasks import ClassificationTask
        self.predict = predict
        with phase(self.times, "build"):
            build_sources(self.device, self.sources)
        with phase(self.times, "model"):
            self.task = ClassificationTask(self.exp.task, self.exp.trainer, device=self.device)
            params = dict(self.task.model.named_parameters())
            self.leaf_shapes = {n: tuple(p.shape) for n, p in params.items()}
            weights = self.weights()
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(weights[name])
            del weights
            self.step = self.task.make_inference_step()
        with phase(self.times, "inputs"):
            self.pool = generate.score_batches(self.mix, self.shape, self.seed, self.device)
        with phase(self.times, "first batch"):
            self.score(self.pool[:1])
        with phase(self.times, "warmup"):
            self.score(self.pool[1:])
        self.slots, self.answers = [], []

    def weights(self):
        return make_weights(self.leaf_shapes, self.seed, self.shape["initializer_range"],
                            self.device)

    def score(self, batches) -> list:
        return [r.output for r in self.predict(self.step, batches)]

    def window(self, seconds):
        t0 = time.perf_counter()

        def batches():
            i = 0
            while time.perf_counter() - t0 < seconds:
                self.slots.append(i % len(self.pool))
                yield self.pool[i % len(self.pool)]
                i += 1

        self.answers += self.score(batches())
        sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "attempted": len(self.slots) * self.mix["batch"],
                "failed": 0, "metrics": {self.rate_metric: len(self.answers) / elapsed},
                "work": self.work(self.slots)}

    def work(self, slots) -> dict:
        """What scoring the pool's batches ``slots`` computed: each pair's
        length and each attention call's lengths (one per layer and batch)."""
        calls, examples = [], []
        for i in slots:
            lengths = self.pool[i]["lengths"].tolist()
            examples += lengths
            calls += [lengths] * self.shape["layers"]
        return {"training": False, "examples": examples, "attention_calls": calls}

    def trace(self):
        from mmtbench.trace import trace

        n = self.mix["traced_batches"]
        chosen = [i % len(self.pool) for i in range(n)]
        work = self.work(chosen)

        def run():
            self.slots.extend(chosen)
            self.answers.extend(self.score(self.pool[i] for i in chosen))

        return trace(run, n, work, {"rel_attention_fwd_kernel": len(work["attention_calls"])},
                     self.mix["trace_host"])

    def release(self):
        del self.step, self.task
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="fp32") -> list:
        """The reference's probabilities of every pair of the pool."""
        weights = self.weights()
        geometry = ref_model.Geometry(self.shape["reference"], self.shape["seq_len"])
        prec = ref_model.Precision(precision)
        out = []
        for batch in self.pool:
            probs = []
            for lo in range(0, len(batch["lengths"]), BLOCK):
                rows = {k: torch.as_tensor(v[lo:lo + BLOCK]).to(self.device)
                        for k, v in batch.items()}
                probs.append(ref_model.itm_probabilities(weights, rows, geometry, prec))
            out.append(torch.cat(probs).cpu().numpy())
        return out

    def check(self, limits):
        """``score_gap``: the widest |p - p_ref| over every answer of the
        window (infinite where an answer is missing); answers beyond the
        limit, or missing, count as failed."""
        return score_gaps(self.answers, self.slots, self.reference(), limits["score_gap"])


def score_gaps(answers, slots, reference, limit):
    """(numbers, failed answers) of ``answers``, the scores of the pool's
    batches ``slots`` in turn, against the reference's ``reference[slot]``."""
    want = np.concatenate([reference[slot] for slot in slots]) if slots else np.zeros(0)
    got = np.asarray(answers, np.float64)
    n = min(len(got), len(want))
    gaps = np.abs(got[:n] - want[:n])
    gaps = np.where(np.isfinite(gaps), gaps, np.inf)
    missing = len(want) - n
    worst = float(gaps.max()) if n and not missing else float("inf")
    return {"score_gap": worst}, int((gaps > limit).sum()) + missing + (len(got) - n)
