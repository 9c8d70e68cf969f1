"""The tasks: MLM + MPP (+ ITM) pretraining, and ITM classification
(finetuning and retrieval scoring).

Torch counterparts of ``mmt_tpu/train/tasks.py``.  ``PretrainingTask``:

* ``compute_loss``: the model on a batch, weighted sparse CE for MLM and
  MPP (masked on ITM-negative examples when the model has an ``itm`` head
  and the batch ITM weights) plus ITM, and the accuracies as
  (total, count) pairs;
* ``make_train_step``: one optimizer update per global batch; with
  ``micro_batch_size`` the batch is cut into k contiguous micro-batches
  and the gradients of loss / k are summed in the parameters' float32
  ``.grad`` (the JAX ``lax.scan`` accumulation), or with
  ``grad_accum_dtype="bfloat16"`` in a bf16 buffer per parameter (each
  micro-batch's gradient rounded to bf16 and added, the sum cast back to
  float32 before the update), and the micro-batches' metric pairs are
  summed;
* ``make_eval_step``: the loss and metrics in ``eval()`` mode, no grad.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``): each rank steps on
its own slice of the global batch (process-major), and the step computes
the one-process step on the global batch, as JAX's step under a mesh
does.  JAX cuts the global batch into k micro-batches of consecutive global
rows, and each micro-batch's MLM, MPP and ITM losses are weighted means
over that whole micro-batch.  So a rank cuts its rows where the global
micro-batches cut them (``micro_segments``), the micro-batches' weight sums
are all-reduced first, each row's loss is divided by its global
micro-batch's sum (``compute_loss(weight_sums=...)``), the gradients are
all-reduced over the data group once after the micro-batches (with
``num_model > 1`` the model group's replicas then take its first rank's
sums, so they stay equal), and so are the metric pairs.  Micro-batch m
draws its dropout streams from ``rngs.split(k)[m]`` on every rank; its
attention dropout hashes each row's index within micro-batch m
(``DropoutRngs.batch_start``), and its hidden, embedding and head masks
are drawn over all of micro-batch m's rows (``DropoutRngs.batch_rows``)
and sliced to the rank's, so every mask a rank applies is the one-process
step's (each rank draws the whole micro-batch's masks, as one process
would).

Pipelined steps (``make_pipelined_train_step(mesh, num_micro, remat=True,
zero1=False)`` on both tasks; ``parallel/pipeline.py``): on a ('data',
'pipe') mesh the encoder's layer stack runs as a GPipe pipeline over the
pipe group in ``num_micro`` micro-batches of the rank's rows, the
embeddings on the first stage and the heads and the loss on the last, over
the whole batch.  As in JAX's pipelined step, the loss is one weighted mean
over the global batch (the weight sums all-reduced over the data group),
one optimizer update per global batch; every gradient is summed over the
pipe group (each stage holds only its part), then over the data group as
above; with ``zero1`` the moments are sharded over the data group.  The
embedding and head dropout draw from ``rngs.split(2)``, the same streams on
every stage whichever process runs them, over the whole batch; the layers
then split the host stream by micro-batch (``parallel/pipeline.py``).  The
loss and metrics come from the last stage to every stage.  ``transport``
(default: one stage per rank of the pipe group) may be
``parallel.pipeline.InProcessTransport(S)``, all S stages in this process.
Under tensor parallelism (``parallel.param_sharding.shard_params``) the
same steps train the sharded model: ``DataParallel`` sums the relative
tables' gradients over the model group and keeps the replicated
parameters equal there.

``ClassificationTask`` builds the classification model of a
``ClassificationTaskConfig``:

* ``compute_loss``: the first head's logits against ``label_ids`` with
  ``label_weights`` and ``pos_weights``: sigmoid BCE for one class,
  sparse CE otherwise; ``cls_loss`` and ``cls_accuracy`` (the logit
  thresholded at 0 for one class, the argmax otherwise) as pairs;
* ``make_train_step``: one forward and backward over the whole batch and
  one optimizer update (JAX's classification step has no micro-batches;
  ``trainer.micro_batch_size`` is a pretraining knob);
* ``make_eval_step``: the metric pairs and the probabilities (sigmoid /
  softmax[:, 1] / argmax by the number of classes) for the host's AUC-PR;
* ``make_inference_step``: the scores alone, for retrieval.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from mmt_tpu_torch.configs.experiments import (
    ClassificationTaskConfig,
    PretrainingTaskConfig,
    TrainerConfig,
)
from mmt_tpu_torch.device import resolve_device
from mmt_tpu_torch.eval.predict import make_inference_step, scores_from_logits
from mmt_tpu_torch.models import DropoutRngs, MmtClassificationModel, MmtPretrainingModel
from mmt_tpu_torch.parallel.param_sharding import tp_param_kind
from mmt_tpu_torch.train import losses as losses_lib
from mmt_tpu_torch.train.metrics import weighted_accuracy
from mmt_tpu_torch.train.train_state import TrainState

MODEL_INPUT_KEYS = (
    "word_ids",
    "segment_ids",
    "patch_embeddings",
    "lengths",
    "images",  # patch extraction on the device (ship_raw_images)
    "patch_mask",  # MPP's patch zeroing on the device (pretraining, raw images)
)


_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Metrics whose count is one per (micro-)batch: a data-parallel step counts
# each once, on the rank that holds the batch's first row.
LOSS_METRICS = ("mlm_loss", "mpp_loss", "itm_loss", "cls_loss")


def _accumulate(params, acc, dtype):
    """Adds each parameter's ``.grad`` (a micro-batch's gradient), rounded
    to ``dtype``, to its running sum in ``dtype`` and clears it (JAX's
    ``a + g.astype(acc_dtype)``); returns the sums."""
    out = []
    for i, p in enumerate(params):
        g = torch.zeros_like(p, dtype=dtype) if p.grad is None else p.grad.to(dtype)
        out.append(g if acc is None else acc[i] + g)
        p.grad = None
    return out


def batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def micro_segments(local: int, data_rank: int, num_data: int, k: int):
    """Where a rank's rows meet the k global micro-batches: (m, lo, hi,
    offset) for each micro-batch m holding local rows [lo, hi), ``offset``
    being row lo's index within micro-batch m.  The global batch is
    process-major (data rank d holds rows [d local, (d + 1) local))."""
    size, start = local * num_data // k, data_rank * local
    for m in range(k):
        lo, hi = max(start, m * size), min(start + local, (m + 1) * size)
        if lo < hi:
            yield m, lo - start, hi - start, lo - m * size


class DataParallel:
    """A step's collectives over a ``Mesh`` (none without one): sums over
    the data group, and the model group's replicas kept equal."""

    def __init__(self, mesh=None):
        distributed = mesh is not None and mesh.distributed
        self.data_group = mesh.data_group if distributed else None
        self.model_group = mesh.model_group if distributed and mesh.num_model > 1 else None
        self.num_data = mesh.num_data if mesh is not None else 1
        self.data_rank = mesh.data_rank if mesh is not None else 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
            if self.model_group is not None:
                dist.broadcast(t, dist.get_global_rank(self.model_group, 0),
                               group=self.model_group)
        return t

    def gradients(self, params) -> None:
        """All-reduces the parameters' ``.grad`` over the data group in one
        flat buffer.  With tensor-parallel parameters
        (``parallel/param_sharding.py``) the relative tables' gradients are
        first summed over the model group, and only the replicated
        parameters take the model group's first rank's sums."""
        if self.data_group is None:
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        kinds = [tp_param_kind(p) for p in params]
        if self.model_group is None or not any(kinds):
            _set_grads(params, grads, self.all_reduce(_flat(grads)))
            return
        partial = [g for g, k in zip(grads, kinds) if k == "partial"]
        if partial:
            flat = _flat(partial)
            dist.all_reduce(flat, group=self.model_group)
            _set_grads([p for p, k in zip(params, kinds) if k == "partial"], partial, flat)
            grads = [p.grad for p in params]
        flat = _flat(grads)
        dist.all_reduce(flat, group=self.data_group)
        _set_grads(params, grads, flat)
        replicated = [p for p, k in zip(params, kinds) if k != "shard"]
        rep = _flat([p.grad for p in replicated])
        dist.broadcast(rep, dist.get_global_rank(self.model_group, 0), group=self.model_group)
        _set_grads(replicated, [p.grad for p in replicated], rep)

    def metrics(self, sums: Dict, device) -> Dict:
        """The metric pairs summed over the data group."""
        if self.data_group is None or not sums:
            return sums
        names = sorted(sums)
        flat = self.all_reduce(torch.stack(
            [torch.stack([torch.as_tensor(sums[n][0], device=device).float(),
                          torch.as_tensor(sums[n][1], device=device).float()])
             for n in names]))
        return {n: (flat[i, 0], flat[i, 1]) for i, n in enumerate(names)}


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _set_grads(params, like, flat: torch.Tensor) -> None:
    """Each parameter's ``.grad`` as its slice of ``flat`` (shaped like
    ``like``'s tensors)."""
    offset = 0
    for p, g in zip(params, like):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


def _pipe_gradients(transport, params) -> None:
    """Sums the parameters' ``.grad`` over the pipe group: each stage holds
    the gradients of its own layers (and the first the embeddings', the last
    the heads'); nothing to do when this process runs every stage."""
    if len(transport.stages) == transport.num_stages:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    _set_grads(params, grads, transport.all_reduce(_flat(grads)))


def _make_pipelined_step(task, mesh, num_micro: int, remat: bool, zero1: bool, transport):
    """The pipelined train step of ``task`` (``make_pipelined_train_step``)."""
    from mmt_tpu_torch.parallel.pipeline import EncoderPipeline, P2PTransport, check_pipe_mesh
    from mmt_tpu_torch.parallel.zero import shard_opt_state

    check_pipe_mesh(mesh)
    transport = transport if transport is not None else P2PTransport(mesh)
    pipe = EncoderPipeline(task.model.encoder, transport, num_micro, remat)
    dp = DataParallel(mesh)
    params = [p for p in task.model.parameters() if p.requires_grad]

    def step(state: TrainState, batch, rngs: Optional[DropoutRngs] = None):
        if zero1 and state.optimizer.zero is None:
            shard_opt_state(mesh, state.optimizer)
        word_ids = batch["word_ids"]
        local, seq_len = word_ids.shape
        embed_rngs = head_rngs = rngs
        if rngs is not None:
            # The embeddings (first stage) and the heads (last stage) draw their
            # masks from streams of their own, split off the host stream alike
            # on every stage: the heads' masks do not depend on which process
            # ran the embeddings.  The layers' streams split from what follows.
            embed_rngs, head_rngs = (
                dataclasses.replace(r, batch_start=dp.data_rank * local,
                                    batch_rows=dp.num_data * local) for r in rngs.split(2))
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((local,), seq_len, dtype=torch.int32, device=word_ids.device)
        weights = task.global_weights(batch, dp)
        task.model.train()
        inputs = {k: batch[k] for k in MODEL_INPUT_KEYS if k in batch}

        def embeddings():
            return task.model.encoder_inputs(**inputs, rngs=embed_rngs)[0]

        def loss(sequence):
            total, (_, metrics) = task.loss_from_outputs(
                batch, task.head_outputs(sequence, batch, head_rngs), weights)
            return total, metrics

        result = pipe.run(embeddings, loss, lengths, seq_len, rngs, dp.data_rank, dp.num_data)
        _pipe_gradients(transport, params)
        dp.gradients(params)
        state = state.apply_gradients()
        sums: Dict = {}
        if result is not None:
            _add_pairs(sums, result[1], head=dp.data_rank == 0)
            sums["total_loss"] = (result[0].detach(), torch.zeros((), device=task.device))
        sums = transport.broadcast_metrics(sums, task.device)
        sums = dp.metrics(sums, task.device)
        sums["total_loss"] = (sums["total_loss"][0], torch.ones((), device=task.device))
        return state, sums

    return step


def _add_pairs(sums: Dict, metrics: Mapping, head: bool = True) -> None:
    """Adds metric pairs into ``sums``; with ``head`` False the loss
    metrics' counts are left out (another rank counts that batch)."""
    for name, (total, count) in metrics.items():
        count = count.detach() if head or name not in LOSS_METRICS else count.detach() * 0
        prev = sums.get(name)
        pair = (total.detach(), count)
        sums[name] = pair if prev is None else (prev[0] + pair[0], prev[1] + pair[1])


def _rows(batch: Mapping, lo: int, hi: int) -> Dict:
    return {key: v[lo:hi] for key, v in batch.items()}


class PretrainingTask:
    """MLM + MPP (+ ITM) pretraining on ``device`` (default the card)."""

    def __init__(self, config: PretrainingTaskConfig, trainer: TrainerConfig,
                 device="cuda", seed: int = 0):
        self.config = config
        self.trainer = trainer
        self.device = resolve_device(device)
        data_cfg = config.train_data
        self.model = MmtPretrainingModel(
            config.model,
            mpp_output_num_classes=(2**data_cfg.output_channel_bits) ** 3,
            num_patch_per_row=data_cfg.num_patch_per_row,
            patch_dim=data_cfg.input_channels * data_cfg.patch_size**2,
            device=self.device, seed=seed,
        )

    def _has_itm(self, batch) -> bool:
        return "itm_label_weights" in batch and any(
            h.name == "itm" for h in self.config.model.cls_heads)

    def _loss_weights(self, batch):
        mlm_w = batch["mlm_label_weights"]
        mpp_w = batch["mpp_label_weights"]
        if self._has_itm(batch):  # mask MLM/MPP on ITM-negative examples
            itm_ids = batch["itm_label_ids"].float()[:, None]
            mlm_w = mlm_w * itm_ids
            mpp_w = mpp_w * itm_ids
        return mlm_w, mpp_w

    def loss_weight_sums(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """<float32>[3]: the MLM, MPP and ITM losses' weight sums over
        ``batch`` (their denominators)."""
        mlm_w, mpp_w = self._loss_weights(batch)
        itm = (torch.sum(batch["itm_label_weights"].float()) if self._has_itm(batch)
               else torch.zeros((), device=mlm_w.device))
        return torch.stack([torch.sum(mlm_w.float()), torch.sum(mpp_w.float()), itm])

    def compute_loss(self, batch: Mapping[str, torch.Tensor],
                     rngs: Optional[DropoutRngs] = None, deterministic: bool = False,
                     weight_sums: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
        """``weight_sums``: the losses' denominators (``loss_weight_sums`` of
        a larger batch, all-reduced), default this batch's own."""
        self.model.train(not deterministic)
        outputs = self.model(
            **{k: batch[k] for k in MODEL_INPUT_KEYS if k in batch},
            mlm_positions=batch.get("mlm_positions"),
            mpp_positions=batch.get("mpp_positions"),
            rngs=rngs,
        )
        return self.loss_from_outputs(batch, outputs, weight_sums)

    def head_outputs(self, sequence: torch.Tensor, batch: Mapping[str, torch.Tensor],
                     rngs: Optional[DropoutRngs] = None) -> Dict[str, torch.Tensor]:
        """The heads over a ready sequence output (the pipelined step's last
        stage)."""
        return self.model.head_outputs(sequence, batch.get("mlm_positions"),
                                       batch.get("mpp_positions"), rngs)

    def global_weights(self, batch: Mapping[str, torch.Tensor], dp: "DataParallel"):
        """The losses' denominators over the global batch (``weight_sums``)."""
        return dp.all_reduce(self.loss_weight_sums(batch))

    def loss_from_outputs(self, batch: Mapping[str, torch.Tensor], outputs: Dict,
                          weight_sums: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
        """``compute_loss`` from the model's outputs."""
        has_itm = self._has_itm(batch)
        mlm_w, mpp_w = self._loss_weights(batch)
        den = [None] * 3 if weight_sums is None else list(weight_sums)

        ce = losses_lib.weighted_sparse_categorical_crossentropy_loss
        mlm_loss = ce(outputs["mlm_logits"], batch["mlm_label_ids"], mlm_w, denominator=den[0])
        mpp_loss = ce(outputs["mpp_logits"], batch["mpp_label_ids"], mpp_w, denominator=den[1])
        total = mlm_loss + mpp_loss
        one = torch.ones((), device=total.device)
        metrics = {"mlm_loss": (mlm_loss, one), "mpp_loss": (mpp_loss, one)}
        if has_itm:
            itm_loss = ce(outputs["itm_logits"], batch["itm_label_ids"],
                          batch["itm_label_weights"], denominator=den[2])
            total = total + itm_loss
            metrics["itm_loss"] = (itm_loss, one)
        metrics["mlm_accuracy"] = weighted_accuracy(
            batch["mlm_label_ids"], outputs["mlm_logits"], mlm_w)
        metrics["mpp_accuracy"] = weighted_accuracy(
            batch["mpp_label_ids"], outputs["mpp_logits"], mpp_w)
        if "itm_label_weights" in batch and "itm_logits" in outputs:
            metrics["itm_accuracy"] = weighted_accuracy(
                batch["itm_label_ids"], outputs["itm_logits"], batch["itm_label_weights"])
        return total, (outputs, metrics)

    def make_train_step(self, micro_batch_size: int = 0, grad_accum_dtype: str = "float32",
                        mesh=None):
        """Returns (state, batch, rngs) -> (state, metric pairs); ``batch``
        holds tensors on the task's device: the global batch, or with
        ``mesh`` this rank's slice of it (module docstring)."""
        if grad_accum_dtype not in _ACCUM_DTYPES:
            raise NotImplementedError(
                f"grad_accum_dtype={grad_accum_dtype!r}: the port accumulates in "
                f"{' or '.join(_ACCUM_DTYPES)}")
        # As in JAX, the accumulator's dtype applies only with micro-batches.
        acc_dtype = _ACCUM_DTYPES[grad_accum_dtype] if micro_batch_size else torch.float32
        params = [p for p in self.model.parameters() if p.requires_grad]
        dp = DataParallel(mesh)

        def step(state: TrainState, batch, rngs: Optional[DropoutRngs] = None):
            local = batch["word_ids"].shape[0]
            bsz = local * dp.num_data
            k = max(1, bsz // micro_batch_size) if micro_batch_size else 1
            if bsz % k:
                raise ValueError(f"batch {bsz} does not split into {k} micro-batches")
            segments = list(micro_segments(local, dp.data_rank, dp.num_data, k))
            weight_sums = torch.zeros(k, 3, device=self.device)
            for m, lo, hi, _ in segments:
                weight_sums[m] = self.loss_weight_sums(_rows(batch, lo, hi))
            dp.all_reduce(weight_sums)
            streams = rngs.split(k) if rngs is not None else [None] * k
            sums: Dict = {}
            loss_sum = torch.zeros((), device=self.device)
            acc = None
            for m, lo, hi, offset in segments:
                r = streams[m]
                if r is not None:
                    r = dataclasses.replace(r, batch_start=offset, batch_rows=bsz // k)
                loss, (_, metrics) = self.compute_loss(_rows(batch, lo, hi), r,
                                                       deterministic=False,
                                                       weight_sums=weight_sums[m])
                (loss / k).backward()
                if acc_dtype != torch.float32:
                    acc = _accumulate(params, acc, acc_dtype)
                loss_sum = loss_sum + loss.detach() / k
                _add_pairs(sums, metrics, head=offset == 0)
            if acc is not None:
                for p, a in zip(params, acc):
                    p.grad = a.to(p.dtype)
            dp.gradients(params)
            state = state.apply_gradients()
            sums["total_loss"] = (loss_sum, torch.zeros((), device=self.device))
            sums = dp.metrics(sums, self.device)
            sums["total_loss"] = (sums["total_loss"][0], torch.ones((), device=self.device))
            return state, sums

        return step

    def make_pipelined_train_step(self, mesh, num_micro: int, remat: bool = True,
                                  zero1: bool = False, transport=None):
        """Returns (state, batch, rngs) -> (state, metric pairs) with the
        encoder's layer stack GPipe-pipelined over ``mesh``'s pipe axis in
        ``num_micro`` micro-batches (module docstring)."""
        return _make_pipelined_step(self, mesh, num_micro, remat, zero1, transport)

    def make_eval_step(self, mesh=None):
        """Returns batch -> metric pairs, in eval mode, no grad; with
        ``mesh`` over the global batch whose slice this rank holds."""
        dp = DataParallel(mesh)

        def step(batch):
            with torch.no_grad():
                weight_sums = None
                if dp.data_group is not None:
                    weight_sums = dp.all_reduce(self.loss_weight_sums(batch))
                loss, (_, metrics) = self.compute_loss(batch, None, deterministic=True,
                                                       weight_sums=weight_sums)
            sums: Dict = {}
            _add_pairs(sums, metrics, head=dp.data_rank == 0)
            sums["total_loss"] = (loss.detach(), torch.zeros((), device=loss.device))
            sums = dp.metrics(sums, loss.device)
            sums["total_loss"] = (sums["total_loss"][0], torch.ones((), device=loss.device))
            return sums

        return step


class ClassificationTask:
    """ITM classification finetune / retrieval scoring on ``device``
    (default the card)."""

    def __init__(self, config: ClassificationTaskConfig, trainer: TrainerConfig,
                 device="cuda", seed: int = 0):
        self.config = config
        self.trainer = trainer
        self.device = resolve_device(device)
        data_cfg = config.train_data
        heads = config.model.cls_heads
        if not heads:
            raise ValueError("the classification task scores its first head: "
                             "model.cls_heads is empty")
        self.model = MmtClassificationModel(
            config.model, num_patch_per_row=data_cfg.num_patch_per_row,
            patch_dim=data_cfg.input_channels * data_cfg.patch_size**2,
            device=self.device, seed=seed,
        )
        self.logits_key = f"{heads[0].name}_logits"
        self.num_classes = heads[0].num_classes

    def compute_loss(self, batch: Mapping[str, torch.Tensor],
                     rngs: Optional[DropoutRngs] = None, deterministic: bool = False,
                     weight_sum: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
        """``weight_sum``: the loss's denominator (the label weights' sum
        over a larger batch), default this batch's own."""
        self.model.train(not deterministic)
        outputs = self.model(**{k: batch[k] for k in MODEL_INPUT_KEYS if k in batch},
                             rngs=rngs)
        return self.loss_from_outputs(batch, outputs, weight_sum)

    def head_outputs(self, sequence: torch.Tensor, batch: Mapping[str, torch.Tensor],
                     rngs: Optional[DropoutRngs] = None) -> Dict[str, torch.Tensor]:
        """The heads over a ready sequence output (the pipelined step's last
        stage)."""
        return self.model.head_outputs(sequence, rngs)

    def global_weights(self, batch: Mapping[str, torch.Tensor], dp: "DataParallel"):
        """The loss's denominator over the global batch (``weight_sum``)."""
        return dp.all_reduce(torch.sum(batch["label_weights"].float()))

    def loss_from_outputs(self, batch: Mapping[str, torch.Tensor], outputs: Dict,
                          weight_sum: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
        """``compute_loss`` from the model's outputs."""
        logits = outputs[self.logits_key]
        labels = batch["label_ids"]
        weights = batch["label_weights"]
        pos_weights = batch.get("pos_weights")
        if self.num_classes == 1:
            loss = losses_lib.weighted_binary_crossentropy_loss(
                logits, labels, weights, pos_weights, denominator=weight_sum)
            correct = ((logits.reshape(-1) > 0).to(labels.dtype) == labels).float()
        else:
            loss = losses_lib.weighted_sparse_categorical_crossentropy_loss(
                logits, labels, weights, pos_weights, denominator=weight_sum)
            correct = (torch.argmax(logits, -1) == labels).float()
        weights = weights.float()
        metrics = {
            "cls_loss": (loss, torch.ones((), device=loss.device)),
            "cls_accuracy": (torch.sum(correct * weights), torch.sum(weights)),
        }
        return loss, (outputs, metrics)

    def make_train_step(self, mesh=None):
        """Returns (state, batch, rngs) -> (state, metric pairs): the whole
        batch in one forward and backward, then one optimizer update; with
        ``mesh`` the batch is this rank's slice of the global batch, whose
        loss is the global weighted mean."""
        dp = DataParallel(mesh)
        params = [p for p in self.model.parameters() if p.requires_grad]

        def step(state: TrainState, batch, rngs: Optional[DropoutRngs] = None):
            local = batch["label_ids"].shape[0]
            if rngs is not None:
                rngs = dataclasses.replace(rngs, batch_start=dp.data_rank * local,
                                           batch_rows=dp.num_data * local)
            loss, (_, metrics) = self.compute_loss(batch, rngs, deterministic=False,
                                                   weight_sum=self.global_weights(batch, dp))
            loss.backward()
            dp.gradients(params)
            state = state.apply_gradients()
            sums: Dict = {}
            _add_pairs(sums, metrics, head=dp.data_rank == 0)
            sums["total_loss"] = (loss.detach(), torch.zeros((), device=self.device))
            sums = dp.metrics(sums, self.device)
            sums["total_loss"] = (sums["total_loss"][0], torch.ones((), device=self.device))
            return state, sums

        return step

    def make_pipelined_train_step(self, mesh, num_micro: int, remat: bool = True,
                                  zero1: bool = False, transport=None):
        """Returns (state, batch, rngs) -> (state, metric pairs) with the
        encoder's layer stack GPipe-pipelined over ``mesh``'s pipe axis in
        ``num_micro`` micro-batches (module docstring)."""
        return _make_pipelined_step(self, mesh, num_micro, remat, zero1, transport)

    def make_eval_step(self, mesh=None):
        """Returns batch -> (metric pairs, probabilities), in eval mode, no
        grad; the probabilities are the inference step's scores (this
        rank's rows with ``mesh``; the pairs are the global batch's)."""
        dp = DataParallel(mesh)

        def step(batch):
            with torch.no_grad():
                loss, (outputs, metrics) = self.compute_loss(
                    batch, None, deterministic=True, weight_sum=self.global_weights(batch, dp))
            sums: Dict = {}
            _add_pairs(sums, metrics, head=dp.data_rank == 0)
            sums["total_loss"] = (loss, torch.zeros((), device=loss.device))
            sums = dp.metrics(sums, loss.device)
            sums["total_loss"] = (sums["total_loss"][0], torch.ones((), device=loss.device))
            return sums, scores_from_logits(outputs[self.logits_key], self.num_classes)

        return step

    def make_inference_step(self):
        """Returns batch of arrays -> <float32>[B] scores on the task's
        device, with the reference's logit conversion."""
        return make_inference_step(self.model, self.device)
