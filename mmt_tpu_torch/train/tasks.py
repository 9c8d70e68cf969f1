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
  ``.grad`` (the JAX ``lax.scan`` accumulation), and the micro-batches'
  metric pairs are summed;
* ``make_eval_step``: the loss and metrics in ``eval()`` mode, no grad.

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

from typing import Dict, Mapping, Optional, Tuple

import torch

from mmt_tpu_torch.configs.experiments import (
    ClassificationTaskConfig,
    PretrainingTaskConfig,
    TrainerConfig,
)
from mmt_tpu_torch.device import resolve_device
from mmt_tpu_torch.eval.predict import make_inference_step, scores_from_logits
from mmt_tpu_torch.models import DropoutRngs, MmtClassificationModel, MmtPretrainingModel
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


def batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


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

    def compute_loss(self, batch: Mapping[str, torch.Tensor],
                     rngs: Optional[DropoutRngs] = None, deterministic: bool = False,
                     ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
        self.model.train(not deterministic)
        outputs = self.model(
            **{k: batch[k] for k in MODEL_INPUT_KEYS if k in batch},
            mlm_positions=batch.get("mlm_positions"),
            mpp_positions=batch.get("mpp_positions"),
            rngs=rngs,
        )
        has_itm = "itm_label_weights" in batch and any(
            h.name == "itm" for h in self.config.model.cls_heads)
        mlm_w = batch["mlm_label_weights"]
        mpp_w = batch["mpp_label_weights"]
        if has_itm:  # mask MLM/MPP on ITM-negative examples
            itm_ids = batch["itm_label_ids"].float()[:, None]
            mlm_w = mlm_w * itm_ids
            mpp_w = mpp_w * itm_ids

        ce = losses_lib.weighted_sparse_categorical_crossentropy_loss
        mlm_loss = ce(outputs["mlm_logits"], batch["mlm_label_ids"], mlm_w)
        mpp_loss = ce(outputs["mpp_logits"], batch["mpp_label_ids"], mpp_w)
        total = mlm_loss + mpp_loss
        one = torch.ones((), device=total.device)
        metrics = {"mlm_loss": (mlm_loss, one), "mpp_loss": (mpp_loss, one)}
        if has_itm:
            itm_loss = ce(outputs["itm_logits"], batch["itm_label_ids"],
                          batch["itm_label_weights"])
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

    def make_train_step(self, micro_batch_size: int = 0, grad_accum_dtype: str = "float32"):
        """Returns (state, batch, rngs) -> (state, metric pairs); ``batch``
        holds tensors on the task's device."""
        if grad_accum_dtype != "float32":
            raise NotImplementedError(
                f"grad_accum_dtype={grad_accum_dtype!r}: the port accumulates in float32 only")

        def step(state: TrainState, batch, rngs: Optional[DropoutRngs] = None):
            bsz = batch["word_ids"].shape[0]
            k = max(1, bsz // micro_batch_size) if micro_batch_size else 1
            if bsz % k:
                raise ValueError(f"batch {bsz} does not split into {k} micro-batches")
            m = bsz // k
            sums: Dict = {}
            loss_sum = torch.zeros((), device=self.device)
            for i in range(k):
                micro = {key: v[i * m:(i + 1) * m] for key, v in batch.items()}
                loss, (_, metrics) = self.compute_loss(micro, rngs, deterministic=False)
                (loss / k).backward()
                loss_sum = loss_sum + loss.detach() / k
                for name, (total, count) in metrics.items():
                    prev = sums.get(name)
                    pair = (total.detach(), count.detach())
                    sums[name] = pair if prev is None else (prev[0] + pair[0], prev[1] + pair[1])
            state = state.apply_gradients()
            sums["total_loss"] = (loss_sum, torch.ones((), device=self.device))
            return state, sums

        return step

    def make_eval_step(self):
        """Returns (model, batch) -> metric pairs, in eval mode, no grad."""

        def step(batch):
            with torch.no_grad():
                loss, (_, metrics) = self.compute_loss(batch, None, deterministic=True)
            metrics = dict(metrics)
            metrics["total_loss"] = (loss, torch.ones((), device=loss.device))
            return metrics

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
                     ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
        self.model.train(not deterministic)
        outputs = self.model(**{k: batch[k] for k in MODEL_INPUT_KEYS if k in batch},
                             rngs=rngs)
        logits = outputs[self.logits_key]
        labels = batch["label_ids"]
        weights = batch["label_weights"]
        pos_weights = batch.get("pos_weights")
        if self.num_classes == 1:
            loss = losses_lib.weighted_binary_crossentropy_loss(
                logits, labels, weights, pos_weights)
            correct = ((logits.reshape(-1) > 0).to(labels.dtype) == labels).float()
        else:
            loss = losses_lib.weighted_sparse_categorical_crossentropy_loss(
                logits, labels, weights, pos_weights)
            correct = (torch.argmax(logits, -1) == labels).float()
        weights = weights.float()
        metrics = {
            "cls_loss": (loss, torch.ones((), device=loss.device)),
            "cls_accuracy": (torch.sum(correct * weights), torch.sum(weights)),
        }
        return loss, (outputs, metrics)

    def make_train_step(self):
        """Returns (state, batch, rngs) -> (state, metric pairs): the whole
        batch in one forward and backward, then one optimizer update."""

        def step(state: TrainState, batch, rngs: Optional[DropoutRngs] = None):
            loss, (_, metrics) = self.compute_loss(batch, rngs, deterministic=False)
            loss.backward()
            state = state.apply_gradients()
            metrics = {name: (total.detach(), count.detach())
                       for name, (total, count) in metrics.items()}
            metrics["total_loss"] = (loss.detach(), torch.ones((), device=self.device))
            return state, metrics

        return step

    def make_eval_step(self):
        """Returns batch -> (metric pairs, probabilities), in eval mode, no
        grad; the probabilities are the inference step's scores."""

        def step(batch):
            with torch.no_grad():
                loss, (outputs, metrics) = self.compute_loss(batch, None, deterministic=True)
            metrics = dict(metrics)
            metrics["total_loss"] = (loss, torch.ones((), device=loss.device))
            return metrics, scores_from_logits(outputs[self.logits_key], self.num_classes)

        return step

    def make_inference_step(self):
        """Returns batch of arrays -> <float32>[B] scores on the task's
        device, with the reference's logit conversion."""
        return make_inference_step(self.model, self.device)
