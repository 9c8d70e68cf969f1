"""Batched retrieval prediction -> results.csv + recall.json.

Counterpart of ``mmt_tpu/eval/predict.py`` without pandas:
``make_inference_step`` turns a classification model into a function from
a batch of arrays to scores, with the reference's logit conversion
(sigmoid for one class, softmax[:, 1] for two, argmax otherwise);
``predict`` runs it over every batch and yields a RawResult row for every
valid example; ``write_results``
clips the scores to [0, 1] and writes ``results.csv`` byte for byte as
pandas' ``to_csv(index=False, float_format="%.8f")`` would, and
``recall.json`` with ``indent=4``.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
from typing import Callable, Iterable, Iterator, Mapping, Union

import numpy as np
import torch

from mmt_tpu_torch.device import resolve_device
from mmt_tpu_torch.eval.recall import get_recall_at_k

logger = logging.getLogger("mmt_tpu_torch")

RawResult = collections.namedtuple(
    "RawResult", ["image_index", "text_index", "gt_image_index", "output"]
)

MODEL_INPUT_KEYS = ("word_ids", "segment_ids", "patch_embeddings", "lengths", "images")


def scores_from_logits(logits: torch.Tensor, num_classes: int) -> torch.Tensor:
    logits = logits.float()
    if num_classes == 1:
        return torch.sigmoid(logits.reshape(-1))
    if num_classes == 2:
        return torch.softmax(logits, dim=-1)[:, 1]
    return torch.argmax(logits, dim=-1).float()


def make_inference_step(model, device="cuda") -> Callable[[Mapping], torch.Tensor]:
    """batch of arrays -> <float32>[B] scores on ``device``, from the first
    head's logits of ``model`` (an ``MmtClassificationModel`` on ``device``)."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, expected {dev.type}")
    head = model.config.cls_heads[0]
    logits_key = f"{head.name}_logits"

    def step(batch: Mapping) -> torch.Tensor:
        with torch.inference_mode():
            inputs = {k: torch.as_tensor(np.asarray(batch[k])).to(dev)
                      for k in MODEL_INPUT_KEYS if k in batch}
            return scores_from_logits(model(**inputs)[logits_key], head.num_classes)

    return step


def sharded_inference_step(step: Callable[[Mapping], torch.Tensor], mesh
                           ) -> Callable[[Mapping], torch.Tensor]:
    """An inference step over a data-parallel ``mesh``: each rank scores
    its rows of the batch (``parallel.mesh.data_slice``) with ``step`` and
    the scores of every rank are gathered, in the batch's order."""
    from mmt_tpu_torch.parallel.mesh import all_gather_rows, data_slice

    def sharded(batch: Mapping) -> torch.Tensor:
        scores = step(data_slice(mesh, {k: np.asarray(v) for k, v in batch.items()}))
        return torch.from_numpy(all_gather_rows(mesh, scores.cpu().numpy()).reshape(-1))

    return sharded


def predict(model: Union[torch.nn.Module, Callable], batches: Iterable[Mapping],
            device="cuda") -> Iterator[RawResult]:
    """Yields RawResult rows for every valid example in every batch.

    ``batches`` are dicts of arrays holding the model inputs plus
    ``image_index``, ``text_index``, ``gt_image_index`` and optionally
    ``valid``.  ``model`` is an ``MmtClassificationModel`` on ``device``, or
    the inference step made from one (``device`` is then the step's own).
    """
    infer = make_inference_step(model, device) if isinstance(model, torch.nn.Module) else model
    count = 0
    for step, batch in enumerate(batches, start=1):
        scores = infer(batch).cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(len(scores), np.int32)))
        img = np.asarray(batch["image_index"])
        txt = np.asarray(batch["text_index"])
        gt = np.asarray(batch["gt_image_index"])
        for i in range(len(scores)):
            if not valid[i]:
                continue
            count += 1
            yield RawResult(
                image_index=int(img[i]),
                text_index=int(txt[i]),
                gt_image_index=int(gt[i]),
                output=float(scores[i]),
            )
        if step % 5 == 0:
            logger.info("Made predictions for %d examples.", count)
    logger.info("Finished predictions for %d examples.", count)


def _clip_unit(x: float) -> float:
    """pandas ``Series.clip(lower=0.0, upper=1.0)`` on one value (NaN stays)."""
    if math.isnan(x):
        return x
    if x < 0.0:
        return 0.0
    if x > 1.0:
        return 1.0
    return x


def _csv_float(x: float) -> str:
    """pandas' ``float_format="%.8f"`` with the empty ``na_rep``."""
    return "" if math.isnan(x) else "%.8f" % x


def write_results(results: Iterable[RawResult], output_dir: str) -> dict:
    """Writes results.csv and recall.json; returns the recall dict."""
    rows = [r._replace(output=_clip_unit(float(r.output))) for r in results]
    if not rows:
        raise ValueError("no results to write")
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "results.csv"), "w", newline="") as f:
        f.write(",".join(RawResult._fields) + "\n")
        for r in rows:
            f.write(f"{r.image_index},{r.text_index},{r.gt_image_index},"
                    f"{_csv_float(r.output)}\n")

    recall_dict = get_recall_at_k(
        np.array([r.image_index for r in rows]),
        np.array([r.text_index for r in rows]),
        np.array([r.gt_image_index for r in rows]),
        np.array([r.output for r in rows], float),
    )
    with open(os.path.join(output_dir, "recall.json"), "w") as f:
        json.dump(recall_dict, f, indent=4)
    logger.info("Results: %s", recall_dict)
    return recall_dict
