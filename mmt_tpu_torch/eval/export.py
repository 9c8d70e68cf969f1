"""Serving-artifact export: the scoring computation as a ``torch.export`` program.

Counterpart of ``mmt_tpu/eval/export.py``: the inference step of a
classification task (the model, then sigmoid / softmax[:, 1] / argmax of
the first head's logits) is traced by ``torch.export`` into a
self-contained artifact that a serving process loads with
``load_scoring`` and calls without the model code or the config system.
Loading needs ``torch.export.load`` and the registration of the forward
kernel's op (``mmt_tpu_torch::rel_attention_fwd``), which importing this
module does.

* **Parameters are call arguments, not constants**: the traced function
  takes ``(params, inputs)`` (``torch.func.functional_call`` over the
  model's state dict), so one artifact serves every checkpoint of the same
  geometry and stays small.  The example inputs ``torch.export`` would
  keep are dropped before saving.
* **Symbolic batch**: with ``symbolic_batch`` the batch dimension is a
  ``torch.export.Dim`` (batch >= 1; an example batch of one row is tiled
  to two for the trace, since a size-1 example would be specialised);
  otherwise the artifact takes the example's batch size alone.
* **One device**: the artifact is traced for the device of the task's
  model; ``platforms`` (JAX's cross-platform lowering) has no
  counterpart and any value but that device raises.
* **Bundles**: a zip of static-batch artifacts, one per bucket size
  (``bucket_<b>.bin``), and ``manifest.json`` with the format
  ``mmt_tpu_torch.scoring_bundle.v1`` (the artifacts are not JAX's, so a
  JAX bundle is refused).  ``BundledScorer`` pads a request with zero rows
  to the smallest covering bucket, splits an oversized one into max-bucket
  chunks and slices the scores back (``mmt_tpu/eval/export.py:166-205``).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

# Imported for the registration of the forward kernel's op, which a loaded
# artifact calls.
import mmt_tpu_torch.ops.fused_attention  # noqa: F401
from mmt_tpu_torch.eval.predict import MODEL_INPUT_KEYS, scores_from_logits

__all__ = [
    "export_scoring", "load_scoring", "scoring_inputs",
    "export_scoring_bundle", "load_scoring_bundle", "BundledScorer", "ScoringArtifact",
]

BUNDLE_FORMAT = "mmt_tpu_torch.scoring_bundle.v1"
BUNDLE_MANIFEST = "manifest.json"
# The artifact's calling convention, saved beside the program.
_SIGNATURE_FILE = "scoring_signature.json"


def scoring_inputs(batch: Mapping) -> dict:
    """The model-input subset of a loader batch (drops labels / indices)."""
    return {k: batch[k] for k in MODEL_INPUT_KEYS if k in batch}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _tensors(tree: Mapping, device) -> dict:
    return {k: _as_tensor(v).detach().to(device) for k, v in tree.items()}


class _Scoring(nn.Module):
    """``(params, inputs) -> scores`` of a classification task's model; the
    model is held outside the module tree, so that its parameters are the
    call's arguments and nothing of it is saved."""

    def __init__(self, model: nn.Module, logits_key: str, num_classes: int):
        super().__init__()
        self._model = (model,)
        self.logits_key, self.num_classes = logits_key, num_classes

    def forward(self, params, inputs):
        out = torch.func.functional_call(self._model[0], params, args=(), kwargs=inputs)
        return scores_from_logits(out[self.logits_key], self.num_classes)


def _check_platforms(platforms, device: torch.device) -> None:
    if platforms is not None and list(platforms) != [device.type]:
        raise NotImplementedError(
            f"platforms={list(platforms)!r}: a torch.export artifact is traced for the device "
            f"of its example tensors ({device.type!r}) and runs there only; export it from a "
            "process on the target device")


def export_scoring(task, params: Mapping, example_batch: Mapping,
                   platforms: Optional[Sequence[str]] = None,
                   symbolic_batch: bool = True) -> bytes:
    """Serializes ``task``'s inference step to an artifact.

    Args:
      task: a ``ClassificationTask`` (the retrieval / ITM scoring model).
      params: the model's state dict (name -> tensor); shapes and dtypes
        define the artifact's weight signature, the values are not kept.
      example_batch: one loader batch; its non-batch dims fix the
        artifact's static shapes (sequence length, patch grid).
      platforms: None, or the task's device type alone (see the module
        docstring).
      symbolic_batch: trace the batch dimension as symbolic (one artifact,
        any batch size >= 1); False fixes it to the example's.

    Returns:
      ``bytes``: pass to ``load_scoring`` (or write to disk).
    """
    device = task.device
    _check_platforms(platforms, device)
    params = _tensors(params, device)
    inputs = _tensors(scoring_inputs(example_batch), device)
    dynamic = None
    if symbolic_batch:
        if next(iter(inputs.values())).shape[0] < 2:
            inputs = {k: torch.cat([v, v]) for k, v in inputs.items()}
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({k: None for k in params}, {k: {0: batch} for k in inputs})
    model = task.model
    training = model.training
    model.eval()
    try:
        program = torch.export.export(
            _Scoring(model, task.logits_key, task.num_classes), (params, inputs),
            dynamic_shapes=dynamic)
    finally:
        model.train(training)
    program.example_inputs = None
    signature = {"params": list(params), "inputs": list(inputs), "device": device.type,
                 "batch": None if symbolic_batch else next(iter(inputs.values())).shape[0]}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_SIGNATURE_FILE: json.dumps(signature)})
    return buf.getvalue()


class ScoringArtifact:
    """A loaded artifact: ``call(params, inputs)`` -> <float32>[B] scores on
    the artifact's device.  ``params`` is a state dict, ``inputs`` a batch
    (numpy arrays or tensors; keys beyond the model inputs are ignored)."""

    def __init__(self, program, signature: dict):
        self._module = program.module()
        self._params, self._inputs = signature["params"], signature["inputs"]
        self.device = torch.device(signature["device"])
        self.batch_size = signature["batch"]

    def call(self, params: Mapping, inputs: Mapping) -> torch.Tensor:
        params = _tensors({k: params[k] for k in self._params}, self.device)
        inputs = _tensors({k: inputs[k] for k in self._inputs}, self.device)
        with torch.inference_mode():
            return self._module(params, inputs)


def load_scoring(blob: bytes) -> ScoringArtifact:
    """Deserializes an artifact (see ``ScoringArtifact``)."""
    extra = {_SIGNATURE_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return ScoringArtifact(program, json.loads(extra[_SIGNATURE_FILE]))


# ----------------------------------------------------- bucketed bundles


def export_scoring_bundle(task, params: Mapping, example_batch: Mapping,
                          batch_sizes: Sequence[int] = (1, 8, 32),
                          platforms: Optional[Sequence[str]] = None) -> bytes:
    """One zip holding a static-batch artifact per bucket size."""
    sizes = sorted(set(int(b) for b in batch_sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"invalid batch_sizes {batch_sizes}")
    inputs = scoring_inputs(example_batch)

    def resized(b):
        def fit(x):
            x = np.asarray(x)
            reps = -(-b // x.shape[0])
            return np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:b]
        return {k: fit(v) for k, v in inputs.items()}

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for b in sizes:
            zf.writestr(f"bucket_{b}.bin", export_scoring(
                task, params, resized(b), platforms=platforms, symbolic_batch=False))
        zf.writestr(BUNDLE_MANIFEST, json.dumps({"format": BUNDLE_FORMAT,
                                                 "batch_sizes": sizes}))
    return buf.getvalue()


class BundledScorer:
    """Callable over a bucket bundle: pads to the next bucket with zero
    rows, splits oversize requests into max-bucket chunks, slices the
    scores back; returns <float32>[B] numpy scores."""

    def __init__(self, buckets: Mapping[int, ScoringArtifact]):
        self._buckets = dict(sorted(buckets.items()))
        self.batch_sizes = list(self._buckets)

    @staticmethod
    def _pad(chunk: dict, b: int) -> dict:
        def pad(x):
            if x.shape[0] == b:
                return x
            return torch.cat([x, x.new_zeros((b - x.shape[0],) + tuple(x.shape[1:]))])
        return {k: pad(v) for k, v in chunk.items()}

    def call(self, params: Mapping, inputs: Mapping) -> np.ndarray:
        inputs = {k: _as_tensor(v) for k, v in scoring_inputs(inputs).items()}
        n = int(next(iter(inputs.values())).shape[0])
        sizes, out, start = self.batch_sizes, [], 0
        while start < n:
            rest = n - start
            b = next((s for s in sizes if s >= rest), sizes[-1])
            take = min(rest, b)
            chunk = self._pad({k: v[start:start + take] for k, v in inputs.items()}, b)
            out.append(self._buckets[b].call(params, chunk)[:take].float().cpu().numpy())
            start += take
        return np.concatenate(out) if out else np.zeros((0,), np.float32)


def load_scoring_bundle(blob: bytes) -> BundledScorer:
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        if BUNDLE_MANIFEST not in zf.namelist():
            raise ValueError(f"not a scoring bundle: no {BUNDLE_MANIFEST}")
        manifest = json.loads(zf.read(BUNDLE_MANIFEST))
        if manifest.get("format") != BUNDLE_FORMAT:
            raise ValueError(f"not a {BUNDLE_FORMAT} bundle: {manifest}")
        buckets = {b: load_scoring(zf.read(f"bucket_{b}.bin"))
                   for b in manifest["batch_sizes"]}
    return BundledScorer(buckets)
