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
* **Platforms**: ``platforms`` (JAX's cross-platform lowering) names the
  port's device types, ``"cpu"`` and ``"cuda"``; default the task's
  device.  A program is traced on each platform's device in the exporting
  process (the fused forward is the registered op, whose CPU kernel is the
  plain version), so ``("cpu", "cuda")`` needs a process with a card; a
  platform without a device there raises, and never leaves a one-platform
  artifact.  One platform: the artifact is that program in
  ``torch.export``'s own format, as every artifact was before platforms
  were taken, so artifacts written earlier and now read alike; several: a
  zip of ``program_<platform>.pt2`` and ``scoring_platforms.json``.  A call
  runs the program of the one device all its tensors are on (all numpy:
  the first platform); tensors on two devices, or a device the artifact
  lacks, raise.
* **Bundles**: a zip of static-batch artifacts, one per bucket size
  (``bucket_<b>.bin``, each with the bundle's platforms), and
  ``manifest.json`` with the format ``mmt_tpu_torch.scoring_bundle.v1``
  (the artifacts are not JAX's, so a JAX bundle is refused).
  ``BundledScorer`` pads a request with zero rows to the smallest covering
  bucket, splits an oversized one into max-bucket chunks and slices the
  scores back (``mmt_tpu/eval/export.py:166-205``).
"""

from __future__ import annotations

import copy
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
# A several-platform artifact's index, beside its programs.
_PLATFORMS_FILE = "scoring_platforms.json"
PLATFORMS = ("cpu", "cuda")  # the device types an artifact may be traced for


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


def _platform_devices(platforms, device: torch.device) -> list:
    """The device to trace each of ``platforms`` on (default: ``device``'s
    type alone): ``device`` for its own type, else the type's current
    device; raises for a name the port does not take and for a type this
    process has no device of."""
    names = [device.type] if platforms is None else [str(p) for p in platforms]
    if not names or len(set(names)) != len(names):
        raise ValueError(f"platforms={names!r}: name each platform once")
    unknown = [p for p in names if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown!r}: the port's artifacts run on "
                         f"{' and '.join(PLATFORMS)} (torch device types)")
    if "cuda" in names and device.type != "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"platforms={names!r}: this process has no CUDA device to trace "
                           "the cuda program on; export from a process with a card")
    return [device if p == device.type else torch.device(p) for p in names]


def _export_program(task, params: Mapping, example_batch: Mapping, device: torch.device,
                    symbolic_batch: bool) -> bytes:
    """One platform's artifact: the program traced on ``device``."""
    params = _tensors(params, device)
    inputs = _tensors(scoring_inputs(example_batch), device)
    dynamic = None
    if symbolic_batch:
        if next(iter(inputs.values())).shape[0] < 2:
            inputs = {k: torch.cat([v, v]) for k, v in inputs.items()}
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({k: None for k in params}, {k: {0: batch} for k in inputs})
    # The model itself on the platform's device: its parameters are the
    # call's, but the trace meets any other tensor it holds there.
    model = task.model if device == task.device else copy.deepcopy(task.model).to(device)
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
      platforms: the device types to trace for, e.g. ``("cpu", "cuda")``;
        default the task's device (see the module docstring).
      symbolic_batch: trace the batch dimension as symbolic (one artifact,
        any batch size >= 1); False fixes it to the example's.

    Returns:
      ``bytes``: pass to ``load_scoring`` (or write to disk).
    """
    devices = _platform_devices(platforms, task.device)
    programs = [_export_program(task, params, example_batch, d, symbolic_batch)
                for d in devices]
    if len(programs) == 1:
        return programs[0]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for d, program in zip(devices, programs):
            zf.writestr(f"program_{d.type}.pt2", program)
        zf.writestr(_PLATFORMS_FILE, json.dumps({"platforms": [d.type for d in devices]}))
    return buf.getvalue()


class ScoringArtifact:
    """A loaded artifact: ``call(params, inputs)`` -> <float32>[B] scores on
    the device of the call's tensors (all numpy: the first platform), by
    that platform's program.  Tensors on two devices raise, as does a
    device the artifact has no program for: nothing is moved to another
    device for the call.  ``params`` is a state dict,
    ``inputs`` a batch (numpy arrays or tensors; keys beyond the model
    inputs are ignored)."""

    def __init__(self, programs: Mapping[str, object], signature: dict):
        self._modules = {p: program.module() for p, program in programs.items()}
        self.platforms = list(programs)
        self._params, self._inputs = signature["params"], signature["inputs"]
        self.batch_size = signature["batch"]

    def call_device(self, params: Mapping, inputs: Mapping) -> torch.device:
        """The device a call with these arguments runs on (class docstring)."""
        devices = sorted({v.device for tree in (inputs, params) for v in tree.values()
                          if isinstance(v, torch.Tensor)}, key=str)
        if len(devices) > 1:
            raise ValueError(f"a call with tensors on {' and '.join(map(str, devices))}: put "
                             "the inputs and the parameters on one device")
        device = devices[0] if devices else torch.device(self.platforms[0])
        if device.type not in self._modules:
            raise ValueError(f"a call on {device} but the artifact holds programs for "
                             f"{self.platforms} only")
        return device

    def call(self, params: Mapping, inputs: Mapping) -> torch.Tensor:
        device = self.call_device(params, inputs)
        params = _tensors({k: params[k] for k in self._params}, device)
        inputs = _tensors({k: inputs[k] for k in self._inputs}, device)
        with torch.inference_mode():
            return self._modules[device.type](params, inputs)


def _load_program(blob: bytes):
    extra = {_SIGNATURE_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return program, json.loads(extra[_SIGNATURE_FILE])


def load_scoring(blob: bytes) -> ScoringArtifact:
    """Deserializes an artifact of one platform or several (see
    ``ScoringArtifact``)."""
    if not zipfile.is_zipfile(io.BytesIO(blob)):
        raise ValueError("not a torch.export scoring artifact (a JAX package artifact is "
                         "StableHLO, which the port does not load)")
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        blobs = [blob] if _PLATFORMS_FILE not in zf.namelist() else [
            zf.read(f"program_{p}.pt2") for p in json.loads(zf.read(_PLATFORMS_FILE))["platforms"]]
    loaded = [_load_program(b) for b in blobs]
    return ScoringArtifact({sig["device"]: program for program, sig in loaded}, loaded[0][1])


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
        inputs = scoring_inputs(inputs)
        device = next(iter(self._buckets.values())).call_device(params, inputs)
        inputs = _tensors(inputs, device)
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
