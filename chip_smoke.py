#!/usr/bin/env python3
"""Drives the PyTorch port (``mmt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit (the raw ``nvidia-smi`` line
   is printed on its own line too).
2. build: every CUDA source under ``mmt_tpu_torch/csrc`` is compiled with
   nvcc for sm_90a, one process per source, all started together.
3. kernel: the relative-attention kernel against its plain PyTorch
   version at the flagship attention shape (S=4096, H=12, D=64, V=49,
   P=14, r=1, text distance 12, bf16): max abs error on real rows at
   lengths [4096, 3001, 1000, 257], then at the main path's batch (32,
   lengths ~ U[2048, 4096]) the kernel's time, the plain version's, the
   time of ``scaled_dot_product_attention`` handed the materialised bias
   (a yardstick the port never calls) and the bound.
4. main: the full-width retrieval model (BERT-base geometry, L12/H768/A12,
   I3072, vocab 30522, fused attention, bf16, random weights from a seed)
   scores 8 images x 8 texts = 64 pairs at S=4096, batch 32, through
   ``eval.predict.predict`` and ``write_results``; the kernel's launch
   count must be 12 per forward.
5. profile: device time by kernel over one forward of that batch
   (``torch.profiler``), and the device's idle share.
6. reference: the same model with dense attention on two of the pairs;
   the ITM logits must agree within 4 bf16 spacings.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises, so the exit code is not 0 and no result is
printed; so does a machine without a CUDA device or a directory without
the ``mmt_tpu_torch`` package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SEQ_LEN, HEADS, HEAD_DIM, REL_VOCAB = 4096, 12, 64, 49
BATCH = 32
CHECK_LENGTHS = [4096, 3001, 1000, 257]
O_BOUND, LSE_BOUND = 2e-2, 1e-3
N_IMAGES = N_TEXTS = 8
NUM_PATCHES, PATCH_DIM = 196, 768

_lines = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


def phase_build() -> None:
    from mmt_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    usage = {name: [l.strip() for l in b.log.splitlines() if "Used" in l or "spill" in l]
             for name, b in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {n: b.seconds for n, b in built.items()},
          "ptxas": usage})


def attention_inputs(lengths, seed):
    from mmt_tpu_torch.ops.fused_attention import RelGeometry

    rng = np.random.default_rng(seed)
    shape = (len(lengths), SEQ_LEN, HEADS, HEAD_DIM)
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)
               for _ in range(3))
    table = torch.from_numpy(rng.standard_normal((REL_VOCAB, HEADS, HEAD_DIM), np.float32)).to(dev)
    geo = RelGeometry(text_max_distance=12, num_patch_per_row=14, num_core_layers=1)
    return q, k, v, table, geo, torch.tensor(lengths, dtype=torch.int32, device=dev)


def kernel_errors(args):
    """Max abs error of o and lse, kernel vs plain, on real rows."""
    from mmt_tpu_torch.ops import fused_attention as fa

    lengths = args[-1].tolist()
    o, lse = fa.relative_attention_forward(*args)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.relative_attention_plain(*args)
    err_o = err_lse = 0.0
    for b, n in enumerate(lengths):
        err_o = max(err_o, (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item())
        err_lse = max(err_lse, (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item())
        if not torch.isfinite(o[b, :n]).all():
            raise AssertionError(f"non-finite kernel output in example {b}")
    return err_o, err_lse


def sdpa_with_bias(q, k, v, table, geo, lengths):
    """One ``scaled_dot_product_attention`` call given the relative bias
    and the length mask materialised as a float mask (bf16)."""
    from mmt_tpu_torch.ops.fused_attention import NEG_INF, relative_att_ids

    ids = torch.from_numpy(relative_att_ids(geo, SEQ_LEN)).to(q.device).long()
    valid = ids < table.shape[0]
    scale = 1.0 / math.sqrt(HEAD_DIM)
    qt = q.transpose(1, 2)
    masks = []
    for b in range(q.shape[0]):  # per example, to bound the fp32 temporaries
        qr = torch.einsum("hqd,vhd->hqv", qt[b].float(), table.to(q.dtype).float())
        bias = torch.gather(qr, -1, torch.where(valid, ids, 0).expand(HEADS, -1, -1))
        bias = torch.where(valid, bias, 0.0) * scale
        real = torch.arange(SEQ_LEN, device=q.device) < lengths[b]
        bias = bias + (real[:, None] != real[None, :]).float() * NEG_INF
        masks.append(bias.to(q.dtype))
    mask = torch.stack(masks)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def phase_kernel():
    from mmt_tpu_torch.ops import fused_attention as fa

    err_o, err_lse = kernel_errors(attention_inputs(CHECK_LENGTHS, seed=1))
    rng = np.random.default_rng(2)
    main_lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, BATCH).tolist()
    args = attention_inputs(main_lengths, seed=3)
    err_o_main, err_lse_main = kernel_errors(args)
    err_o, err_lse = max(err_o, err_o_main), max(err_lse, err_lse_main)
    if not (err_o <= O_BOUND and err_lse <= LSE_BOUND):
        raise AssertionError(f"kernel disagrees with plain: o {err_o} lse {err_lse}")

    ms = cuda_ms(lambda: fa.relative_attention_forward(*args), iters=10)
    plain_ms = cuda_ms(lambda: fa.relative_attention_plain(*args), iters=2)
    library = sdpa_with_bias(*args)
    library_ms = cuda_ms(library, iters=5)
    del library

    L = np.asarray(main_lengths, np.float64)
    flops = (4 * (L**2).sum() * HEAD_DIM * HEADS + 2 * L.sum() * REL_VOCAB * HEAD_DIM * HEADS)
    row_bytes = HEADS * HEAD_DIM * 2
    nbytes = (3 * L.sum() * row_bytes  # q, k, v rows the kernel reads
              + BATCH * SEQ_LEN * row_bytes  # o written
              + BATCH * HEADS * SEQ_LEN * 4  # lse written
              + REL_VOCAB * HEADS * HEAD_DIM * 4 + BATCH * 4)
    flops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    entry = {
        "name": "rel_attention_fwd",
        "route": "cuda",
        "source": "mmt_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "mmt_tpu/ops/pallas_attention.py:1593 (_fwd_kernel, K1) and "
                    "mmt_tpu/ops/pallas_attention.py:1283 (_fwd_list_kernel, K2)",
        "launches": None,
        "max_abs_err": err_o,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(flops_ms, bytes_ms),
        "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }
    emit({"phase": "kernel", "shape": [BATCH, SEQ_LEN, HEADS, HEAD_DIM],
          "check_lengths": CHECK_LENGTHS, "max_abs_err_o": err_o, "o_bound": O_BOUND,
          "max_abs_err_lse": err_lse, "lse_bound": LSE_BOUND,
          "flops": flops, "bytes": nbytes, "bound_flops_ms": flops_ms,
          "bound_bytes_ms": bytes_ms, "achieved_tflops": flops / ms / 1e9,
          **{k: entry[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}})
    return entry


def flagship_config(attention_impl: str):
    from mmt_tpu_torch.configs import (
        ClassificationModelConfig,
        ClsHeadConfig,
        EncoderConfig,
        MmtEncoderConfig,
    )

    enc = MmtEncoderConfig(
        relative_att_num_core_layers=1, relative_vocab_size=49, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, compute_dtype="bfloat16",
        attention_impl=attention_impl,
    )
    return ClassificationModelConfig(
        encoder=EncoderConfig(mmt=enc), num_classes=2,
        cls_heads=[ClsHeadConfig(inner_dim=768, num_classes=2, name="itm")])


def retrieval_batches(seed: int = 0):
    """8 images x 8 texts at S=4096, batch 32; text t's ground truth is image t."""
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((N_IMAGES, NUM_PATCHES, PATCH_DIM), np.float32)
    words = rng.integers(0, 30000, (N_TEXTS, SEQ_LEN)).astype(np.int32)
    lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, N_TEXTS).astype(np.int32)
    segment = np.where(np.arange(SEQ_LEN) < NUM_PATCHES + 2, 1, 2).astype(np.int32)
    pairs = [(i, t) for i in range(N_IMAGES) for t in range(N_TEXTS)]
    batches = []
    for start in range(0, len(pairs), BATCH):
        img = np.asarray([i for i, _ in pairs[start:start + BATCH]])
        txt = np.asarray([t for _, t in pairs[start:start + BATCH]])
        batches.append(dict(
            word_ids=words[txt], segment_ids=np.broadcast_to(segment, (len(txt), SEQ_LEN)).copy(),
            patch_embeddings=patches[img], lengths=lengths[txt],
            image_index=img, text_index=txt, gt_image_index=txt,
            valid=np.ones(len(txt), np.int32)))
    return batches


def phase_main(model):
    from mmt_tpu_torch.eval.predict import predict, write_results
    from mmt_tpu_torch.ops import fused_attention as fa

    batches = retrieval_batches()
    with torch.inference_mode():  # warm-up: cuBLAS handles, allocator
        model(**{k: torch.as_tensor(batches[0][k][:2]).cuda()
                 for k in ("word_ids", "segment_ids", "patch_embeddings", "lengths")})
    torch.cuda.synchronize()
    fa.relative_attention_forward.launches = 0
    t0 = time.perf_counter()
    results = list(predict(model, batches))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.relative_attention_forward.launches
    num_layers = model.config.encoder.mmt.num_hidden_layers
    if launches != num_layers * len(batches):
        raise AssertionError(f"{launches} kernel launches, expected {num_layers} x {len(batches)}")
    scores = np.asarray([r.output for r in results])
    if len(scores) != N_IMAGES * N_TEXTS or not np.all(np.isfinite(scores)) \
            or scores.min() < 0 or scores.max() > 1:
        raise AssertionError(f"bad scores: {scores}")
    with tempfile.TemporaryDirectory() as out:
        recall = write_results(results, out)
        rows = Path(out, "results.csv").read_text().splitlines()
        recall_file = json.loads(Path(out, "recall.json").read_text())
    if len(rows) != 1 + N_IMAGES * N_TEXTS or len(recall_file) != 8 or recall_file != recall:
        raise AssertionError(f"bad results files: {len(rows)} rows, recall {recall_file}")
    emit({"phase": "main", "pairs": len(scores), "forward_calls": len(batches),
          "batch": BATCH, "seq_len": SEQ_LEN, "launches": launches,
          "seconds": seconds, "examples_per_s": len(scores) / seconds,
          "ms_per_forward": seconds / len(batches) * 1e3,
          "score_range": [float(scores.min()), float(scores.max())], "recall": recall})
    return launches, batches[0]


def phase_reference(model, batch):
    """Fused vs dense attention in the same model on two pairs."""
    from mmt_tpu_torch.models import MmtClassificationModel

    dense_model = MmtClassificationModel(flagship_config("xla"))
    dense_model.load_state_dict(model.state_dict())
    inputs = {k: torch.as_tensor(batch[k][:2]).cuda()
              for k in ("word_ids", "segment_ids", "patch_embeddings", "lengths")}
    with torch.inference_mode():
        fused = model(**inputs)["itm_logits"]
        dense = dense_model(**inputs)["itm_logits"]
    err = (fused - dense).abs().max().item()
    scale = dense.abs().max().item()
    # The logits are bf16 after 12 bf16 layers whose attention sums in
    # another order: allow 4 bf16 spacings at the largest logit.
    bound = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    emit({"phase": "reference", "max_abs_err_itm_logits": err, "bound": bound,
          "logit_scale": scale})
    if not err <= bound:
        raise AssertionError(f"fused and dense ITM logits differ by {err} > {bound}")


def device_intervals(prof):
    """(name, start_us, end_us) of every kernel, copy and memset on the
    card, from the profiler's trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "trace.json")
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def phase_profile(model, batch) -> None:
    """Device time by kernel for one forward of the main path's batch, and
    the share of the forward's wall time in which the card ran nothing."""
    from torch.profiler import ProfilerActivity, profile

    inputs = {k: torch.as_tensor(batch[k]).cuda()
              for k in ("word_ids", "segment_ids", "patch_embeddings", "lengths")}
    with torch.inference_mode():
        model(**inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(**inputs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    intervals = sorted(device_intervals(prof), key=lambda x: x[1])
    if not intervals:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, covered_to = 0.0, -math.inf  # union of the intervals
    by_name = {}
    for name, start, end in intervals:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
        if end > covered_to:
            busy_us += end - max(start, covered_to)
            covered_to = end
    groups = {"rel_attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        if "rel_attention_fwd" in name:
            groups["rel_attention_fwd"] += ms
        elif any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "sm90")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
          "idle_share": 1 - busy_us / 1e3 / wall_ms, "device_ms_by_group": groups,
          "top_kernels_ms": [[name[:80], ms] for name, ms in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "mmt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mmt_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from mmt_tpu_torch.models import MmtClassificationModel

    name = phase_device()
    phase_build()
    entry = phase_kernel()
    model = MmtClassificationModel(flagship_config("pallas"))
    launches, batch = phase_main(model)
    entry["launches"] = launches
    phase_profile(model, batch)
    phase_reference(model, batch)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    kernels = {"kernels": [entry]}
    print(json.dumps(kernels), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.jsonl").write_text("\n".join(_lines + [json.dumps(kernels)]) + "\n")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
