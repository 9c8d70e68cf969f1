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
7. kernel_dropout: the forward kernel with attention dropout 0.1 against
   the plain version with the same seed at the check lengths (the o / lse
   bounds of phase 3) and at the pretraining micro-batch (B=64, S=256),
   rate 0 bit-identical to the call without dropout at both, and the
   kernel's time at rate 0.1 against rate 0, at both shapes below.
8. kernel_bwd: the two backward kernels against the plain backward at
   the flagship attention shape (B=32, S=4096, lengths ~ U[2048, 4096])
   and at the pretraining micro-batch (B=64, S=256, lengths ~ U[204,
   256]), each with dropout 0 and 0.1: max abs and relative errors of
   dq, dk, dv (bound: GRAD_REL_BOUND x the plain value's max) and dRel
   (DREL_REL_BOUND x its max, and DREL_ROW_BOUND x each id's own norm),
   each kernel's device time (profiler), the whole backward's time (CUDA
   events), the plain backward's, the bound, and the backward of
   ``scaled_dot_product_attention`` handed the materialised bias (its
   forward+backward time minus its forward time; a yardstick that
   computes no dRel and skips no padding, never called by the port).
9. train: the WIT pretraining experiment (configs/exp_yamls/pretrain/wit/
   mlm_itm_2d.yaml, built in Python: BERT-base geometry, 2D relative ids,
   S=256, MLM + ITM with the MPP head at 512 classes, dropout 0.1 hidden
   and attention, bf16 compute, AdamW with warmup and decay, global batch
   4096 as 64 micro-batches of 64) takes 3 optimizer steps through
   ``train.loop.run_training`` on seeded synthetic batches made on the
   card; every step's losses and accuracies must be finite and the
   forward / backward kernels must launch exactly 12 times per
   micro-batch each.
10. train_profile: device time by kernel group over one micro-batch's
   forward + backward, and the device's idle share.
11. train_reference: the gradients of every parameter tensor on a 2-example
   micro-batch, kernels against the same model with dense attention
   (autograd through the plain version), with attention dropout 0.1 at
   the same seeds and hidden dropout 0: relative Frobenius error within
   TRAIN_GRAD_BOUND.
12. kernel_window: the forward kernel's sliding-window variant (window
   512, global prefix 198 = [CLS] [PATCH] and the 196 patches) at the 4k
   pretraining micro-batch (B=8, S=4096, lengths ~ U[2048, 4096]) against
   the plain version with the window term, at dropout 0 and 0.1 (the o /
   lse bounds of phase 3); at window >= S bit-identical to the dense
   kernel; its time against the plain version's, against
   ``scaled_dot_product_attention`` handed the bias, length and window
   masks materialised as one additive mask, and against the bound from
   the allowed real pairs.
13. kernel_bwd_window: both backward kernels' windowed variants at the
   same shape and rates against the plain backward (the bounds of phase
   8), each pass's device time, the whole backward's, the plain
   version's, SDPA's backward with the same mask, and the bounds.
14. train_window: the 4k sliding-window pretraining experiment
   (configs/exp_yamls/pretrain/wit/mlm_itm_2d_long4k_window.yaml, built in
   Python: the WIT model at S=4096 with window 512 and the image part
   global, MLM + ITM, dropout 0.1, remat on, global batch 256 as 32
   micro-batches of 8) takes WINDOW_STEPS optimizer steps on seeded
   synthetic batches (lengths ~ U[2048, 4096]) made on the card; every
   step's losses and accuracies must be finite; per micro-batch the
   windowed forward kernel must launch exactly 24 times (12 layers, each
   recomputed once by remat) and each windowed backward kernel 12 times,
   the dense kernels never.  Then one micro-batch with remat off and one
   with it on: remat must lower the peak memory.
15. train_window_profile: device time by kernel group over one windowed
   micro-batch (forward, recompute and backward) and the idle share.
16. train_window_reference: per-tensor gradients of the windowed model on a
   2-example micro-batch at S=4096, kernels against dense attention, remat
   on, hidden and attention dropout 0.1 from the same seeds: relative
   Frobenius error within TRAIN_GRAD_BOUND.

17. probe_split: the far / structured split schedule as two probe passes
   (``probes.split_probe``): each pass and their logsumexp combine against
   the plain versions and the one-pass kernel at the check lengths (the o /
   lse bounds of phase 3), then the probe's entry point at the retrieval
   shape: far pass, structured pass, one-pass kernel, the share of far
   tiles; each pass also against its bound and against
   ``scaled_dot_product_attention`` handed the bias and the class mask.
18. probe_op_cost: every variant of the op-cost probe
   (``probes.op_cost_probe``) against its plain version at the retrieval
   shape (and, inside the probe's entry point, at B=1, H=2, S=512), then
   the entry point's timings at the retrieval shape: ms per variant and
   the delta against the baseline.
19. probe_hopper: every primitive probe of ``probes.hopper_probe`` (wgmma,
   TMA load / store, cp.async ring, ldmatrix.trans + stmatrix, cluster
   shared memory, 227 KB shared memory, setmaxnreg, red.v4.f32) against its
   plain version; any status other than OK fails the run.
20. predict_cli: synthetic Flickr30k-style records (16 images x 40 captions
   = 640 pairs, PNG images, a generated vocab, an ``input_meta_data`` JSON
   with ``max_seq_length`` 256), a seeded random checkpoint of the
   full-width model of configs/exp_yamls/finetune/flickr30k/
   itm_2d_from_vit.yaml (built in Python), then
   ``mmt_tpu_torch.cli.predict.main`` at batch 128: 640 rows in
   ``results.csv``, the 8 keys of ``recall.json``, 12 forward-kernel
   launches per batch, every score finite and in [0, 1]; on the first
   batch, against the same model with dense attention, the scores and the
   ITM logits within 4 bf16 spacings and the encoder's output on real rows
   within SEQUENCE_REL_BOUND of its norm; the forward kernel against its
   plain version at this path's shape (B=128, S=256, the first batch's
   lengths, no dropout; the o / lse bounds of phase 3); pairs/s of the whole call, of the host part (records ->
   batches) and of the device part (batches -> scores).

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
DROPOUT = 0.1
# Backward kernels against the plain backward: max |err| <= this x max
# |plain| for dq, dk and dv.  The kernels round p * keep and dS to bf16 for
# their products (2**-9 relative per term) and write bf16 (one more
# rounding).
GRAD_REL_BOUND = 2e-2
# dRel stays fp32 from dS on (fp32 dSV adds and FMAs, atomics in a
# run-dependent order); it differs from the plain version by the fast
# exponential and the sum order, a few 1e-6 of its max.  Held to
# DREL_REL_BOUND x max |plain| over the tensor, and each (id, head) row to
# DREL_ROW_BOUND x that row's own norm, so that a dropped or doubled run
# of a rare id (an image corner, a part id) fails too; rows that are 0 in
# the plain version (ids no pair has) must be 0.
DREL_REL_BOUND, DREL_ROW_BOUND = 1e-4, 1e-3
# Pretraining micro-batch (configs/exp_yamls/pretrain/wit/mlm_itm_2d.yaml).
TRAIN_SEQ, TRAIN_MICRO, TRAIN_GLOBAL, TRAIN_STEPS = 256, 64, 4096, 3
TRAIN_MIN_LEN = 204  # 2 + 196 image slots + at least 6 text tokens
# Kernels vs dense attention, per parameter tensor of the full-width bf16
# model: ||g - g_ref|| <= TRAIN_GRAD_BOUND * ||g_ref||.  The two paths
# round p to bf16 at other places and run 12 bf16 layers of backward.
TRAIN_GRAD_BOUND = 5e-2
# 4k sliding-window pretraining micro-batch
# (configs/exp_yamls/pretrain/wit/mlm_itm_2d_long4k_window.yaml).
WINDOW_SEQ, WINDOW_MICRO, WINDOW_GLOBAL, WINDOW_STEPS = 4096, 8, 256, 3
WINDOW, WINDOW_NUM_GLOBAL = 512, 198  # attention_num_global -1: 2 + 14**2
WINDOW_MIN_LEN = WINDOW_SEQ // 2

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


def attention_inputs(lengths, seed, seq_len=SEQ_LEN, window=0):
    from mmt_tpu_torch.ops.fused_attention import RelGeometry

    rng = np.random.default_rng(seed)
    shape = (len(lengths), seq_len, HEADS, HEAD_DIM)
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)
               for _ in range(3))
    table = torch.from_numpy(rng.standard_normal((REL_VOCAB, HEADS, HEAD_DIM), np.float32)).to(dev)
    geo = RelGeometry(text_max_distance=12, num_patch_per_row=14, num_core_layers=1,
                      window=window, num_global=WINDOW_NUM_GLOBAL if window else 0)
    return q, k, v, table, geo, torch.tensor(lengths, dtype=torch.int32, device=dev)


def kernel_errors(args, rate=0.0, seed=None):
    """Max abs error of o and lse, kernel vs plain, on real rows."""
    from mmt_tpu_torch.ops import fused_attention as fa

    lengths = args[-1].tolist()
    o, lse = fa.relative_attention_forward(*args, "cuda", rate, seed)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.relative_attention_plain(*args, rate, seed)
    err_o = err_lse = 0.0
    for b, n in enumerate(lengths):
        err_o = max(err_o, (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item())
        err_lse = max(err_lse, (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item())
        if not torch.isfinite(o[b, :n]).all():
            raise AssertionError(f"non-finite kernel output in example {b}")
    return err_o, err_lse


def materialised_bias(q, table, geo, lengths):
    """[B, H, S, S] relative bias plus length mask (and window mask, when
    ``geo.window > 0``), scaled, in q.dtype: what the kernels compute in
    place, handed to the library yardstick."""
    from mmt_tpu_torch.ops.fused_attention import NEG_INF, relative_att_ids, window_allowed

    seq = q.shape[1]
    ids = torch.from_numpy(relative_att_ids(geo, seq)).to(q.device).long()
    valid = ids < table.shape[0]
    scale = 1.0 / math.sqrt(HEAD_DIM)
    pos = torch.arange(seq, device=q.device)
    window = (torch.where(window_allowed(geo, pos[:, None], pos[None, :]), 0.0, NEG_INF)
              if geo.window > 0 else 0.0)
    masks = []
    for b in range(q.shape[0]):  # per example, to bound the fp32 temporaries
        qr = torch.einsum("qhd,vhd->hqv", q[b].float(), table.to(q.dtype).float())
        bias = torch.gather(qr, -1, torch.where(valid, ids, 0).expand(HEADS, -1, -1))
        bias = torch.where(valid, bias, 0.0) * scale
        real = torch.arange(seq, device=q.device) < lengths[b]
        bias = bias + (real[:, None] != real[None, :]).float() * NEG_INF + window
        masks.append(bias.to(q.dtype))
    return torch.stack(masks)


def sdpa_with_bias(q, k, v, table, geo, lengths):
    """One ``scaled_dot_product_attention`` call given the relative bias
    and the length mask materialised as a float mask (bf16)."""
    mask = materialised_bias(q, table, geo, lengths)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
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


def trace_summary(prof, wall_ms, groups):
    """Device busy time (union of kernel intervals), idle share of
    ``wall_ms``, device ms per group (``groups``: name -> substrings of the
    kernel name, lowercased; the rest is "other") and the top kernels."""
    intervals = sorted(device_intervals(prof), key=lambda x: x[1])
    if not intervals:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, covered_to, by_name = 0.0, -math.inf, {}
    for name, start, end in intervals:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
        if end > covered_to:
            busy_us += end - max(start, covered_to)
            covered_to = end
    by_group = {g: 0.0 for g in [*groups, "other"]}
    for name, ms in by_name.items():
        group = next((g for g, tags in groups.items()
                      if any(tag in name.lower() for tag in tags)), "other")
        by_group[group] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "device_ms_by_group": by_group,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


CUBLAS_TAGS = ("gemm", "xmma", "cutlass", "nvjet", "sm90")


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
    emit({"phase": "profile", **trace_summary(
        prof, wall_ms, {"rel_attention_fwd": ("rel_attention_fwd",), "matmul": CUBLAS_TAGS})})


def train_attention_inputs(seed, batch=TRAIN_MICRO):
    """q, k, v, table, geometry, lengths at the pretraining micro-batch shape."""
    lengths = np.random.default_rng(seed).integers(TRAIN_MIN_LEN, TRAIN_SEQ + 1, batch)
    return attention_inputs(lengths.tolist(), seed + 1, TRAIN_SEQ)


def phase_kernel_dropout():
    """The forward kernel with dropout against the plain version, and its
    time at rate 0.1 against rate 0."""
    from mmt_tpu_torch.ops import fused_attention as fa

    seed = 20260
    err_o = err_lse = 0.0
    for case in (attention_inputs(CHECK_LENGTHS, seed=1), train_attention_inputs(seed=4)):
        e_o, e_lse = kernel_errors(case, DROPOUT, seed)
        err_o, err_lse = max(err_o, e_o), max(err_lse, e_lse)
        o0, lse0 = fa.relative_attention_forward(*case)
        o0s, lse0s = fa.relative_attention_forward(*case, "cuda", 0.0, seed)
        _, lse1 = fa.relative_attention_forward(*case, "cuda", DROPOUT, seed)
        if not (torch.equal(o0, o0s) and torch.equal(lse0, lse0s)):
            raise AssertionError("rate 0 differs from the kernel without dropout")
        if not torch.equal(lse1, lse0):
            raise AssertionError("dropout changed lse")
    if not (err_o <= O_BOUND and err_lse <= LSE_BOUND):
        raise AssertionError(f"dropout kernel disagrees with plain: o {err_o} lse {err_lse}")
    times = {}
    rng = np.random.default_rng(2)
    flagship = attention_inputs(rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, BATCH).tolist(), seed=3)
    for shape_name, case in (("flagship", flagship), ("train", train_attention_inputs(seed=5))):
        iters = 10 if shape_name == "flagship" else 50
        for rate in (0.0, DROPOUT, DROPOUT, 0.0):  # in turns
            ms = cuda_ms(lambda: fa.relative_attention_forward(*case, "cuda", rate, seed), iters)
            times.setdefault(f"{shape_name}_rate_{rate}", []).append(ms)
    emit({"phase": "kernel_dropout", "rate": DROPOUT, "max_abs_err_o": err_o, "o_bound": O_BOUND,
          "max_abs_err_lse": err_lse, "lse_bound": LSE_BOUND, "rate0_bit_identical": True,
          "ms": times})
    return err_o


def backward_flops(lengths, vocab=REL_VOCAB, pairs=None):
    """(dq pass, dkv pass, whole backward) FLOPs at these lengths, over
    ``pairs`` query-key pairs (default: every real pair, sum of L**2)."""
    L = np.asarray(lengths, np.float64)
    pairs = (L**2).sum() if pairs is None else pairs
    l2, l1 = pairs * HEAD_DIM * HEADS, L.sum() * vocab * HEAD_DIM * HEADS
    return 6 * l2 + 6 * l1, 8 * l2 + 2 * l1, 10 * l2 + 6 * l1


def backward_bytes(lengths, seq_len):
    """(dq pass, dkv pass, whole backward) bytes: each input read once (the
    real rows of q, k, v, do, lse and delta, the table, the lengths), each
    output written once (all rows of dq / dk / dv; dRel per example for the
    dq pass, summed for the whole)."""
    batch, real = len(lengths), float(np.sum(lengths))
    row = HEADS * HEAD_DIM * 2
    reads = 4 * real * row + 2 * real * HEADS * 4 + HEADS * 64 * HEAD_DIM * 2 + batch * 4
    out_rows = batch * seq_len * row
    dq = reads + out_rows + batch * HEADS * 64 * HEAD_DIM * 4
    dkv = reads + 2 * out_rows
    whole = reads + 3 * out_rows + REL_VOCAB * HEADS * HEAD_DIM * 4
    return dq, dkv, whole


def bound_ms(flops, nbytes):
    f, b = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(f, b), "operations" if f >= b else "bytes"


def sdpa_backward_ms(q, k, v, table, geo, lengths, iters):
    """SDPA handed the materialised bias as a non-differentiable mask:
    forward+backward time minus forward time."""
    mask = materialised_bias(q, table, geo, lengths)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    do = torch.randn_like(qt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), iters)

    def fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt), do)

    both = cuda_ms(fwd_bwd, iters)
    return both - fwd


def profile_kernel_ms(fn, names, iters=5):
    """Device ms per call of each kernel whose name contains one of ``names``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for name, start, end in device_intervals(prof):
        for n in names:
            if n in name:
                out[n] += (end - start) / 1e3 / iters
    return out


def drel_row_error(g, w):
    """Largest ||g - w|| / ||w|| over the (id, head) rows of dRel [V, H, D];
    raises if a row that is 0 in ``w`` is not 0 in ``g``."""
    err, ref = (g - w).norm(dim=-1), w.norm(dim=-1)
    zero = ref == 0
    if torch.any(err[zero] > 0):
        raise AssertionError("dRel rows of ids that no pair has are not 0")
    return (err[~zero] / ref[~zero]).max().item()


def grad_errors(got, want, lengths):
    """Max abs and relative (to max |plain|) errors of (dq, dk, dv, drel),
    and dRel's worst per-row error."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite {name} from the backward kernels")
        if name != "drel":
            for b, n in enumerate(lengths):
                if not (torch.all(g[b, n:] == 0)):
                    raise AssertionError(f"{name} rows past the length are not 0")
        err = (g - w).abs().max().item()
        out[name] = {"max_abs_err": err, "rel_err": err / max(w.abs().max().item(), 1e-30)}
    out["drel"]["row_rel_err"] = drel_row_error(got[3].float(), want[3].float())
    return out


def check_grad_errors(errs, where):
    for name, e in errs.items():
        bound = DREL_REL_BOUND if name == "drel" else GRAD_REL_BOUND
        if not e["rel_err"] <= bound:
            raise AssertionError(f"{where}: {name} {e} > {bound}")
    if not errs["drel"]["row_rel_err"] <= DREL_ROW_BOUND:
        raise AssertionError(f"{where}: drel row {errs['drel']} > {DREL_ROW_BOUND}")


def phase_kernel_bwd():
    """The backward kernels against the plain backward at two shapes, with
    and without dropout; times at both shapes."""
    from mmt_tpu_torch.ops import fused_attention as fa

    rng = np.random.default_rng(2)
    flagship_lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, BATCH).tolist()
    shapes = {"flagship": lambda: attention_inputs(flagship_lengths, seed=3),
              "train": lambda: train_attention_inputs(seed=5)}
    results, worst = {}, {"dq": 0.0, "dk": 0.0, "dv": 0.0, "drel": 0.0}
    for shape_name, make in shapes.items():
        q, k, v, table, geo, lengths = make()
        lens = lengths.tolist()
        drng = np.random.default_rng(6)
        do = torch.from_numpy(drng.standard_normal(q.shape, np.float32)).cuda().to(torch.bfloat16)
        for rate in (0.0, DROPOUT):
            seed = 911 if rate else None
            o, lse = fa.relative_attention_forward(q, k, v, table, geo, lengths, "cuda", rate, seed)
            delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
            args = (q, k, v, do, lse, delta, table, geo, lengths)
            got = fa.relative_attention_backward(*args, "cuda", rate, seed)
            torch.cuda.synchronize()
            want = fa.relative_attention_backward_plain(*args, rate, seed)
            errs = grad_errors(got, want, lens)
            del got, want
            check_grad_errors(errs, f"{shape_name} rate {rate}")
            for name, e in errs.items():
                worst[name] = max(worst[name], e["max_abs_err"])
            entry = {"errors": errs}
            if rate == DROPOUT or shape_name == "flagship":
                iters = 10 if shape_name == "flagship" else 50
                call = lambda: fa.relative_attention_backward(*args, "cuda", rate, seed)  # noqa: E731
                entry["ms"] = cuda_ms(call, iters)
                entry["kernel_ms"] = profile_kernel_ms(
                    call, ["rel_attention_bwd_dq_kernel", "rel_attention_bwd_dkv_kernel"])
                entry["plain_ms"] = cuda_ms(
                    lambda: fa.relative_attention_backward_plain(*args, rate, seed), 2)
                if rate == 0.0 or shape_name == "train":
                    entry["library_ms"] = sdpa_backward_ms(q, k, v, table, geo, lengths,
                                                           5 if shape_name == "flagship" else 20)
            dq_f, dkv_f, all_f = backward_flops(lens)
            dq_b, dkv_b, all_b = backward_bytes(lens, q.shape[1])
            entry["bound_ms"] = {"dq": bound_ms(dq_f, dq_b), "dkv": bound_ms(dkv_f, dkv_b),
                                 "whole": bound_ms(all_f, all_b)}
            entry["flops_whole"], entry["bytes_whole"] = all_f, all_b
            results[f"{shape_name}_rate_{rate}"] = entry
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    emit({"phase": "kernel_bwd", "bound_rel": GRAD_REL_BOUND, "drel_bound_rel": DREL_REL_BOUND,
          "drel_row_bound": DREL_ROW_BOUND, "results": results})
    train = results[f"train_rate_{DROPOUT}"]
    entries = []
    for short, kname, errs in (("dq", "rel_attention_bwd_dq_kernel", ("dq", "drel")),
                                ("dkv", "rel_attention_bwd_dkv_kernel", ("dk", "dv"))):
        bound, by = train["bound_ms"][short]
        entries.append({
            "name": f"rel_attention_bwd_{short}",
            "route": "cuda",
            "source": "mmt_tpu_torch/csrc/rel_attention_bwd.cu",
            "replaces": ("mmt_tpu/ops/pallas_attention.py:2249 (_bwd_fused_kernel, K3) and "
                         + ("mmt_tpu/ops/pallas_attention.py:2100 (_bwd_dq_kernel, K5)"
                            if short == "dq" else
                            "mmt_tpu/ops/pallas_attention.py:2182 (_bwd_dkv_kernel, K5)")),
            "launches": None,
            "max_abs_err": max(worst[e] for e in errs),
            "ms": train["kernel_ms"][kname],
            # The plain version and the library call compute the whole
            # backward (both passes): their times are the whole backward's.
            "plain_ms": train["plain_ms"],
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": train["library_ms"],
        })
    return entries


def pretrain_experiment(attention_impl="pallas", hidden_dropout=DROPOUT,
                        attention_dropout=DROPOUT, train_steps=TRAIN_STEPS):
    """configs/exp_yamls/pretrain/wit/mlm_itm_2d.yaml as a Python config
    (the card's machine has no yaml package), with dummy input (the
    batches are made here) and a short run."""
    return _wit_experiment({}, TRAIN_SEQ, TRAIN_GLOBAL, TRAIN_MICRO, attention_impl,
                           hidden_dropout, attention_dropout, train_steps)


def window_experiment(attention_impl="pallas"):
    """configs/exp_yamls/pretrain/wit/mlm_itm_2d_long4k_window.yaml as a
    Python config: mlm_itm_2d.yaml at S=4096 with the sliding window, the
    image part global, remat, and global batch 256 in micro-batches of 8."""
    window = {"attention_window": WINDOW, "attention_num_global": -1, "remat": True}
    return _wit_experiment(window, WINDOW_SEQ, WINDOW_GLOBAL, WINDOW_MICRO, attention_impl,
                           DROPOUT, DROPOUT, WINDOW_STEPS)


def _wit_experiment(enc_extra, seq_len, global_batch, micro_batch, attention_impl,
                    hidden_dropout, attention_dropout, train_steps):
    from mmt_tpu_torch.configs import get_experiment_config, override

    enc = {"relative_att_num_core_layers": 1, "relative_pos_max_distance": 12,
           "relative_vocab_size": 49, "attention_impl": attention_impl,
           "compute_dtype": "bfloat16", "hidden_dropout_prob": hidden_dropout,
           "attention_probs_dropout_prob": attention_dropout, **enc_extra}
    data = {"seed": 128, "input_path": "dummy", "max_seq_len": seq_len, "tasks": "mlm,itm",
            "mpp_fraction_to_mask": 0.0, "relative_att_num_core_layers": 1,
            "is_training": True, "global_batch_size": global_batch, "use_rand_aug": True,
            "image_data_field": "image_data", "image_key_field": "canonical_doc_id"}
    return override(get_experiment_config("mmt/pretraining"), {
        "task": {"model": {"encoder": {"type": "mmt", "mmt": enc},
                           "cls_heads": [{"inner_dim": 768, "num_classes": 2, "name": "itm"}]},
                 "train_data": data},
        "trainer": {"checkpoint_interval": 1000, "max_to_keep": 32, "steps_per_loop": 1,
                    "summary_interval": 1, "train_steps": train_steps,
                    "validation_interval": 2000, "validation_steps": -1,
                    "micro_batch_size": micro_batch,
                    "optimizer_config": {
                        "polynomial": {"initial_learning_rate": 0.0005, "decay_steps": 20000},
                        "warmup": {"warmup_steps": 2000}}},
    })


def synthetic_pretrain_batch(data_cfg, vocab_size, batch, gen, device="cuda",
                             min_len=TRAIN_MIN_LEN):
    """A seeded pretraining batch made on the card: random word ids, 196
    random patch vectors, lengths ~ U[min_len, S], ~15% of the real text
    positions masked for MLM ([MASK] = 103), no MPP targets (the
    configuration masks no patches), ITM labels half negative."""
    dev = torch.device(device)
    S, n = data_cfg.max_seq_len, data_cfg.num_patches
    m, p = data_cfg.mlm_max_selections_per_seq, data_cfg.mpp_max_selections_per_seq
    pos = torch.arange(S, device=dev)
    lengths = torch.randint(min_len, S + 1, (batch,), generator=gen, device=dev)
    real = pos[None] < lengths[:, None]
    text = real & (pos[None] >= 2 + n)
    words = torch.randint(1000, vocab_size, (batch, S), generator=gen, device=dev) * real
    select = text & (torch.rand(batch, S, generator=gen, device=dev) < 0.15)
    order = torch.argsort((~select).int() * S + pos[None], dim=1)[:, :m]  # selected first
    weights = torch.gather(select, 1, order).float()
    positions = order * weights.long()
    labels = torch.gather(words, 1, positions) * weights.long()
    words = torch.where(select, torch.full_like(words, 103), words)
    return {
        "word_ids": words,
        "segment_ids": torch.where(pos[None] < 2 + n, 0, 1).expand(batch, S).contiguous(),
        "patch_embeddings": torch.randn(batch, n, 3 * data_cfg.patch_size**2, generator=gen,
                                        device=dev),
        "lengths": lengths,
        "mlm_positions": positions, "mlm_label_ids": labels, "mlm_label_weights": weights,
        "mpp_positions": torch.zeros(batch, p, dtype=torch.long, device=dev),
        "mpp_label_ids": torch.zeros(batch, p, dtype=torch.long, device=dev),
        "mpp_label_weights": torch.zeros(batch, p, device=dev),
        "itm_label_ids": (torch.rand(batch, generator=gen, device=dev) < 0.5).long(),
        "itm_label_weights": torch.ones(batch, device=dev),
    }


def launch_counts():
    """Every kernel launch counter of the attention op, by name."""
    from mmt_tpu_torch.ops import fused_attention as fa

    fwd, bwd = fa.relative_attention_forward, fa.relative_attention_backward
    return {"fwd": fwd.launches, "fwd_window": fwd.launches_window,
            "bwd_dq": bwd.launches_dq, "bwd_dkv": bwd.launches_dkv,
            "bwd_dq_window": bwd.launches_dq_window, "bwd_dkv_window": bwd.launches_dkv_window}


def reset_launch_counts() -> None:
    from mmt_tpu_torch.ops import fused_attention as fa

    fwd, bwd = fa.relative_attention_forward, fa.relative_attention_backward
    fwd.launches = fwd.launches_window = 0
    bwd.launches_dq = bwd.launches_dkv = bwd.launches_dq_window = bwd.launches_dkv_window = 0


def phase_train():
    """Three optimizer steps of WIT pretraining at full width through
    ``run_training``."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.loop import run_training
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import PretrainingTask
    from mmt_tpu_torch.train.train_state import TrainState

    cfg = pretrain_experiment()
    task = PretrainingTask(cfg.task, cfg.trainer, device="cuda", seed=0)
    vocab = cfg.task.model.encoder.mmt.vocab_size
    optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps, task.model)
    state = TrainState.create(task.model, optimizer)
    gen = torch.Generator("cuda").manual_seed(1)
    batches = (synthetic_pretrain_batch(cfg.task.train_data, vocab, TRAIN_GLOBAL, gen)
               for _ in iter(int, 1))
    rngs = DropoutRngs(host=torch.Generator().manual_seed(2),
                       device=torch.Generator("cuda").manual_seed(3))
    micro_per_step = TRAIN_GLOBAL // TRAIN_MICRO
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        run_training(train_step=task.make_train_step(cfg.trainer.micro_batch_size),
                     state=state, train_iter=batches, trainer=cfg.trainer,
                     model_dir=model_dir, rngs=rngs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        summaries = [json.loads(l) for l in
                     Path(model_dir, "train_summaries.jsonl").read_text().splitlines()]
    counts = launch_counts()
    launches = {k: counts[k] for k in ("fwd", "bwd_dq", "bwd_dkv")}
    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    expected = layers * micro_per_step * TRAIN_STEPS
    if set(launches.values()) != {expected} or any(counts[k] for k in counts if "window" in k):
        raise AssertionError(f"launches {counts}, expected {expected} of each dense kernel")
    if len(summaries) != TRAIN_STEPS or not all(
            math.isfinite(v) for s in summaries for v in s.values()):
        raise AssertionError(f"bad train summaries: {summaries}")
    later = [1.0 / s["steps_per_sec"] for s in summaries[1:]]
    ms_step = float(np.mean(later)) * 1e3
    emit({"phase": "train", "global_batch": TRAIN_GLOBAL, "micro_batch": TRAIN_MICRO,
          "micro_batches_per_step": micro_per_step, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "seconds": seconds, "ms_per_step_after_first": ms_step,
          "examples_per_s": TRAIN_GLOBAL / (ms_step / 1e3),
          "ms_per_micro_batch": ms_step / micro_per_step,
          "first_step_ms": 1e3 / summaries[0]["steps_per_sec"],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_per_micro_batch": layers,
          "summaries": summaries})
    return task, cfg, launches


def phase_train_profile(task, cfg):
    """Device time by kernel group over one micro-batch forward+backward."""
    from torch.profiler import ProfilerActivity, profile

    from mmt_tpu_torch.models import DropoutRngs

    gen = torch.Generator("cuda").manual_seed(4)
    batch = synthetic_pretrain_batch(cfg.task.train_data, cfg.task.model.encoder.mmt.vocab_size,
                                     TRAIN_MICRO, gen)
    rngs = DropoutRngs(host=torch.Generator().manual_seed(5),
                       device=torch.Generator("cuda").manual_seed(6))

    def micro_step():
        loss, _ = task.compute_loss(batch, rngs)
        loss.backward()

    micro_step()
    task.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        micro_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    task.model.zero_grad(set_to_none=True)
    emit({"phase": "train_profile", "micro_batch": TRAIN_MICRO, **trace_summary(
        prof, wall_ms, {"rel_attention_fwd": ("rel_attention_fwd",),
                        "rel_attention_bwd": ("rel_attention_bwd",), "cublas": CUBLAS_TAGS})})


def phase_train_reference():
    """Per-tensor gradients, kernels against dense attention, on a
    2-example micro-batch with attention dropout at the same seeds."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.tasks import PretrainingTask

    grads = {}
    for impl in ("pallas", "xla"):
        cfg = pretrain_experiment(impl, hidden_dropout=0.0, attention_dropout=DROPOUT)
        task = PretrainingTask(cfg.task, cfg.trainer, device="cuda", seed=7)
        batch = synthetic_pretrain_batch(cfg.task.train_data, cfg.task.model.encoder.mmt.vocab_size,
                                         2, torch.Generator("cuda").manual_seed(8))
        loss, _ = task.compute_loss(batch, DropoutRngs(host=torch.Generator().manual_seed(9)))
        loss.backward()
        grads[impl] = {n: p.grad for n, p in task.model.named_parameters()}
        del task
    worst, worst_name, n_zero, errors = 0.0, "", 0, {}
    for name, g in grads["pallas"].items():
        ref = grads["xla"][name]
        if g is None or ref is None:
            raise AssertionError(f"no gradient for {name}")
        # The key bias's exact gradient is 0 (softmax is invariant to adding
        # q . b_k to every logit of a row): both sides give rounding noise,
        # so it is measured against the same layer's query-bias gradient.
        scale_name = (name[: -len("key.bias")] + "query.bias"
                      if name.endswith("attention.key.bias") else name)
        ref_norm = grads["xla"][scale_name].norm().item()
        if ref_norm == 0.0:
            n_zero += 1
            if g.norm().item() != 0.0:
                raise AssertionError(f"{name}: dense gradient is 0, kernel gradient is not")
            continue
        err = (g - ref).norm().item() / ref_norm
        errors[name] = err
        if err > worst:
            worst, worst_name = err, name
    top = sorted(errors.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "train_reference", "tensors": len(grads["pallas"]), "zero_tensors": n_zero,
          "max_rel_frobenius_err": worst, "worst_tensor": worst_name, "bound": TRAIN_GRAD_BOUND,
          "largest_errors": top})
    if not worst <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"{worst_name}: gradient error {worst} > {TRAIN_GRAD_BOUND}")


def window_attention_inputs(seed):
    """q, k, v, table, geometry, lengths at the 4k pretraining micro-batch
    (B=8, S=4096, lengths ~ U[2048, 4096]) with the sliding window."""
    lengths = np.random.default_rng(seed).integers(WINDOW_MIN_LEN, WINDOW_SEQ + 1, WINDOW_MICRO)
    return attention_inputs(lengths.tolist(), seed + 1, WINDOW_SEQ, window=WINDOW)


def live_tile_share(lengths, window, num_global):
    """Share of the 64 x 64 tiles below each length that hold an allowed
    pair (the tiles the windowed kernels visit)."""
    tile = 64
    live = total = 0
    for length in lengths:
        n = -(-length // tile)
        head = min(-(-num_global // tile), n)
        total += n * n
        for r0 in range(0, n * tile, tile):
            if r0 < num_global:
                live += n
                continue
            lo = max(max(r0 - window, 0) // tile, head)
            hi = min((r0 + tile - 1 + window) // tile + 1, n)
            live += head + max(hi - lo, 0)
    return live / total


def phase_kernel_window():
    """The windowed forward against the plain version at the 4k pretraining
    micro-batch; bit-identity with the dense kernel at window >= S; times."""
    import dataclasses

    from mmt_tpu_torch.ops import fused_attention as fa

    args = window_attention_inputs(seed=30)
    q, k, v, table, geo, lengths = args
    lens = lengths.tolist()
    seed = 4242
    err_o = err_lse = 0.0
    for rate in (0.0, DROPOUT):
        e_o, e_lse = kernel_errors(args, rate, seed if rate else None)
        err_o, err_lse = max(err_o, e_o), max(err_lse, e_lse)
    if not (err_o <= O_BOUND and err_lse <= LSE_BOUND):
        raise AssertionError(f"windowed kernel disagrees with plain: o {err_o} lse {err_lse}")
    wide = dataclasses.replace(geo, window=WINDOW_SEQ)
    dense = dataclasses.replace(geo, window=0, num_global=0)
    for rate in (0.0, DROPOUT):
        sd = seed if rate else None
        o_w, lse_w = fa.relative_attention_forward(q, k, v, table, wide, lengths, "cuda", rate, sd)
        o_d, lse_d = fa.relative_attention_forward(q, k, v, table, dense, lengths, "cuda", rate,
                                                   sd)
        if not (torch.equal(o_w, o_d) and torch.equal(lse_w, lse_d)):
            raise AssertionError(f"window >= S differs from the dense kernel at rate {rate}")
    del o_w, lse_w, o_d, lse_d

    times = {}
    for rate in (0.0, DROPOUT, DROPOUT, 0.0):  # in turns
        sd = seed if rate else None
        ms = cuda_ms(lambda: fa.relative_attention_forward(*args, "cuda", rate, sd), iters=20)
        times.setdefault(f"rate_{rate}", []).append(ms)
    ms = float(np.mean(times[f"rate_{DROPOUT}"]))
    plain_ms = cuda_ms(lambda: fa.relative_attention_plain(*args, DROPOUT, seed), iters=2)
    library = sdpa_with_bias(*args)
    library_ms = cuda_ms(library, iters=5)
    del library
    torch.cuda.empty_cache()

    pairs = fa.allowed_real_pairs(geo, lens)
    L = np.asarray(lens, np.float64)
    flops = 4 * pairs * HEAD_DIM * HEADS + 2 * L.sum() * REL_VOCAB * HEAD_DIM * HEADS
    row_bytes = HEADS * HEAD_DIM * 2
    nbytes = (3 * L.sum() * row_bytes + WINDOW_MICRO * WINDOW_SEQ * row_bytes
              + WINDOW_MICRO * HEADS * WINDOW_SEQ * 4 + REL_VOCAB * HEADS * HEAD_DIM * 4
              + WINDOW_MICRO * 4)
    bound, by = bound_ms(flops, nbytes)
    entry = {
        "name": "rel_attention_fwd_window",
        "route": "cuda",
        "source": "mmt_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "mmt_tpu/ops/pallas_attention.py:1283 (_fwd_list_kernel, K2, over the "
                    "window list _window_tile_list :1245)",
        "launches": None,
        "max_abs_err": err_o,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
    }
    emit({"phase": "kernel_window", "shape": [WINDOW_MICRO, WINDOW_SEQ, HEADS, HEAD_DIM],
          "window": WINDOW, "num_global": WINDOW_NUM_GLOBAL, "lengths": lens,
          "allowed_real_pairs": pairs, "allowed_share": pairs / float((L**2).sum()),
          "live_tile_share": live_tile_share(lens, WINDOW, WINDOW_NUM_GLOBAL),
          "max_abs_err_o": err_o, "o_bound": O_BOUND, "max_abs_err_lse": err_lse,
          "lse_bound": LSE_BOUND, "window_ge_seq_bit_identical": True, "ms_by_rate": times,
          "flops": flops, "bytes": nbytes, "achieved_tflops": flops / ms / 1e9,
          **{k: entry[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    return entry


def phase_kernel_bwd_window():
    """The windowed backward kernels against the plain backward at the 4k
    pretraining micro-batch, with and without dropout; times."""
    import dataclasses

    from mmt_tpu_torch.ops import fused_attention as fa

    q, k, v, table, geo, lengths = window_attention_inputs(seed=30)
    lens = lengths.tolist()
    do = torch.from_numpy(np.random.default_rng(31).standard_normal(q.shape, np.float32)).cuda()
    do = do.to(torch.bfloat16)
    wide = dataclasses.replace(geo, window=WINDOW_SEQ)
    dense = dataclasses.replace(geo, window=0, num_global=0)
    pairs = fa.allowed_real_pairs(geo, lens)
    dq_f, dkv_f, all_f = backward_flops(lens, pairs=pairs)
    dq_b, dkv_b, all_b = backward_bytes(lens, WINDOW_SEQ)
    bounds = {"dq": bound_ms(dq_f, dq_b), "dkv": bound_ms(dkv_f, dkv_b),
              "whole": bound_ms(all_f, all_b)}
    names = ["rel_attention_bwd_dq_kernel", "rel_attention_bwd_dkv_kernel"]
    results, worst = {}, {"dq": 0.0, "dk": 0.0, "dv": 0.0, "drel": 0.0}
    for rate in (0.0, DROPOUT):
        seed = 911 if rate else None
        o, lse = fa.relative_attention_forward(q, k, v, table, geo, lengths, "cuda", rate, seed)
        delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
        args = (q, k, v, do, lse, delta, table, geo, lengths)
        got = fa.relative_attention_backward(*args, "cuda", rate, seed)
        torch.cuda.synchronize()
        want = fa.relative_attention_backward_plain(*args, rate, seed)
        errs = grad_errors(got, want, lens)
        del got, want
        check_grad_errors(errs, f"window rate {rate}")
        for name, e in errs.items():
            worst[name] = max(worst[name], e["max_abs_err"])
        # window >= S against the dense kernels: dk, dv bit-identical (and
        # dq at rate 0); dRel's atomics add in a run-dependent order.
        g_w = fa.relative_attention_backward(q, k, v, do, lse, delta, table, wide, lengths,
                                             "cuda", rate, seed)
        g_d = fa.relative_attention_backward(q, k, v, do, lse, delta, table, dense, lengths,
                                             "cuda", rate, seed)
        identical = [torch.equal(a, b) for a, b in zip(g_w[:3], g_d[:3])]
        if not (identical[1] and identical[2] and (rate or identical[0])):
            raise AssertionError(f"window >= S backward differs from dense: {identical}")
        dq_rel = ((g_w[0].float() - g_d[0].float()).abs().max()
                  / g_d[0].float().abs().max()).item()
        if dq_rel > GRAD_REL_BOUND:
            raise AssertionError(f"window >= S dq differs from dense by {dq_rel}")
        del g_w, g_d
        call = lambda: fa.relative_attention_backward(*args, "cuda", rate, seed)  # noqa: E731
        results[f"rate_{rate}"] = {
            "errors": errs,
            "window_ge_seq_identical_dq_dk_dv": identical, "window_ge_seq_dq_rel_diff": dq_rel,
            "ms": cuda_ms(call, 10),
            "kernel_ms": profile_kernel_ms(call, names),
            "plain_ms": cuda_ms(lambda: fa.relative_attention_backward_plain(*args, rate, seed),
                                2),
            "library_ms": sdpa_backward_ms(q, k, v, table, geo, lengths, 5),
        }
        torch.cuda.empty_cache()
    emit({"phase": "kernel_bwd_window", "shape": [WINDOW_MICRO, WINDOW_SEQ, HEADS, HEAD_DIM],
          "window": WINDOW, "num_global": WINDOW_NUM_GLOBAL, "allowed_real_pairs": pairs,
          "bound_rel": GRAD_REL_BOUND, "drel_bound_rel": DREL_REL_BOUND,
          "drel_row_bound": DREL_ROW_BOUND, "bound_ms": bounds, "flops_whole": all_f,
          "bytes_whole": all_b, "results": results})
    main_rate = results[f"rate_{DROPOUT}"]
    entries = []
    for short, kname, errs, tpu in (
            ("dq", names[0], ("dq", "drel"),
             "mmt_tpu/ops/pallas_attention.py:2373 (_bwd_dq_list_kernel, K6)"),
            ("dkv", names[1], ("dk", "dv"),
             "mmt_tpu/ops/pallas_attention.py:2454 (_bwd_dkv_list_kernel, K6)")):
        entries.append({
            "name": f"rel_attention_bwd_{short}_window",
            "route": "cuda",
            "source": "mmt_tpu_torch/csrc/rel_attention_bwd.cu",
            "replaces": "mmt_tpu/ops/pallas_attention.py:2521 (_bwd_fused_list_kernel, K4) "
                        "and " + tpu,
            "launches": None,
            "max_abs_err": max(worst[e] for e in errs),
            "ms": main_rate["kernel_ms"][kname],
            # The plain version and the library call compute the whole
            # backward (both passes): their times are the whole backward's.
            "plain_ms": main_rate["plain_ms"],
            "bound_ms": bounds[short][0],
            "bound_by": bounds[short][1],
            "library_ms": main_rate["library_ms"],
        })
    return entries


def window_micro_batch(cfg, batch, gen):
    return synthetic_pretrain_batch(cfg.task.train_data, cfg.task.model.encoder.mmt.vocab_size,
                                    batch, gen, min_len=WINDOW_MIN_LEN)


def phase_train_window():
    """WINDOW_STEPS optimizer steps of the 4k sliding-window pretraining
    experiment at full width through ``run_training``; then the peak
    memory of one micro-batch with remat off and on."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.loop import run_training
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import PretrainingTask
    from mmt_tpu_torch.train.train_state import TrainState

    cfg = window_experiment()
    task = PretrainingTask(cfg.task, cfg.trainer, device="cuda", seed=0)
    optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps, task.model)
    state = TrainState.create(task.model, optimizer)
    gen = torch.Generator("cuda").manual_seed(21)
    batches = (window_micro_batch(cfg, WINDOW_GLOBAL, gen) for _ in iter(int, 1))
    rngs = DropoutRngs(host=torch.Generator().manual_seed(22),
                       device=torch.Generator("cuda").manual_seed(23))
    micro_per_step = WINDOW_GLOBAL // WINDOW_MICRO
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        run_training(train_step=task.make_train_step(cfg.trainer.micro_batch_size),
                     state=state, train_iter=batches, trainer=cfg.trainer,
                     model_dir=model_dir, rngs=rngs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        summaries = [json.loads(l) for l in
                     Path(model_dir, "train_summaries.jsonl").read_text().splitlines()]
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    micro_batches = micro_per_step * WINDOW_STEPS
    expected = {"fwd": 0, "fwd_window": 2 * layers * micro_batches, "bwd_dq": 0, "bwd_dkv": 0,
                "bwd_dq_window": layers * micro_batches, "bwd_dkv_window": layers * micro_batches}
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if len(summaries) != WINDOW_STEPS or not all(
            math.isfinite(v) for s in summaries for v in s.values()):
        raise AssertionError(f"bad train summaries: {summaries}")
    later = [1.0 / s["steps_per_sec"] for s in summaries[1:]]
    ms_step = float(np.mean(later)) * 1e3

    # One micro-batch with remat off, then on: remat must lower the peak.
    batch = window_micro_batch(cfg, WINDOW_MICRO, torch.Generator("cuda").manual_seed(24))
    peaks, remat_launches = {}, {}
    for remat in (False, True):
        task.model.encoder.transformer.remat = remat
        task.model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        loss, _ = task.compute_loss(batch, DropoutRngs(host=torch.Generator().manual_seed(25)))
        loss.backward()
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        remat_launches[remat] = launch_counts()["fwd_window"]
        del loss
    task.model.zero_grad(set_to_none=True)
    if not peaks[True] < peaks[False] or remat_launches != {False: layers, True: 2 * layers}:
        raise AssertionError(f"remat: peaks {peaks} GB, forward launches {remat_launches}")
    emit({"phase": "train_window", "global_batch": WINDOW_GLOBAL, "micro_batch": WINDOW_MICRO,
          "micro_batches_per_step": micro_per_step, "seq_len": WINDOW_SEQ, "window": WINDOW,
          "num_global": WINDOW_NUM_GLOBAL, "remat": True, "steps": WINDOW_STEPS,
          "seconds": seconds, "ms_per_step_after_first": ms_step,
          "examples_per_s": WINDOW_GLOBAL / (ms_step / 1e3),
          "ms_per_micro_batch": ms_step / micro_per_step,
          "first_step_ms": 1e3 / summaries[0]["steps_per_sec"], "peak_memory_gb": peak_gb,
          "micro_batch_peak_above_state_gb": {"remat_off": peaks[False], "remat_on": peaks[True]},
          "launches": counts, "launches_per_micro_batch": {
              "fwd_window": 2 * layers, "bwd_dq_window": layers, "bwd_dkv_window": layers},
          "summaries": summaries})
    return task, cfg, counts


def phase_train_window_profile(task, cfg):
    """Device time by kernel group over one windowed micro-batch: forward,
    remat's recompute and backward."""
    from torch.profiler import ProfilerActivity, profile

    from mmt_tpu_torch.models import DropoutRngs

    batch = window_micro_batch(cfg, WINDOW_MICRO, torch.Generator("cuda").manual_seed(26))
    rngs = DropoutRngs(host=torch.Generator().manual_seed(27),
                       device=torch.Generator("cuda").manual_seed(28))

    def micro_step():
        loss, _ = task.compute_loss(batch, rngs)
        loss.backward()

    task.model.encoder.transformer.remat = True
    micro_step()
    task.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        micro_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    task.model.zero_grad(set_to_none=True)
    emit({"phase": "train_window_profile", "micro_batch": WINDOW_MICRO, **trace_summary(
        prof, wall_ms, {"rel_attention_fwd": ("rel_attention_fwd",),
                        "rel_attention_bwd": ("rel_attention_bwd",), "cublas": CUBLAS_TAGS})})


def phase_train_window_reference():
    """Per-tensor gradients of the windowed model with remat, kernels
    against dense attention, on a 2-example micro-batch at S=4096 with
    hidden and attention dropout from the same seeds."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.tasks import PretrainingTask

    grads = {}
    for impl in ("pallas", "xla"):
        cfg = window_experiment(impl)
        task = PretrainingTask(cfg.task, cfg.trainer, device="cuda", seed=7)
        batch = window_micro_batch(cfg, 2, torch.Generator("cuda").manual_seed(8))
        rngs = DropoutRngs(host=torch.Generator().manual_seed(9),
                           device=torch.Generator("cuda").manual_seed(10))
        loss, _ = task.compute_loss(batch, rngs)
        loss.backward()
        grads[impl] = {n: p.grad for n, p in task.model.named_parameters()}
        del task, loss
        torch.cuda.empty_cache()
    worst, worst_name, errors = 0.0, "", {}
    for name, g in grads["pallas"].items():
        ref = grads["xla"][name]
        if g is None or ref is None:
            raise AssertionError(f"no gradient for {name}")
        # The key bias against the query bias's norm, as in train_reference.
        scale_name = (name[: -len("key.bias")] + "query.bias"
                      if name.endswith("attention.key.bias") else name)
        ref_norm = grads["xla"][scale_name].norm().item()
        if ref_norm == 0.0:
            if g.norm().item() != 0.0:
                raise AssertionError(f"{name}: dense gradient is 0, kernel gradient is not")
            continue
        errors[name] = (g - ref).norm().item() / ref_norm
        if errors[name] > worst:
            worst, worst_name = errors[name], name
    top = sorted(errors.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "train_window_reference", "tensors": len(grads["pallas"]),
          "max_rel_frobenius_err": worst, "worst_tensor": worst_name, "bound": TRAIN_GRAD_BOUND,
          "largest_errors": top})
    if not worst <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"{worst_name}: gradient error {worst} > {TRAIN_GRAD_BOUND}")


# ------------------------------------------------------------------ probes


def probe_entry(name, source, replaces, err, ms, plain_ms, flops, nbytes, library_ms=None):
    """One row of the ``kernels`` line for a probe kernel; ``launches`` is
    filled in from the probe's entry-point run."""
    flops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def require_launched(entries, where) -> None:
    missing = [e["name"] for e in entries if not e["launches"]]
    if missing:
        raise AssertionError(f"{where}: no launch of {missing} in the entry point's run")


def split_pass_pairs(geo, lengths, seq_len):
    """Real (query, key) pairs in far and in structured tiles, summed over
    the batch: what each pass's products must cover."""
    from mmt_tpu_torch.probes import split_probe as sp

    classes = sp.tile_classes(geo, seq_len)
    far = struct = 0
    for length in lengths:
        n = -(-length // sp.TILE)
        real = np.minimum(sp.TILE, length - np.arange(n) * sp.TILE).astype(np.float64)
        pairs = real[:, None] * real[None, :]
        is_far = classes[:n, :n] != sp.STRUCTURED
        far += pairs[is_far].sum()
        struct += pairs[~is_far].sum()
    return far, struct


def phase_probe_split():
    from mmt_tpu_torch.ops import fused_attention as fa
    from mmt_tpu_torch.probes import common, split_probe as sp

    checks = sp.check(CHECK_LENGTHS, seed=1)
    lengths = common.retrieval_lengths()
    q, k, v, table, lens = common.attention_inputs(lengths, seed=3)
    geo = common.FLAGSHIP
    rel = fa.kernel_rel_table(table)
    # Each pass at the retrieval shape: plain version and the library
    # yardstick (SDPA handed the bias, the length mask and the class mask).
    classes = torch.from_numpy(sp.tile_classes(geo, SEQ_LEN) != sp.STRUCTURED).cuda()
    in_far = classes.repeat_interleave(sp.TILE, 0).repeat_interleave(sp.TILE, 1)
    mask = materialised_bias(q, table, geo, lens)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    plain_ms, library_ms = {}, {}
    for far in (True, False):
        plain_ms[far] = cuda_ms(lambda: sp.split_pass_plain(q, k, v, table, geo, lens, far),
                                iters=1, warmup=0)
        class_mask = mask.masked_fill((in_far != far)[None, None], fa.NEG_INF)
        library_ms[far] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=class_mask), iters=3)
        del class_mask
    del mask
    torch.cuda.empty_cache()

    sp.split_pass.launches_far = sp.split_pass.launches_structured = 0
    result = sp.run()  # the probe's entry point: its checks, then its timings
    times = result["times"]
    far_pairs, struct_pairs = split_pass_pairs(geo, lengths, SEQ_LEN)
    L = float(np.sum(lengths))
    row_bytes = HEADS * HEAD_DIM * 2
    # q, k, v read once; o (fp32) and lse written once.
    nbytes = 3 * L * row_bytes + BATCH * SEQ_LEN * HEADS * HEAD_DIM * 4 + BATCH * HEADS * SEQ_LEN * 4
    source = "mmt_tpu_torch/csrc/probe_split.cu"
    replaces = "scripts/split_probe.py:32 (one_pass over one list of _split_tile_lists, P1)"
    entries = [
        probe_entry("probe_split_far", source, replaces,
                    checks["far_vs_plain"]["o"], times["far_ms"], plain_ms[True],
                    4 * far_pairs * HEAD_DIM * HEADS + 2 * L * 2 * HEAD_DIM * HEADS, nbytes,
                    library_ms[True]),
        probe_entry("probe_split_structured", source, replaces,
                    checks["structured_vs_plain"]["o"], times["structured_ms"], plain_ms[False],
                    4 * struct_pairs * HEAD_DIM * HEADS + 2 * L * REL_VOCAB * HEAD_DIM * HEADS,
                    nbytes, library_ms[False]),
    ]
    entries[0]["launches"] = sp.split_pass.launches_far
    entries[1]["launches"] = sp.split_pass.launches_structured
    require_launched(entries, "probe_split")
    emit({"phase": "probe_split", "checks": checks, "entry_point_checks": result["checks"],
          **times, "far_pairs": far_pairs, "structured_pairs": struct_pairs,
          "plain_ms": {"far": plain_ms[True], "structured": plain_ms[False]},
          "library_ms": {"far": library_ms[True], "structured": library_ms[False]}})
    return entries


def phase_probe_op_cost():
    from mmt_tpu_torch.probes import common, op_cost_probe as oc

    # Every variant against its plain version at the retrieval shape, on the
    # inputs the entry point times the kernel on; the plain version's one
    # call (it loops over the examples) is timed as it is made.
    lengths = common.retrieval_lengths()
    q, k, v, table, lens = common.attention_inputs(lengths, seed=3)
    errors, bounds, plain_ms = {}, {}, {}
    for name in oc.VARIANTS:
        want = []
        plain_ms[name] = cuda_ms(lambda: want.append(oc.op_cost_plain(
            name, q, k, v, table, common.FLAGSHIP, lens)), iters=1, warmup=0)
        got = oc.op_cost(name, q, k, v, table, common.FLAGSHIP, lens)
        torch.cuda.synchronize()
        bounds[name] = oc.PV_RETRIEVAL_REL_BOUND if name == "pv" else oc.REL_BOUND
        errors[name] = oc.relative_error(name, got, want[0], bounds[name])  # raises above it
        del want, got
    del q, k, v

    for name in oc.VARIANTS:
        oc.op_cost.launches[name] = 0
    # The probe's entry point: its checks (B=1, H=2, S=512), then its timings.
    result = oc.run()
    visited = np.asarray([-(-n // oc.TILE) * oc.TILE for n in lengths], np.float64)
    row_bytes = HEADS * HEAD_DIM * 2
    out_bytes = BATCH * HEADS * SEQ_LEN * 4
    # Columns of q . R^T a variant reads: column 0 is in every written sum.
    qr_columns = {"gather": REL_VOCAB, "rank1": 3}
    entries = []
    for name in oc.VARIANTS:
        reads_v = name in ("pv", "kt_store", "ldmatrix_trans")
        flops = 2 * (visited**2).sum() * HEAD_DIM * HEADS * (2 if name == "pv" else 1) \
            + 2 * visited.sum() * qr_columns.get(name, 1) * HEAD_DIM * HEADS
        nbytes = (3 if reads_v else 2) * visited.sum() * row_bytes + out_bytes
        entry = probe_entry(
            f"probe_op_cost_{name}", "mmt_tpu_torch/csrc/probe_op_cost.cu",
            "scripts/op_cost_probe.py:213 (bench over make's variants, P2)",
            errors[name], result["ms"][name], plain_ms[name], flops, nbytes)
        entry["err_relative_to"] = "max |plain| at the retrieval shape"
        entry["rel_bound"] = bounds[name]
        entry["launches"] = oc.op_cost.launches[name]
        entries.append(entry)
    require_launched(entries, "probe_op_cost")
    emit({"phase": "probe_op_cost", "rel_errors": errors, "rel_bounds": bounds,
          "small_shape_rel_errors": result["rel_errors"], "small_shape": oc.CHECK_SHAPE,
          "shape": result["shape"], "ms": result["ms"], "delta_ms": result["delta_ms"],
          "plain_ms": plain_ms})
    return entries


def phase_probe_hopper():
    from mmt_tpu_torch.probes import hopper_probe as hp

    entries = []
    for name, (_, kernel, plain, atol) in hp.PROBES.items():
        err = hp.run_probe(name)  # raises above the probe's tolerance
        inputs = hp.probe_inputs(name)
        nbytes = sum(t.numel() * t.element_size() for t in inputs)
        out = plain(*inputs)
        nbytes += out.numel() * out.element_size()
        flops = 2 * 64 * 64 * 64 if name.startswith("wgmma") else 0
        plain_ms = cuda_ms(lambda: plain(*inputs), iters=20)
        # The library yardstick: one ATen call that computes the function.
        # For the copies, the transpose, the flips and the column sum that
        # is the plain version itself (clone, contiguous, flip, sum); for
        # wgmma one cuBLAS product of the bf16 inputs; 3 x + 1 takes two
        # calls, so setmaxnreg has none.
        if name.startswith("wgmma"):
            a, b = inputs
            library_ms = cuda_ms(lambda: torch.mm(a, b.T), iters=20)
        else:
            library_ms = None if name == "setmaxnreg" else plain_ms
        entries.append(probe_entry(
            f"probe_hopper_{name}", "mmt_tpu_torch/csrc/probe_hopper.cu",
            "scripts/mosaic_probe.py:26-125 (probe_*, P3)", err,
            cuda_ms(lambda: kernel(*inputs), iters=20), plain_ms, flops, nbytes, library_ms))
        entries[-1]["atol"] = atol
    for name in hp.launches:
        hp.launches[name] = 0
    status = hp.run()  # the probe's entry point: one status per probe
    for entry, name in zip(entries, hp.PROBES):
        entry["launches"] = hp.launches[name]
    emit({"phase": "probe_hopper", "status": status,
          "max_abs_err": {e["name"]: e["max_abs_err"] for e in entries}})
    bad = {name: s for name, s in status.items() if s != "OK"}
    if bad:
        raise AssertionError(f"Hopper primitive probes not OK: {bad}")
    require_launched(entries, "probe_hopper")
    return entries


# ------------------------------------------------------------- predict CLI

CLI_IMAGES, CLI_TEXTS, CLI_BATCH, CLI_SEQ = 16, 40, 128, 256
CLI_VOCAB_SIZE, CLI_WORDS = 30522, 2000
# The encoder's fp32 output after 12 bf16 layers, kernels against dense
# attention (which sums in another order and rounds p at another place):
# about 5 bf16 spacings of relative Frobenius error per example.
SEQUENCE_REL_BOUND = 2e-2


def flickr_experiment(vocab_path: str, attention_impl="pallas") -> dict:
    """configs/exp_yamls/finetune/flickr30k/itm_2d_from_vit.yaml as nested
    overrides of mmt/classification (written out as JSON text, which the
    config loader reads without a yaml package): L12/H768/A12, I3072, P=14,
    r=1, text distance 12, relative vocab 49, bf16."""
    data = {"seed": 128, "cycle_length": 8, "vocab_filename": vocab_path, "pos_weight": 1.0,
            "max_seq_len": CLI_SEQ, "image_data_field": "image_data",
            "image_key_field": "image_key",
            "text_special_token_field_dict": '{"caption": "[ATT]"}', "tasks": "itm",
            "negative_positive_ratio": 3, "relative_att_num_core_layers": 1}
    return {
        "task": {
            "model": {
                "encoder": {"type": "mmt", "mmt": {
                    "relative_att_num_core_layers": 1, "relative_pos_max_distance": 12,
                    "relative_vocab_size": 49, "attention_impl": attention_impl,
                    "compute_dtype": "bfloat16", "max_absolute_position_embeddings": 578}},
                "cls_heads": [{"inner_dim": 768, "num_classes": 2, "name": "itm"}],
                "num_classes": 2},
            "train_data": {**data, "is_training": True, "drop_remainder": True,
                           "global_batch_size": 512, "use_rand_aug": True},
            "validation_data": {**data, "is_training": False, "drop_remainder": False,
                                "global_batch_size": 256}},
        "trainer": {"checkpoint_interval": 5000, "max_to_keep": 32, "steps_per_loop": 1000,
                    "summary_interval": 1000, "train_steps": 6792, "validation_interval": 566,
                    "validation_steps": -1,
                    "optimizer_config": {
                        "polynomial": {"initial_learning_rate": 1.0e-05, "decay_steps": 6792},
                        "warmup": {"warmup_steps": 679}},
                    "best_checkpoint_export_subdir": "best_ckpt",
                    "best_checkpoint_eval_metric": "cls_accuracy",
                    "best_checkpoint_metric_comp": "higher"}}


def write_flickr_records(root: Path, seed: int = 0) -> dict:
    """Seeded Flickr30k-style image records and text records, a BERT-layout
    vocab file and the ``input_meta_data`` JSON; returns their paths."""
    import io

    from PIL import Image

    from mmt_tpu_torch.data.tfrecord import TFRecordWriter, build_example

    rng = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(CLI_WORDS)]
    vocab = (["[PAD]", "[ATT]", "[REF]", "[PATCH]"] + [f"[unused{i}]" for i in range(3, 99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"[unused{i}]" for i in range(99, 994)]
             + words)
    vocab += [f"##s{i}" for i in range(CLI_VOCAB_SIZE - len(vocab))]
    assert vocab.index("[unused99]") == 104 and len(vocab) == CLI_VOCAB_SIZE
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    with TFRecordWriter(str(root / "images.tfrecord")) as w:
        for i in range(CLI_IMAGES):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)).save(
                buf, format="PNG")
            w.write(build_example({"image_data": [buf.getvalue()],
                                   "image_key": [f"flickr{i}".encode()], "image_index": [i]}))
    with TFRecordWriter(str(root / "texts.tfrecord")) as w:
        for t in range(CLI_TEXTS):
            caption = " ".join(rng.choice(words, size=int(rng.integers(8, 25))))
            w.write(build_example({"caption": [caption.encode()], "text_index": [t],
                                   "gt_image_index": [t % CLI_IMAGES]}))
    meta = {"max_seq_length": CLI_SEQ,
            "test_image_input_path": str(root / "images.tfrecord"),
            "test_text_input_path": str(root / "texts.tfrecord"),
            "test_num_image_examples": CLI_IMAGES, "test_num_text_examples": CLI_TEXTS}
    (root / "meta.json").write_text(json.dumps(meta))
    return meta


def phase_predict_cli() -> int:
    """Records -> ``cli.predict.main`` -> results.csv + recall.json at full
    width; returns the forward kernel's launches in the CLI's run."""
    from mmt_tpu_torch.cli import predict as cli_predict
    from mmt_tpu_torch.configs import get_experiment_config, override
    from mmt_tpu_torch.data.loaders import MmtRetrievalLoader
    from mmt_tpu_torch.eval.predict import (MODEL_INPUT_KEYS, make_inference_step, predict,
                                            scores_from_logits)
    from mmt_tpu_torch.models import MmtClassificationModel
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        meta = write_flickr_records(root)
        experiment = flickr_experiment(str(root / "vocab.txt"))
        (root / "experiment.json").write_text(json.dumps(experiment))
        cfg = override(get_experiment_config("mmt/classification"), experiment)
        task = ClassificationTask(cfg.task, cfg.trainer, seed=4)
        CheckpointManager(str(root / "ckpt")).save(0, task.model)

        # The native data library is looked for (and, where it is missing,
        # built) once per process: before the clock, and reported apart.
        from mmt_tpu_torch.data import native

        t0 = time.perf_counter()
        native_available = native.available()
        native_s = time.perf_counter() - t0
        # The host part alone: records -> tokenizer -> batches.
        data_cfg = cli_predict.build_retrieval_data_config(cfg.task.train_data, meta, "test",
                                                           CLI_BATCH)
        t0 = time.perf_counter()
        batches = list(MmtRetrievalLoader(data_cfg).load())
        host_s = time.perf_counter() - t0

        reset_launch_counts()
        t0 = time.perf_counter()
        cli_predict.main([
            f"--config_file={root / 'experiment.json'}",
            f"--input_meta_data_path={root / 'meta.json'}", "--predict_split=test",
            f"--init_checkpoint={root / 'ckpt'}", f"--test_output_dir={root / 'out'}",
            f"--predict_global_batch_size={CLI_BATCH}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = launch_counts()
        rows = Path(root, "out", "results.csv").read_text().splitlines()
        recall = json.loads(Path(root, "out", "recall.json").read_text())

    num_pairs = CLI_IMAGES * CLI_TEXTS
    num_layers = cfg.task.model.encoder.mmt.num_hidden_layers
    if counts["fwd"] != num_layers * len(batches) or len(batches) != 5 \
            or any(v for k, v in counts.items() if k != "fwd"):
        raise AssertionError(f"launches {counts}, expected fwd = {num_layers} x 5 batches")
    if rows[0] != "image_index,text_index,gt_image_index,output" or len(rows) != 1 + num_pairs:
        raise AssertionError(f"results.csv: {len(rows)} lines, header {rows[0]!r}")
    keys = [f"{d} @ {k:>2}" for d in ("i2t", "t2i") for k in (1, 3, 5, 10)]
    if list(recall) != keys:
        raise AssertionError(f"recall.json keys {list(recall)}")
    table = np.asarray([[float(x) for x in r.split(",")] for r in rows[1:]])
    scores = table[:, 3]
    if not np.all(np.isfinite(scores)) or scores.min() < 0 or scores.max() > 1:
        raise AssertionError(f"bad scores: {scores}")
    pairs = {(int(i), int(t)) for i, t in table[:, :2]}
    if pairs != {(i, t) for i in range(CLI_IMAGES) for t in range(CLI_TEXTS)}:
        raise AssertionError("results.csv does not hold every (image, text) pair once")

    # The device part alone (batches -> scores), then the first batch
    # against the same weights with dense attention.
    step = make_inference_step(task.model)
    t0 = time.perf_counter()
    again = np.asarray([r.output for r in predict(step, batches)])
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    if np.abs(np.clip(again, 0, 1) - scores).max() > 1e-8 + 5e-9:  # the csv's 8 decimals
        raise AssertionError("the CLI's scores differ from the same model run again")
    dense_model = MmtClassificationModel(
        override(cfg, flickr_experiment("", "xla")).task.model,
        num_patch_per_row=data_cfg.num_patch_per_row)
    dense_model.load_state_dict(task.model.state_dict())
    inputs = {k: torch.as_tensor(np.asarray(batches[0][k])).cuda()
              for k in MODEL_INPUT_KEYS if k in batches[0]}
    with torch.inference_mode():
        fused_out, dense_out = task.model(**inputs), dense_model(**inputs)
    head = cfg.task.model.cls_heads[0]
    dense = scores_from_logits(dense_out["itm_logits"], head.num_classes).cpu().numpy()
    err = float(np.abs(dense - scores[:CLI_BATCH]).max())
    bound = 4 * 2.0 ** -8  # 4 bf16 spacings just below 1, the scores' upper end
    # With random weights every score lies within about 0.02 of the others,
    # so the scores say little.  Two closer readings of the same forward: the
    # ITM logits (4 bf16 spacings at the largest logit, as phase reference),
    # and the encoder's output on the real rows, whose elements vary by
    # about 1: per example ||fused - dense|| <= SEQUENCE_REL_BOUND ||dense||.
    logit_err = (fused_out["itm_logits"] - dense_out["itm_logits"]).abs().max().item()
    logit_scale = dense_out["itm_logits"].abs().max().item()
    logit_bound = 4 * 2.0 ** (math.floor(math.log2(logit_scale)) - 7)
    real = (torch.arange(CLI_SEQ, device="cuda")[None] < inputs["lengths"][:, None])[..., None]
    diff = ((fused_out["sequence_output"] - dense_out["sequence_output"]) * real).flatten(1)
    seq_err = (diff.norm(dim=1)
               / (dense_out["sequence_output"] * real).flatten(1).norm(dim=1)).max().item()

    # The forward kernel alone at this path's attention shape and the first
    # batch's lengths, without dropout, against its plain version.
    err_o, err_lse = kernel_errors(attention_inputs(batches[0]["lengths"].tolist(), seed=5,
                                                    seq_len=CLI_SEQ))
    emit({"phase": "predict_cli", "pairs": num_pairs, "batches": len(batches),
          "batch": CLI_BATCH, "seq_len": CLI_SEQ, "launches": counts["fwd"],
          "cli_seconds": cli_s, "host_seconds": host_s, "device_seconds": device_s,
          "pairs_per_s_cli": num_pairs / cli_s, "pairs_per_s_host": num_pairs / host_s,
          "pairs_per_s_device": num_pairs / device_s,
          "host_share": host_s / (host_s + device_s),
          "native_library": {"available": native_available, "lookup_seconds": native_s},
          "score_range": [float(scores.min()), float(scores.max())],
          "max_abs_err_vs_dense_first_batch": err, "bound": bound,
          "max_abs_err_itm_logits": logit_err, "logit_bound": logit_bound,
          "logit_scale": logit_scale, "max_rel_err_sequence_output": seq_err,
          "sequence_bound": SEQUENCE_REL_BOUND,
          "kernel_shape": [CLI_BATCH, CLI_SEQ, HEADS, HEAD_DIM], "max_abs_err_o": err_o,
          "o_bound": O_BOUND, "max_abs_err_lse": err_lse, "lse_bound": LSE_BOUND,
          "recall": recall})
    if not err <= bound:
        raise AssertionError(f"fused and dense scores differ by {err} > {bound}")
    if not logit_err <= logit_bound:
        raise AssertionError(f"fused and dense ITM logits differ by {logit_err} > {logit_bound}")
    if not seq_err <= SEQUENCE_REL_BOUND:
        raise AssertionError(f"fused and dense encoder outputs differ by {seq_err} of the "
                             f"dense norm > {SEQUENCE_REL_BOUND}")
    if not (err_o <= O_BOUND and err_lse <= LSE_BOUND):
        raise AssertionError(f"kernel disagrees with plain at {[CLI_BATCH, CLI_SEQ]}: "
                             f"o {err_o} lse {err_lse}")
    return counts["fwd"]


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
    phase_profile(model, batch)
    phase_reference(model, batch)
    del model, batch
    torch.cuda.empty_cache()
    entry["max_abs_err"] = max(entry["max_abs_err"], phase_kernel_dropout())
    bwd_entries = phase_kernel_bwd()
    task, cfg, train_launches = phase_train()
    # The forward runs on three main paths: retrieval (phase main),
    # pretraining (phase train) and the predict CLI (phase predict_cli,
    # added below); the backward on the second.
    entry["launches"] = launches + train_launches["fwd"]
    bwd_entries[0]["launches"] = train_launches["bwd_dq"]
    bwd_entries[1]["launches"] = train_launches["bwd_dkv"]
    phase_train_profile(task, cfg)
    del task
    torch.cuda.empty_cache()
    phase_train_reference()
    win_entry = phase_kernel_window()
    win_bwd_entries = phase_kernel_bwd_window()
    task, cfg, win_launches = phase_train_window()
    win_entry["launches"] = win_launches["fwd_window"]
    win_bwd_entries[0]["launches"] = win_launches["bwd_dq_window"]
    win_bwd_entries[1]["launches"] = win_launches["bwd_dkv_window"]
    phase_train_window_profile(task, cfg)
    del task
    torch.cuda.empty_cache()
    phase_train_window_reference()
    probe_entries = [*phase_probe_split(), *phase_probe_op_cost(), *phase_probe_hopper()]
    entry["launches"] += phase_predict_cli()
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    kernels = {"kernels": [entry, *bwd_entries, win_entry, *win_bwd_entries, *probe_entries]}
    print(json.dumps(kernels), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.jsonl").write_text("\n".join(_lines + [json.dumps(kernels)]) + "\n")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
