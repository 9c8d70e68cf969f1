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
   lengths ~ U[2048, 4096]) the kernel's time (CUDA events around the
   wrapper, and the kernel's profiler device time alone), the plain
   version's, the time of ``scaled_dot_product_attention`` handed the
   materialised bias (a yardstick the port never calls) and the bound;
   the same at the pretraining micro-batch (B=64, S=256, lengths ~ U[204,
   256], dropout 0.1), after its check against the plain version.
4. main: the full-width retrieval model (BERT-base geometry, L12/H768/A12,
   I3072, vocab 30522, fused attention, bf16, random weights from a seed)
   scores 8 images x 8 texts = 64 pairs at S=4096, batch 32, through
   ``eval.predict.predict`` and ``write_results``; the kernel's launch
   count must be 12 per forward.
5. profile: device time by kernel over one forward of that batch
   (``torch.profiler``), the device's idle share, and the forward
   kernel's device time per call there beside its time alone (phase 3),
   each with the 64 x 64 tiles its lengths give.
6. reference: the same model with dense attention on two of the pairs;
   the ITM logits must agree within 4 bf16 spacings.
7. kernel_dropout: the forward kernel with attention dropout 0.1 against
   the plain version with the same seed at the check lengths (the o / lse
   bounds of phase 3) and at the pretraining micro-batch (B=64, S=256),
   rate 0 bit-identical to the call without dropout at both, and the
   kernel's time at rate 0.1 against rate 0, at both shapes below.
8. kernel_bwd: the backward kernel against the plain backward at
   the flagship attention shape (B=32, S=4096, lengths ~ U[2048, 4096])
   and at the pretraining micro-batch (B=64, S=256, lengths ~ U[204,
   256]), each with dropout 0 and 0.1: max abs and relative errors of
   dq, dk, dv (bound: GRAD_REL_BOUND x the plain value's max) and dRel
   (DREL_REL_BOUND x its max, and DREL_ROW_BOUND x each id's own norm),
   the kernel's device time (profiler), the whole backward's time (CUDA
   events: the kernel, its buffers' zeroing, the dq cast and the dRel
   sum), the plain backward's, the bound, and the backward of
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
   forward + backward, the device's idle share, and the forward and
   backward kernels' device time per call inside the step beside their
   times alone in phases 3 and 8.
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
13. kernel_bwd_window: the backward kernel's windowed variant at the
   same shape and rates against the plain backward (the bounds of phase
   8); at window >= S dk and dv bit-identical to the dense kernel, dq
   within its bound (its fp32 adds come in a run-dependent order); the
   kernel's device time, the whole backward's, the plain version's,
   SDPA's backward with the same mask, and the bound.
14. train_window: the 4k sliding-window pretraining experiment
   (configs/exp_yamls/pretrain/wit/mlm_itm_2d_long4k_window.yaml, built in
   Python: the WIT model at S=4096 with window 512 and the image part
   global, MLM + ITM, dropout 0.1, remat on, global batch 256 as 32
   micro-batches of 8) takes WINDOW_STEPS optimizer steps on seeded
   synthetic batches (lengths ~ U[2048, 4096]) made on the card; every
   step's losses and accuracies must be finite; per micro-batch the
   windowed forward kernel must launch exactly 24 times (12 layers, each
   recomputed once by remat) and the windowed backward kernel 12 times,
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
   shape: far pass, structured pass, one-pass kernel (the production
   forward kernel, ``csrc/rel_attention_fwd.cu``), the share of far
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
21. int8: the flagship model of phase main in dynamic int8
   (``quantize="int8_dynamic"``: the 72 projection and FFN layers as
   ``ops.quant.Int8Linear``, the float state dict loaded unchanged) against
   the same weights in bf16, at the retrieval shape (S=4096, batch 32, the
   batches of phase main) and at the predict CLI's (S=256, batch 128,
   lengths ~ U[204, 256]): examples/s of each, INT8_ROUNDS passes in turns,
   the largest |ITM probability| difference (JAX's
   ``scripts/bench_suite.py`` measure), 12 forward-kernel launches per int8
   forward, and one full-shape ``Int8Linear`` call's int32 accumulator
   (``torch._int_mm``) bit-equal to the exact float64 product, with both
   products' times beside the bf16 matmul's.
22. export: the predict CLI's serving export at full width (the records,
   config and seeded checkpoint of phase predict_cli): ``cli.predict.main``
   with ``--export_serving_artifact`` (a static batch of 128: the config's
   attention is the fused op) and again with ``--export_bucket_sizes="1,
   8,32,"`` (a bundle), and the xla impl exported with a symbolic batch at
   batch 8; a fresh Python process that imports only
   ``mmt_tpu_torch.eval.export`` (and fails if ``mmt_tpu_torch.models`` was
   imported) loads all three and scores the CLI's first batch, bundle
   requests of 1, 5, 8 and 40 examples and xla calls at 3 and 17, and
   times the bucket-32 artifact; against the direct inference step on the
   same examples the scores must lie within 4 bf16 spacings (equality is
   expected), the artifact within 1% of the parameters' bytes, and the
   process must launch the forward kernel 12 times per fused call.
23. finetune: Flickr30k ITM finetuning at full width through
   ``mmt_tpu_torch.cli.train.main`` in train_and_eval: seeded paired records
   (512 for training, 4 steps' worth at 128 records a step, and 128 for
   validation; 224 x 224 PNG images, 5 captions of 8-24 words each), a
   seeded full-width WIT pretraining checkpoint written by the port's
   ``CheckpointManager`` as ``task.init_checkpoint``, and
   ``flickr_experiment`` with only the schedule cut (4 steps; validation and
   checkpoints every 2; one-step windows): global batch 512 in one step,
   RandAugment, dropout 0.1, validation at batch 256 with cls_accuracy,
   cls_loss and AUC-PR, best export on cls_accuracy.  The files the CLI
   writes, every number finite, ``count_restored`` = the encoder tensors the
   pretraining model has plus the itm head's, 12 forward and 12 backward
   launches per step and 12 forward launches per eval batch.  Then the run's
   directory copied and taken on to step 6 must resume at step 4 and end,
   per parameter tensor, within RESUME_SPREAD_FACTOR x the spread between
   two uninterrupted 6-step runs + RESUME_FLOOR_ULPS fp32 spacings of the
   first of them; and
   ``cli.predict`` on the finetuned checkpoint.  Reports examples/s and ms
   per step from the loop's one-step windows (the first step apart), the
   classification loader alone (records -> batches), eval examples/s and
   the peak memory.  The run's TensorBoard event files
   (``summaries/{train,validation}``, decoded by ``read_event_scalars``)
   must hold the jsonl summaries' scalars to float32.  Preemption: the
   6-step run as a ``python -m mmt_tpu_torch.cli.train`` process, saving
   every 5 steps, gets SIGTERM once its summaries show step 3; it must exit
   0 with a checkpoint and the stream's snapshot at the step k it logs, k
   not a regular checkpoint step (so the watcher made that save), and the same
   command run again must resume at k, finish, and end within the resume
   bound above; k, the seconds from the signal to the exit and the exit
   codes are reported.
24. finetune_profile: one B=512 training step under the profiler (device
   time by kernel group, idle share, the forward and backward kernels per
   call), and the two kernels at B=512, S=256 with the records' lengths and
   dropout 0.1: against their plain versions (the bounds of phases 3 and 8),
   alone, against SDPA handed the bias mask, and against the bound.
25. finetune_reference: the classification model's per-tensor gradients on
   2 examples of the records (positives weighted 2, attention dropout 0.1
   from the same seeds) with the kernels, with dense attention and with
   dense attention in float32: the kernels' relative error against float32
   may exceed dense attention's by at most TRAIN_GRAD_BOUND.
26. continuous: ``cli.train.main --mode=continuous_train_and_eval`` on the
   finetune yaml at CONT_STEPS steps a round, watching a pretraining
   directory that holds the seeded WIT checkpoint at step 0; once the first
   ``continuous_results.jsonl`` line is written, a helper thread saves a
   second one (step 1, another seed) with ``async_save``, and the CLI's
   watch (shortened through ``CONTINUOUS_TIMEOUT_S``) ends after the
   second round.  Two lines with ``pretrain_step`` 0 and 1 and finite
   ``cls_accuracy``, ``cls_loss`` and ``auc``, the finetune phase's
   ``count_restored`` in each round, and 12 forward launches per step and
   per eval batch and 12 backward launches per step.
27. checkpoint: ``CheckpointManager.save`` of the WIT pretraining model and
   its AdamW state, synchronous and asynchronous in turns (sync, async,
   async, sync): the bytes, the ms the caller is blocked and the ms until
   the checkpoint is durable; the restored tensors bit-equal to the saved
   ones.
28. grad_accum: one WIT pretraining step of 8 micro-batches of 64 (S=256,
   dropout 0.1, the same parameters, batch and seeds) with float32,
   bfloat16, and again bfloat16 with every micro-batch's float32 gradient
   recorded as the backward leaves it: that step's summed gradient equal,
   bit for bit, to the bf16 sum of the recorded gradients, and per tensor
   within 1e-2 of their float32 sum's norm (the same gradients, so the
   backward's run-to-run spread drops out); the losses equal within 1e-5
   relative (the same forward); the worst tensor and the card's peak
   memory of each run, 12 launches of each kernel per micro-batch.

29. pretrain_records: WIT pretraining from records through
   ``mmt_tpu_torch.cli.train.main --experiment=mmt/pretraining`` in
   train_and_eval: seeded WIT-style records (8 files of 512 for training,
   512 for validation; smooth PNG images at 256 x 192, 192 x 256 and
   300 x 200, 128 a file, resized to 224; ``canonical_doc_id``;
   attribution and reference captions of 8-40 words from the generated
   vocab) and ``wit_records_experiment``,
   configs/exp_yamls/pretrain/wit/mlm_itm_2d.yaml with only its schedule
   cut (global batch 4096 in micro-batches of 64, RandAugment, dropout 0.1;
   validation at the last step on 2 batches of 256).  Run twice: the loader
   in the training process (2 steps), and in N processes (``num_workers``,
   N from the host's cores and available memory, ``choose_workers``; N + 1
   steps, since the first N batches arrive together).  Per run: the time
   to the first batch (the shuffle buffers' fill), the first step, ms per
   steady step and examples/s, the loader's share of a steady step (the
   loop's ``input_seconds``: records -> batches in the training process,
   or the wait for the workers), the peak host memory in use and the card's
   peak, the validation metrics, 12 forward launches per micro-batch and
   per validation batch and 12 backward launches per micro-batch.  Then a
   profile of the loader's per-record work (``loader_profile``) and
   validation alone (records -> metrics).
30. pretrain_records_profile: one optimizer step of a 4096-row batch of
   the records (``profile_batch``) on the card under the profiler (device
   time by kernel group, idle share, the kernels per call) and the host's
   share of the runs' steady steps; the forward and backward kernels at a
   micro-batch's lengths (B=64, rate 0.1) and the forward at a validation
   batch's (B=256, rate 0) against their plain versions (the bounds of
   phases 3 and 8), SDPA and the bound.
31. pretrain_records_reference: a micro-batch of 64 rows of the records,
   kernels against dense attention: the loss within LOSS_REL_BOUND, the
   gradients by train_reference's rule, or, for a tensor outside it,
   finetune_reference's float32 rule; then one MLM + MPP + ITM batch at MPP
   0.5 from 224 x 224 records in host mode and in ``ship_raw_images`` mode
   (the encoder zeroes the masked patches): the MLM, MPP and ITM logits of
   the two modes against each other and against dense attention (ITM
   within 4 bf16 spacings, MLM and MPP within SEQUENCE_REL_BOUND of their
   norm).

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises, so the exit code is not 0 and no result is
printed; so does a machine without a CUDA device or a directory without
the ``mmt_tpu_torch`` package.
"""

from __future__ import annotations

import json
import logging
import math
import shutil
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
# The kernels' names in profiler traces (rel_attention_fwd.cu,
# rel_attention_bwd.cu).
FWD_KERNEL = "rel_attention_fwd_kernel"
BWD_KERNEL = "rel_attention_bwd_kernel"
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


def forward_work(lengths, seq_len, pairs=None):
    """(FLOPs, bytes) of one forward at these lengths: q.k^T and p.v over
    ``pairs`` query-key pairs (default: every real pair, sum of L**2) and
    q.R^T per real row; the real rows of q, k and v read once, every row of
    o and lse written once, the table and the lengths read."""
    L = np.asarray(lengths, np.float64)
    pairs = (L**2).sum() if pairs is None else pairs
    flops = 4 * pairs * HEAD_DIM * HEADS + 2 * L.sum() * REL_VOCAB * HEAD_DIM * HEADS
    row_bytes = HEADS * HEAD_DIM * 2
    nbytes = (3 * L.sum() * row_bytes + len(L) * seq_len * row_bytes + len(L) * HEADS * seq_len * 4
              + REL_VOCAB * HEADS * HEAD_DIM * 4 + len(L) * 4)
    return flops, nbytes


def dense_tiles(lengths) -> int:
    """64 x 64 tiles the dense forward computes at these lengths."""
    return int(sum((-(-int(n) // 64)) ** 2 for n in lengths))


def phase_kernel():
    """The forward kernel against its plain version at the check lengths
    and the retrieval batch; its times there and at the pretraining
    micro-batch (B=64, S=256, dropout 0.1), each beside the plain version,
    SDPA handed the bias mask and the bound.  Returns the ``kernels`` entry
    and, at both shapes, the kernel's profiler device ms alone with the
    tiles its lengths give."""
    from mmt_tpu_torch.ops import fused_attention as fa

    err_o, err_lse = kernel_errors(attention_inputs(CHECK_LENGTHS, seed=1))
    rng = np.random.default_rng(2)
    main_lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, BATCH).tolist()
    args = attention_inputs(main_lengths, seed=3)
    err_o_main, err_lse_main = kernel_errors(args)
    err_o, err_lse = max(err_o, err_o_main), max(err_lse, err_lse_main)
    if not (err_o <= O_BOUND and err_lse <= LSE_BOUND):
        raise AssertionError(f"kernel disagrees with plain: o {err_o} lse {err_lse}")

    call = lambda: fa.relative_attention_forward(*args)  # noqa: E731
    ms = cuda_ms(call, iters=10)
    kernel_ms = profile_kernel_ms(call, [FWD_KERNEL])[FWD_KERNEL]
    plain_ms = cuda_ms(lambda: fa.relative_attention_plain(*args), iters=2)
    library = sdpa_with_bias(*args)
    library_ms = cuda_ms(library, iters=5)
    del library, args
    torch.cuda.empty_cache()

    # The pretraining micro-batch: the shape of phase train's launches.
    seed = 20261
    targs = train_attention_inputs(seed=5)
    t_err_o, t_err_lse = kernel_errors(targs, DROPOUT, seed)
    if not (t_err_o <= O_BOUND and t_err_lse <= LSE_BOUND):
        raise AssertionError(f"kernel disagrees with plain at S={TRAIN_SEQ}: o {t_err_o} "
                             f"lse {t_err_lse}")
    t_call = lambda: fa.relative_attention_forward(*targs, "cuda", DROPOUT, seed)  # noqa: E731
    targs_lengths = targs[-1].tolist()
    t_flops, t_bytes = forward_work(targs_lengths, TRAIN_SEQ)
    train = {"rate": DROPOUT, "max_abs_err_o": t_err_o, "max_abs_err_lse": t_err_lse,
             "ms": cuda_ms(t_call, 50),
             "kernel_ms": profile_kernel_ms(t_call, [FWD_KERNEL], iters=20)[FWD_KERNEL],
             "plain_ms": cuda_ms(lambda: fa.relative_attention_plain(*targs, DROPOUT, seed), 5),
             "library_ms": cuda_ms(sdpa_with_bias(*targs), 20),
             "flops": t_flops, "bytes": t_bytes}
    train["bound_ms"], train["bound_by"] = bound_ms(t_flops, t_bytes)
    del targs

    flops, nbytes = forward_work(main_lengths, SEQ_LEN)
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
          "kernel_ms": kernel_ms,
          **{k: entry[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
          "train_micro_batch": {"shape": [TRAIN_MICRO, TRAIN_SEQ, HEADS, HEAD_DIM], **train}})
    alone = {"flagship": {"ms": kernel_ms, "tiles": dense_tiles(main_lengths)},
             "train": {"ms": train["kernel_ms"], "tiles": dense_tiles(targs_lengths)}}
    return entry, alone


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


def trace_summary(intervals, wall_ms, groups):
    """Device busy time (union of ``device_intervals``), idle share of
    ``wall_ms``, device ms per group (``groups``: name -> substrings of the
    kernel name, lowercased; the rest is "other") and the top kernels."""
    intervals = sorted(intervals, key=lambda x: x[1])
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


def kernel_calls_ms(intervals, name, expected, min_share=1.0):
    """Device ms per call of the kernel ``name`` in a trace that must hold
    ``expected`` calls of it, or at least ``min_share`` of them where the
    profiler may drop records."""
    calls = [end - start for n, start, end in intervals if name in n]
    if not expected * min_share <= len(calls) <= expected:
        raise AssertionError(f"{len(calls)} calls of {name} in the trace, expected {expected}")
    return sum(calls) / len(calls) / 1e3


def phase_profile(model, batch, fwd_alone) -> None:
    """Device time by kernel for one forward of the main path's batch, the
    share of the forward's wall time in which the card ran nothing, and the
    forward kernel's device ms per call there beside ``fwd_alone``, its
    time alone (phase kernel), each with the tiles its lengths give."""
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
    intervals = device_intervals(prof)
    per_call = kernel_calls_ms(intervals, FWD_KERNEL, model.config.encoder.mmt.num_hidden_layers)
    emit({"phase": "profile", **trace_summary(
        intervals, wall_ms, {"rel_attention_fwd": ("rel_attention_fwd",), "matmul": CUBLAS_TAGS}),
        "fwd_kernel_ms_per_call_in_step": per_call,
        "fwd_tiles_in_step": dense_tiles(batch["lengths"]), "fwd_kernel_alone": fwd_alone})


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
    """FLOPs of the whole backward at these lengths, over ``pairs``
    query-key pairs (default: every real pair, sum of L**2): q.k^T, do.v^T,
    ds.k, p^T.do, ds^T.q per pair, q.R^T, dsv.R, dsv^T.q per row."""
    L = np.asarray(lengths, np.float64)
    pairs = (L**2).sum() if pairs is None else pairs
    return 10 * pairs * HEAD_DIM * HEADS + 6 * L.sum() * vocab * HEAD_DIM * HEADS


def backward_bytes(lengths, seq_len):
    """Bytes of the whole backward: each input read once (the real rows of
    q, k, v, do, lse and delta, the table, the lengths), each output
    written once (all rows of dq / dk / dv in bf16, dRel summed)."""
    batch, real = len(lengths), float(np.sum(lengths))
    row = HEADS * HEAD_DIM * 2
    reads = 4 * real * row + 2 * real * HEADS * 4 + HEADS * 64 * HEAD_DIM * 2 + batch * 4
    return reads + 3 * batch * seq_len * row + REL_VOCAB * HEADS * HEAD_DIM * 4


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
            raise AssertionError(f"non-finite {name} from the backward kernel")
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
    """The backward kernel against the plain backward at two shapes, with
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
                entry["kernel_ms"] = profile_kernel_ms(call, [BWD_KERNEL])[BWD_KERNEL]
                entry["plain_ms"] = cuda_ms(
                    lambda: fa.relative_attention_backward_plain(*args, rate, seed), 2)
                if rate == 0.0 or shape_name == "train":
                    entry["library_ms"] = sdpa_backward_ms(q, k, v, table, geo, lengths,
                                                           5 if shape_name == "flagship" else 20)
            flops, nbytes = backward_flops(lens), backward_bytes(lens, q.shape[1])
            entry["bound_ms"], entry["bound_by"] = bound_ms(flops, nbytes)
            entry["flops"], entry["bytes"] = flops, nbytes
            results[f"{shape_name}_rate_{rate}"] = entry
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    emit({"phase": "kernel_bwd", "bound_rel": GRAD_REL_BOUND, "drel_bound_rel": DREL_REL_BOUND,
          "drel_row_bound": DREL_ROW_BOUND, "results": results})
    train = results[f"train_rate_{DROPOUT}"]
    return {
        "name": "rel_attention_bwd",
        "route": "cuda",
        "source": "mmt_tpu_torch/csrc/rel_attention_bwd.cu",
        "replaces": "mmt_tpu/ops/pallas_attention.py:2249 (_bwd_fused_kernel, K3), "
                    ":2100 (_bwd_dq_kernel, K5) and :2182 (_bwd_dkv_kernel, K5)",
        "launches": None,
        "max_abs_err": max(worst.values()),
        "ms": train["kernel_ms"],
        "plain_ms": train["plain_ms"],
        "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"],
        "library_ms": train["library_ms"],
    }


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
            "bwd": bwd.launches, "bwd_window": bwd.launches_window}


def reset_launch_counts() -> None:
    from mmt_tpu_torch.ops import fused_attention as fa

    fwd, bwd = fa.relative_attention_forward, fa.relative_attention_backward
    fwd.launches = fwd.launches_window = 0
    bwd.launches = bwd.launches_window = 0


def phase_train():
    """Three optimizer steps of WIT pretraining at full width through
    ``run_training``."""
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
    micro_per_step = TRAIN_GLOBAL // TRAIN_MICRO
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        run_training(train_step=task.make_train_step(cfg.trainer.micro_batch_size),
                     state=state, train_iter=batches, trainer=cfg.trainer,
                     model_dir=model_dir, seed=2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        summaries = [json.loads(l) for l in
                     Path(model_dir, "train_summaries.jsonl").read_text().splitlines()]
    counts = launch_counts()
    launches = {k: counts[k] for k in ("fwd", "bwd")}
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


def phase_train_profile(task, cfg, fwd_alone, bwd_alone_ms):
    """Device time by kernel group over one micro-batch forward+backward,
    and the forward and backward kernels' device ms per call there beside
    ``fwd_alone`` (with the tiles its lengths give) and ``bwd_alone_ms``,
    their times alone (phases kernel and kernel_bwd)."""
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
    intervals = device_intervals(prof)
    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    emit({"phase": "train_profile", "micro_batch": TRAIN_MICRO, **trace_summary(
        intervals, wall_ms, {"rel_attention_fwd": ("rel_attention_fwd",),
                             "rel_attention_bwd": ("rel_attention_bwd",), "cublas": CUBLAS_TAGS}),
        "fwd_kernel_ms_per_call_in_step": kernel_calls_ms(intervals, FWD_KERNEL, layers),
        "fwd_tiles_in_step": dense_tiles(batch["lengths"].tolist()),
        "fwd_kernel_alone": fwd_alone,
        "bwd_kernel_ms_per_call_in_step": kernel_calls_ms(intervals, BWD_KERNEL, layers),
        "bwd_kernel_ms_alone": bwd_alone_ms})


def gradient_errors(got, want):
    """Per parameter tensor ||got - want|| / ||want||: (the largest, its
    name, the number of tensors whose dense gradient is 0, every error)."""
    worst, worst_name, n_zero, errors = 0.0, "", 0, {}
    for name, g in got.items():
        ref = want[name]
        if g is None or ref is None:
            raise AssertionError(f"no gradient for {name}")
        # The key bias's exact gradient is 0 (softmax is invariant to adding
        # q . b_k to every logit of a row): both sides give rounding noise,
        # so it is measured against the same layer's query-bias gradient.
        scale_name = (name[: -len("key.bias")] + "query.bias"
                      if name.endswith("attention.key.bias") else name)
        ref_norm = want[scale_name].norm().item()
        if ref_norm == 0.0:
            n_zero += 1
            if g.norm().item() != 0.0:
                raise AssertionError(f"{name}: dense gradient is 0, kernel gradient is not")
            continue
        errors[name] = (g - ref).norm().item() / ref_norm
        if errors[name] > worst:
            worst, worst_name = errors[name], name
    return worst, worst_name, n_zero, errors


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
    worst, worst_name, n_zero, errors = gradient_errors(grads["pallas"], grads["xla"])
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


def live_tile_share(lengths, geo):
    """Share of the 64 x 64 tiles below each length that hold an allowed
    pair (the tiles the windowed kernels visit)."""
    from mmt_tpu_torch.ops.fused_attention import TILE, live_tiles

    live = total = 0
    for length in lengths:
        n = -(-length // TILE)
        total += n * n
        live += sum(len(live_tiles(r0, length, geo)) for r0 in range(0, n * TILE, TILE))
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
    flops, nbytes = forward_work(lens, WINDOW_SEQ, pairs)
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
          "live_tile_share": live_tile_share(lens, geo),
          "max_abs_err_o": err_o, "o_bound": O_BOUND, "max_abs_err_lse": err_lse,
          "lse_bound": LSE_BOUND, "window_ge_seq_bit_identical": True, "ms_by_rate": times,
          "flops": flops, "bytes": nbytes, "achieved_tflops": flops / ms / 1e9,
          **{k: entry[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    return entry


def phase_kernel_bwd_window():
    """The windowed backward kernel against the plain backward at the 4k
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
    flops, nbytes = backward_flops(lens, pairs=pairs), backward_bytes(lens, WINDOW_SEQ)
    bound, bound_by = bound_ms(flops, nbytes)
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
        # window >= S against the dense kernel: dk, dv bit-identical; dq
        # and dRel are summed by fp32 reductions in a run-dependent order.
        g_w = fa.relative_attention_backward(q, k, v, do, lse, delta, table, wide, lengths,
                                             "cuda", rate, seed)
        g_d = fa.relative_attention_backward(q, k, v, do, lse, delta, table, dense, lengths,
                                             "cuda", rate, seed)
        identical = [torch.equal(a, b) for a, b in zip(g_w[:3], g_d[:3])]
        if not (identical[1] and identical[2]):
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
            "kernel_ms": profile_kernel_ms(call, [BWD_KERNEL])[BWD_KERNEL],
            "plain_ms": cuda_ms(lambda: fa.relative_attention_backward_plain(*args, rate, seed),
                                2),
            "library_ms": sdpa_backward_ms(q, k, v, table, geo, lengths, 5),
        }
        torch.cuda.empty_cache()
    emit({"phase": "kernel_bwd_window", "shape": [WINDOW_MICRO, WINDOW_SEQ, HEADS, HEAD_DIM],
          "window": WINDOW, "num_global": WINDOW_NUM_GLOBAL, "allowed_real_pairs": pairs,
          "bound_rel": GRAD_REL_BOUND, "drel_bound_rel": DREL_REL_BOUND,
          "drel_row_bound": DREL_ROW_BOUND, "bound_ms": bound, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes, "results": results})
    main_rate = results[f"rate_{DROPOUT}"]
    return {
        "name": "rel_attention_bwd_window",
        "route": "cuda",
        "source": "mmt_tpu_torch/csrc/rel_attention_bwd.cu",
        "replaces": "mmt_tpu/ops/pallas_attention.py:2521 (_bwd_fused_list_kernel, K4), "
                    ":2373 (_bwd_dq_list_kernel, K6) and :2454 (_bwd_dkv_list_kernel, K6)",
        "launches": None,
        "max_abs_err": max(worst.values()),
        "ms": main_rate["kernel_ms"],
        "plain_ms": main_rate["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": main_rate["library_ms"],
    }


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
    micro_per_step = WINDOW_GLOBAL // WINDOW_MICRO
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        run_training(train_step=task.make_train_step(cfg.trainer.micro_batch_size),
                     state=state, train_iter=batches, trainer=cfg.trainer,
                     model_dir=model_dir, seed=22)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        summaries = [json.loads(l) for l in
                     Path(model_dir, "train_summaries.jsonl").read_text().splitlines()]
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    micro_batches = micro_per_step * WINDOW_STEPS
    expected = {"fwd": 0, "fwd_window": 2 * layers * micro_batches, "bwd": 0,
                "bwd_window": layers * micro_batches}
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
              "fwd_window": 2 * layers, "bwd_window": layers},
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
        device_intervals(prof), wall_ms,
        {"rel_attention_fwd": ("rel_attention_fwd",), "rel_attention_bwd": ("rel_attention_bwd",),
         "cublas": CUBLAS_TAGS})})


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
    worst, worst_name, _, errors = gradient_errors(grads["pallas"], grads["xla"])
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
          "one_pass_kernel": "mmt_tpu_torch/csrc/rel_attention_fwd.cu", **times, "far_pairs": far_pairs, "structured_pairs": struct_pairs,
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


CLI_WORD_LIST = [f"w{i:04d}" for i in range(CLI_WORDS)]


def write_flickr_vocab(root: Path) -> str:
    """The generated 30522-entry BERT-layout vocab as ``root/vocab.txt``."""
    vocab = (["[PAD]", "[ATT]", "[REF]", "[PATCH]"] + [f"[unused{i}]" for i in range(3, 99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"[unused{i}]" for i in range(99, 994)]
             + CLI_WORD_LIST)
    vocab += [f"##s{i}" for i in range(CLI_VOCAB_SIZE - len(vocab))]
    assert vocab.index("[unused99]") == 104 and len(vocab) == CLI_VOCAB_SIZE
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return str(root / "vocab.txt")


def write_flickr_records(root: Path, seed: int = 0) -> dict:
    """Seeded Flickr30k-style image records and text records, a BERT-layout
    vocab file and the ``input_meta_data`` JSON; returns their paths."""
    import io

    from PIL import Image

    from mmt_tpu_torch.data.tfrecord import TFRecordWriter, build_example

    rng = np.random.default_rng(seed)
    words = CLI_WORD_LIST
    write_flickr_vocab(root)
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



# ------------------------------------------------------------------- int8

INT8_CLI_LENGTHS = (TRAIN_MIN_LEN, CLI_SEQ)  # the predict CLI's lengths ~ U[204, 256]
# Repeats of each model's timed pass over its batches; the two models in turns.
INT8_ROUNDS = 2
SCORE_BOUND = 4 * 2.0 ** -8  # 4 bf16 spacings just below 1, the scores' upper end


def int8_config(quantize: str):
    """The flagship model of phase main with ``quantize``."""
    import dataclasses

    cfg = flagship_config("pallas")
    enc = dataclasses.replace(cfg.encoder.mmt, quantize=quantize)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, mmt=enc))


def cli_shape_batches(seed: int = 6, count: int = 2):
    """``count`` batches at the predict CLI's shape (B=128, S=256, the 196
    patches and text, lengths ~ U[204, 256])."""
    rng = np.random.default_rng(seed)
    segment = np.where(np.arange(CLI_SEQ) < NUM_PATCHES + 2, 1, 2).astype(np.int32)
    return [dict(
        word_ids=rng.integers(0, 30000, (CLI_BATCH, CLI_SEQ)).astype(np.int32),
        segment_ids=np.broadcast_to(segment, (CLI_BATCH, CLI_SEQ)).copy(),
        patch_embeddings=rng.standard_normal((CLI_BATCH, NUM_PATCHES, PATCH_DIM), np.float32),
        lengths=rng.integers(INT8_CLI_LENGTHS[0], INT8_CLI_LENGTHS[1] + 1,
                             CLI_BATCH).astype(np.int32)) for _ in range(count)]


def accumulator_check(model, batch) -> dict:
    """One full-shape ``Int8Linear`` call of ``model`` (layer 0's FFN input
    projection, captured by a hook on ``batch``): its int32 accumulator
    from ``torch._int_mm`` against the exact plain product, bit for bit."""
    from mmt_tpu_torch.ops import quant

    from mmt_tpu_torch.eval.predict import MODEL_INPUT_KEYS

    layer = model.encoder.transformer.layers[0].intermediate
    seen = {}

    def keep_input(module, args):
        seen.setdefault("x", args[0])  # returns None: the call's arguments stay

    hook = layer.register_forward_pre_hook(keep_input)
    try:
        with torch.inference_mode():
            model(**{k: torch.as_tensor(batch[k]).cuda() for k in MODEL_INPUT_KEYS if k in batch})
    finally:
        hook.remove()
    with torch.inference_mode():
        x_q, _ = quant.dynamic_quantize_activations(seen["x"])
        w_q, _ = quant.quantize_symmetric(layer.weight, contracting_dims=(1,))
        a = x_q.reshape(-1, x_q.shape[-1])
        got, want = quant.int8_matmul(a, w_q), quant.int8_matmul_plain(a, w_q)
        equal = bool(torch.equal(got, want))
        ms = cuda_ms(lambda: quant.int8_matmul(a, w_q), iters=10)
        plain_ms = cuda_ms(lambda: quant.int8_matmul_plain(a, w_q), iters=2)
        bf16 = seen["x"].reshape(a.shape).to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: bf16 @ layer.weight.to(torch.bfloat16).t(), iters=10)
    out = {"shape": [a.shape[0], a.shape[1], w_q.shape[0]], "equal": equal,
           "max_abs_diff": int((got.long() - want.long()).abs().max()),
           "int_mm_ms": ms, "plain_ms": plain_ms, "bf16_matmul_ms": bf16_ms}
    del seen, a, got, want, bf16
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"int8 accumulator differs from the exact product: {out}")
    return out


def timed_scores(model, batches):
    """(seconds, scores) of ``eval.predict``'s inference step over
    ``batches``, ended by a synchronise."""
    from mmt_tpu_torch.eval.predict import make_inference_step

    step = make_inference_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = torch.cat([step(b) for b in batches])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, scores


def int8_shape(name, fp, q, batches) -> dict:
    """bf16 and int8 at one shape: examples/s in turns (the int8 passes'
    launches counted alone), the largest ITM probability difference,
    the accumulator check."""
    for model in (fp, q):  # warm-up: cuBLAS handles, allocator
        timed_scores(model, batches[:1])
    examples = sum(len(b["lengths"]) for b in batches)
    fp_s, q_s, launches = [], [], 0
    for _ in range(INT8_ROUNDS):
        seconds, fp_scores = timed_scores(fp, batches)
        fp_s.append(seconds)
        reset_launch_counts()
        seconds, q_scores = timed_scores(q, batches)
        counts = launch_counts()
        q_s.append(seconds)
        if counts["fwd"] != 12 * len(batches) or any(v for k, v in counts.items() if k != "fwd"):
            raise AssertionError(f"int8 {name}: launches {counts}, expected 12 x {len(batches)}")
        launches += counts["fwd"]
    diff = float((q_scores - fp_scores).abs().max())
    if not (torch.isfinite(q_scores).all() and 0 <= q_scores.min() and q_scores.max() <= 1):
        raise AssertionError(f"int8 {name}: bad scores {q_scores}")
    fp_eps, q_eps = [examples / s for s in fp_s], [examples / s for s in q_s]
    return {"shape": [len(batches[0]["lengths"]), batches[0]["word_ids"].shape[1]],
            "forwards": len(batches), "examples": examples,
            "examples_per_s_bf16": fp_eps, "examples_per_s_int8": q_eps,
            "int8_over_bf16": float(np.median(q_eps) / np.median(fp_eps)),
            "max_abs_itm_prob_diff": diff, "launches_per_forward": 12,
            "launches": launches, "accumulator": accumulator_check(q, batches[0])}


def phase_int8() -> int:
    """The flagship model in dynamic int8 against bf16 at the retrieval
    shape (S=4096, batch 32) and at the predict CLI's (S=256, batch 128);
    returns the forward kernel's launches in the int8 passes."""
    from mmt_tpu_torch.models import MmtClassificationModel
    from mmt_tpu_torch.ops import quant

    fp = MmtClassificationModel(int8_config("none"))
    q = MmtClassificationModel(int8_config("int8_dynamic"))
    q.load_state_dict(fp.state_dict())  # the float checkpoint, unchanged
    linears = sum(isinstance(m, quant.Int8Linear) for m in q.modules())
    if linears != 6 * 12:
        raise AssertionError(f"{linears} Int8Linear layers, expected 72")
    flagship = int8_shape("retrieval", fp, q, retrieval_batches())
    cli = int8_shape("predict_cli", fp, q, cli_shape_batches())
    emit({"phase": "int8", "int8_linear_layers": linears, "retrieval": flagship,
          "predict_cli_shape": cli})
    del fp, q
    torch.cuda.empty_cache()
    return flagship["launches"] + cli["launches"]


# ----------------------------------------------------------------- export

EXPORT_REQUESTS = (1, 5, 8, 40)  # examples per bundle request
EXPORT_BUCKETS = "1, 8,32,"  # as a user might type it
EXPORT_XLA_BATCH, EXPORT_XLA_CALLS = 8, (3, 17)
EXPORT_TIMED_CALLS = 10

# The serving process: imports the export module alone, loads the static
# artifact, the bundle and the xla artifact, scores, times the bundle's
# calls of 32 examples (its bucket-32 artifact, host clock, the scores
# copied back) and prints one JSON line.
EXPORT_SERVER = r"""
import json, sys, time
import numpy as np, torch
from mmt_tpu_torch.eval.export import load_scoring, load_scoring_bundle
from mmt_tpu_torch.ops import fused_attention as fa

root = sys.argv[1]
params = torch.load(root + "/params.pt", map_location="cuda")
first = dict(np.load(root + "/first.npz"))
out = {}
t0 = time.perf_counter()
static = load_scoring(open(root + "/artifact.pt2", "rb").read())
bundle = load_scoring_bundle(open(root + "/bundle.zip", "rb").read())
xla = load_scoring(open(root + "/xla.pt2", "rb").read())
out["load_seconds"] = time.perf_counter() - t0
out["static"] = static.call(params, first).float().cpu().tolist()
out["bundle"] = {n: bundle.call(params, {k: v[:n] for k, v in first.items()}).tolist()
                 for n in json.loads(sys.argv[2])}
out["xla"] = {n: xla.call(params, {k: v[:n] for k, v in first.items()}).float().cpu().tolist()
              for n in json.loads(sys.argv[3])}
b32 = {k: v[:32] for k, v in first.items()}
bundle.call(params, b32)
t0 = time.perf_counter()
for _ in range(int(sys.argv[4])):
    bundle.call(params, b32)  # the bucket-32 artifact; scores back on the host
out["bucket32_ms"] = (time.perf_counter() - t0) / int(sys.argv[4]) * 1e3
out["launches"] = fa.relative_attention_forward.launches
out["launches_window"] = fa.relative_attention_forward.launches_window
out["model_modules"] = sorted(m for m in sys.modules if m.startswith("mmt_tpu_torch.models"))
print(json.dumps(out))
sys.exit(1 if out["model_modules"] else 0)
"""


def phase_export() -> int:
    """The predict CLI's serving export at full width (S=256, batch 128,
    fused attention): a static-batch artifact and a bucket bundle through
    ``cli.predict.main``, an xla artifact with a symbolic batch, all loaded
    and called in a fresh process that never imports the model code, held
    against the direct inference step.  Returns the forward kernel's
    launches in that process."""
    from mmt_tpu_torch.cli import predict as cli_predict
    from mmt_tpu_torch.configs import get_experiment_config, override
    from mmt_tpu_torch.data.loaders import MmtRetrievalLoader
    from mmt_tpu_torch.eval import export
    from mmt_tpu_torch.eval.predict import MODEL_INPUT_KEYS, make_inference_step
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
        params = task.model.state_dict()
        torch.save(params, root / "params.pt")
        param_bytes = sum(v.numel() * v.element_size() for v in params.values())
        data_cfg = cli_predict.build_retrieval_data_config(cfg.task.train_data, meta, "test",
                                                           CLI_BATCH)
        first = next(iter(MmtRetrievalLoader(data_cfg).load()))
        first = {k: np.asarray(first[k]) for k in MODEL_INPUT_KEYS if k in first}
        np.savez(root / "first.npz", **first)

        argv = [f"--config_file={root / 'experiment.json'}",
                f"--input_meta_data_path={root / 'meta.json'}", "--predict_split=test",
                f"--init_checkpoint={root / 'ckpt'}", f"--test_output_dir={root / 'out'}",
                f"--predict_global_batch_size={CLI_BATCH}"]
        seconds = {}
        t0 = time.perf_counter()
        cli_predict.main(argv + [f"--export_serving_artifact={root / 'artifact.pt2'}"])
        seconds["cli_static"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_predict.main(argv + [f"--export_serving_artifact={root / 'bundle.zip'}",
                                 f"--export_bucket_sizes={EXPORT_BUCKETS}"])
        seconds["cli_bundle"] = time.perf_counter() - t0
        if Path(root, "out", "results.csv").exists():
            raise AssertionError("the export runs scored the pairs")
        xla_task = ClassificationTask(
            override(cfg, flickr_experiment("", "xla")).task, cfg.trainer, seed=4)
        xla_task.model.load_state_dict(params)
        t0 = time.perf_counter()
        (root / "xla.pt2").write_bytes(export.export_scoring(
            xla_task, params, {k: v[:EXPORT_XLA_BATCH] for k, v in first.items()}))
        seconds["xla"] = time.perf_counter() - t0
        sizes = {name: Path(root, name).stat().st_size
                 for name in ("artifact.pt2", "bundle.zip", "xla.pt2")}

        reset_launch_counts()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_SERVER, str(root), json.dumps(EXPORT_REQUESTS),
             json.dumps(EXPORT_XLA_CALLS), str(EXPORT_TIMED_CALLS)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        seconds["server"] = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"the serving process failed ({proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])

    # The direct inference step on the same examples, in this process.
    step, xla_step = make_inference_step(task.model), make_inference_step(xla_task.model)
    errors = {"static": float(np.abs(np.asarray(served["static"])
                                     - step(first).float().cpu().numpy()).max())}
    for n in EXPORT_REQUESTS:
        want = step({k: v[:n] for k, v in first.items()}).float().cpu().numpy()
        errors[f"bundle_{n}"] = float(np.abs(np.asarray(served["bundle"][str(n)]) - want).max())
    for n in EXPORT_XLA_CALLS:
        want = xla_step({k: v[:n] for k, v in first.items()}).float().cpu().numpy()
        errors[f"xla_{n}"] = float(np.abs(np.asarray(served["xla"][str(n)]) - want).max())
    b32 = {k: v[:32] for k, v in first.items()}
    step(b32).cpu()
    t0 = time.perf_counter()
    for _ in range(EXPORT_TIMED_CALLS):
        step(b32).cpu()  # as the bundle's call: scores back on the host
    eager32_ms = (time.perf_counter() - t0) / EXPORT_TIMED_CALLS * 1e3
    # Fused-attention calls in the serving process: the static artifact
    # once, the bundle once per chunk (1, 8, 8, 32 + 8), the bucket-32
    # artifact 1 + EXPORT_TIMED_CALLS times; 12 layers each.
    calls = 1 + 5 + 1 + EXPORT_TIMED_CALLS
    emit({"phase": "export", "batch": CLI_BATCH, "seq_len": CLI_SEQ,
          "buckets": EXPORT_BUCKETS, "requests": list(EXPORT_REQUESTS),
          "xla_export_batch": EXPORT_XLA_BATCH, "xla_calls": list(EXPORT_XLA_CALLS),
          "bytes": sizes, "param_bytes": param_bytes,
          "artifact_share_of_params": sizes["artifact.pt2"] / param_bytes,
          "max_abs_err": errors, "bound": SCORE_BOUND,
          "bucket32_ms": served["bucket32_ms"], "eager32_ms": eager32_ms,
          "load_seconds": served["load_seconds"], "seconds": seconds,
          "launches": served["launches"], "expected_launches": 12 * calls})
    if served["launches"] != 12 * calls or served["launches_window"]:
        raise AssertionError(f"{served['launches']} launches in the serving process, "
                             f"expected 12 x {calls}")
    if not max(errors.values()) <= SCORE_BOUND:
        raise AssertionError(f"served scores differ from the inference step: {errors}")
    if not sizes["artifact.pt2"] <= 0.01 * param_bytes:
        raise AssertionError(f"the artifact holds {sizes['artifact.pt2']} bytes, over 1% "
                             f"of the {param_bytes} parameter bytes")
    del task, xla_task
    torch.cuda.empty_cache()
    return served["launches"]


# ---------------------------------------------------------------- finetune

# Flickr30k ITM finetuning (configs/exp_yamls/finetune/flickr30k/
# itm_2d_from_vit.yaml): global batch 512 in one step (128 records at
# negative_positive_ratio 3), validation at batch 256.
FT_GLOBAL, FT_EVAL_BATCH, FT_RATIO = 512, 256, 3
FT_CAPTIONS_PER_IMAGE = 5
FT_TRAIN_RECORDS, FT_VAL_RECORDS = 512, 128  # 4 steps' worth; 2 eval batches
FT_STEPS, FT_RESUME_STEPS = 4, 6
FT_POS_WEIGHT = 2.0  # finetune_reference's positives (the yaml's pos_weight is 1)
# A resumed run on the card against the uninterrupted one, per parameter
# tensor: ||B - C|| <= RESUME_SPREAD_FACTOR x ||D - C|| for a second
# uninterrupted run D (the backward's run-to-run spread) + RESUME_FLOOR_ULPS
# x ||spacing(C)||, the norm of C's elementwise fp32 spacings, for the
# rounding flips of a tensor on which D happens to equal C (one flip in a
# 2-element head bias can be 1.2e-7 of its norm).  The floor, ~1.8e-7 of a
# large tensor's norm, stays below what a resume that drew other dropout masks or
# batches gives (updates of ~lr = 1e-7 per element, ~1e-6 of a tensor's norm).
RESUME_SPREAD_FACTOR, RESUME_FLOOR_ULPS = 4.0, 2.0
# Seconds a preempted CLI process may take to reach its signal step, to
# exit, or to run again.
PREEMPT_WAIT_S = 600.0
# The preempted run saves every PREEMPT_CKPT_INTERVAL steps and is signalled
# once its summaries show PREEMPT_AT_STEP: it stops at step 3 or 4, neither
# a regular checkpoint step, so the save it resumes from is the watcher's own.
PREEMPT_AT_STEP, PREEMPT_CKPT_INTERVAL = 3, 5


def write_paired_flickr_records(path: Path, n: int, seed: int) -> str:
    """Seeded Flickr30k-style paired records: ``image_data`` (224 x 224 PNG,
    one image per 5 captions, 28 x 28 random blocks scaled up 8x),
    ``image_key`` and a caption of 8-24 words."""
    import io

    from PIL import Image

    from mmt_tpu_torch.data.tfrecord import TFRecordWriter, build_example

    rng = np.random.default_rng(seed)
    with TFRecordWriter(str(path)) as w:
        for i in range(n):
            if i % FT_CAPTIONS_PER_IMAGE == 0:
                blocks = rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)
                buf = io.BytesIO()
                Image.fromarray(blocks.repeat(8, 0).repeat(8, 1)).save(buf, format="PNG")
                image = buf.getvalue()
            caption = " ".join(rng.choice(CLI_WORD_LIST, size=int(rng.integers(8, 25))))
            w.write(build_example({"image_data": [image],
                                   "image_key": [f"flickr{seed}_{i // FT_CAPTIONS_PER_IMAGE}"
                                                 .encode()],
                                   "caption": [caption.encode()]}))
    return str(path)


def finetune_experiment(root: Path, init_checkpoint: str, train_steps: int,
                        checkpoint_interval: int = 2) -> Path:
    """The Flickr30k yaml (``flickr_experiment``) with its placeholders
    filled and only its schedule cut, written as JSON text."""
    experiment = flickr_experiment(str(root / "vocab.txt"))
    experiment["task"]["init_checkpoint"] = init_checkpoint
    experiment["task"]["train_data"]["input_path"] = str(root / "train.tfrecord")
    experiment["task"]["validation_data"]["input_path"] = str(root / "val.tfrecord")
    experiment["trainer"].update({"train_steps": train_steps, "validation_interval": 2,
                                  "checkpoint_interval": checkpoint_interval,
                                  "steps_per_loop": 1,
                                  "summary_interval": 1})
    path = root / f"finetune_{train_steps}_{checkpoint_interval}.json"
    path.write_text(json.dumps(experiment))
    return path


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_train_cli(config: Path, model_dir: Path, experiment="mmt/classification",
                  mode="train_and_eval", extra=()) -> list:
    """``cli.train.main`` (default in train_and_eval); returns its log lines."""
    from mmt_tpu_torch.cli import train as cli_train

    handler = _LogLines()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        state = cli_train.main([f"--experiment={experiment}", f"--mode={mode}",
                                f"--model_dir={model_dir}", f"--config_file={config}", *extra])
        torch.cuda.synchronize()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    del state
    torch.cuda.empty_cache()
    return handler.lines


def read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def link_copy(src: Path, dst: Path) -> None:
    """A copy of a model directory whose checkpoint files are hard links
    (never rewritten in place); the rest is copied."""
    import os
    import shutil

    def copy(a, b):
        return os.link(a, b) if a.endswith(".pt") else shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=copy)


def finetune_params(model_dir: Path, step: int) -> dict:
    from mmt_tpu_torch.train.checkpoint import CheckpointManager

    return {k: v for k, v in CheckpointManager(str(model_dir)).restore(step).items()
            if v.is_floating_point()}


def read_event_scalars(path: Path) -> list:
    """``[(step, {tag: value})]`` of the scalar Events of a TensorBoard
    event file (``utils/tb_events.py``'s format), decoded with the port's
    TFRecord reader; the first record must be the file version."""
    import struct

    from mmt_tpu_torch.data.tfrecord import TFRecordReader, _read_varint

    def fields(buf):
        out, pos = [], 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            wire = key & 7
            if wire == 0:
                value, pos = _read_varint(buf, pos)
            elif wire in (1, 5):
                n = 8 if wire == 1 else 4
                value, pos = buf[pos:pos + n], pos + n
            else:
                n, pos = _read_varint(buf, pos)
                value, pos = buf[pos:pos + n], pos + n
            out.append((key >> 3, value))
        return out

    records = list(TFRecordReader(str(path), check_crc=True))
    if dict(fields(records[0])).get(3) != b"brain.Event:2":
        raise AssertionError(f"{path}: the first record is not the file version")
    events = []
    for record in records[1:]:
        event = dict(fields(record))
        tags = {}
        for _, value in fields(event.get(5, b"")):
            v = dict(fields(value))
            tags[v[1].decode()] = struct.unpack("<f", v[2])[0]
        events.append((event.get(2, 0), tags))
    return events


def check_event_files(model_dir: Path, name: str, lines: list) -> None:
    """``<model_dir>/summaries/<name>`` holds one event file whose scalars
    are the jsonl summaries ``lines``, to float32."""
    files = sorted((model_dir / "summaries" / name).glob("events.out.tfevents.*"))
    if len(files) != 1:
        raise AssertionError(f"summaries/{name} holds {len(files)} event files")
    want = [(l["step"], {k: float(np.float32(v)) for k, v in l.items() if k != "step"})
            for l in lines]
    got = read_event_scalars(files[0])
    if got != want:
        raise AssertionError(f"summaries/{name} events {got[:2]} != the jsonl {want[:2]}")


def preempt_cli(command: list, model_dir: Path, log_path: Path, at_step: int) -> dict:
    """Runs ``command`` (a train CLI process) until its
    ``train_summaries.jsonl`` shows ``at_step``, sends it SIGTERM and waits
    for its exit: the exit code, the preempted step from its log and the
    seconds from the signal to the exit."""
    import signal

    summaries = model_dir / "train_summaries.jsonl"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(command, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            deadline = time.monotonic() + PREEMPT_WAIT_S
            while f'"step": {at_step},' not in (summaries.read_text() if summaries.exists()
                                                else ""):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"the run ended or stalled before step {at_step}: "
                                         f"{log_path.read_text()[-3000:]}")
                time.sleep(0.05)
            t_signal = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=PREEMPT_WAIT_S)
            exit_s = time.perf_counter() - t_signal
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    steps = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
             if "exiting after preemption checkpoint at step" in line]
    if code != 0 or len(steps) != 1:
        raise AssertionError(f"preempted run exited {code}, preemptions {steps}: {text[-3000:]}")
    return {"exit_code": code, "step": steps[0], "signal_to_exit_seconds": exit_s}


def fp32_spacing(t: torch.Tensor) -> torch.Tensor:
    """The distance from each element of ``t`` to the next float32 away
    from zero."""
    a = t.float().abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def resume_errors(resumed: dict, whole: list) -> dict:
    """Per parameter tensor, ``resumed``'s relative error against the first
    uninterrupted run beside the second's (the run-to-run spread): the
    largest, the tensors outside RESUME_SPREAD_FACTOR x spread +
    RESUME_FLOOR_ULPS fp32 spacings (each with its error, spread and
    floor), and the whole model's."""
    errors, spread, failing = {}, {}, {}
    for name, ref in whole[0].items():
        norm = ref.norm().item()
        errors[name] = (resumed[name] - ref).norm().item() / norm
        spread[name] = (whole[1][name] - ref).norm().item() / norm
        floor = RESUME_FLOOR_ULPS * fp32_spacing(ref).norm().item() / norm
        if not errors[name] <= RESUME_SPREAD_FACTOR * spread[name] + floor:
            failing[name] = {"err": errors[name], "spread": spread[name], "floor": floor}
    total = math.sqrt(sum(float((resumed[n] - r).double().square().sum()) for n, r in
                          whole[0].items()))
    total_spread = math.sqrt(sum(float((whole[1][n] - r).double().square().sum()) for n, r in
                                 whole[0].items()))
    ref_norm = math.sqrt(sum(float(r.double().square().sum()) for r in whole[0].values()))
    return {"bound": f"{RESUME_SPREAD_FACTOR} x spread + {RESUME_FLOOR_ULPS} fp32 spacings",
            "max_rel_err": max(errors.values()), "worst_tensor": max(errors, key=errors.get),
            "max_spread": max(spread.values()),
            "tensors_with_spread": sum(v > 0 for v in spread.values()),
            "tensors_with_err": sum(v > 0 for v in errors.values()),
            "whole_model_rel_err": total / ref_norm,
            "whole_model_rel_spread": total_spread / ref_norm,
            "failing": dict(list(failing.items())[:5])}


def phase_finetune(root: Path):
    """Flickr30k ITM finetuning at full width through ``cli.train.main``
    (train_and_eval, warm start from a pretraining checkpoint), its files,
    numbers and launches; a resume held against uninterrupted runs; the
    loader and eval rates; ``cli.predict`` on the finetuned checkpoint.
    Returns the forward / backward launches of the run, a batch of the
    records and the classification task holding the finetuned weights."""
    import shutil

    from mmt_tpu_torch.cli import predict as cli_predict
    from mmt_tpu_torch.cli.train import build_experiment_config, make_eval_fn, parse_args
    from mmt_tpu_torch.data.loaders import MmtClassificationLoader
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask, PretrainingTask
    from mmt_tpu_torch.train.train_state import TrainState

    t_setup = time.perf_counter()
    meta = write_flickr_records(root)  # the predict pool and the vocab
    write_paired_flickr_records(root / "train.tfrecord", FT_TRAIN_RECORDS, seed=1)
    write_paired_flickr_records(root / "val.tfrecord", FT_VAL_RECORDS, seed=2)
    (root / "meta.json").write_text(json.dumps(meta))
    pre_cfg = pretrain_experiment()
    pretrain = PretrainingTask(pre_cfg.task, pre_cfg.trainer, device="cuda", seed=11)
    CheckpointManager(str(root / "pretrain")).save(0, pretrain.model)
    pretrain_names = set(pretrain.model.state_dict())
    del pretrain
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t_setup

    config = finetune_experiment(root, str(root / "pretrain"), FT_STEPS)
    cfg = build_experiment_config(parse_args([
        "--experiment=mmt/classification", "--model_dir=unused", f"--config_file={config}"]))
    layers = cfg.task.model.encoder.mmt.num_hidden_layers

    # Records -> batches alone (RandAugment on): the shuffle buffer's fill
    # (4096 rows), then steady batches.
    stream = MmtClassificationLoader(cfg.task.train_data).stream()
    t0 = time.perf_counter()
    batch = next(stream)
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(2):
        next(stream)
    loader_s = time.perf_counter() - t0
    del stream

    # The run: 4 steps, validation and checkpoints at 2 and 4.
    run_a = root / "ft"
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log = run_train_cli(config, run_a)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts()
    for name in ("params.yaml", "train_summaries.jsonl", "validation_summaries.jsonl", "2", "4",
                 "best_ckpt/best_info.json", "data_stream"):
        if not (run_a / name).exists():
            raise AssertionError(f"the finetune run wrote no {name}")
    train_log = read_jsonl(run_a / "train_summaries.jsonl")
    val_log = read_jsonl(run_a / "validation_summaries.jsonl")
    best_info = json.loads((run_a / "best_ckpt" / "best_info.json").read_text())
    if [r["step"] for r in train_log] != list(range(1, FT_STEPS + 1)) \
            or [r["step"] for r in val_log] != [2, 4]:
        raise AssertionError(f"summaries at steps {[r['step'] for r in train_log]}, "
                             f"{[r['step'] for r in val_log]}")
    if not all(k in r for r in val_log for k in ("cls_accuracy", "cls_loss", "auc")):
        raise AssertionError(f"validation summaries lack a metric: {val_log}")
    if not all(math.isfinite(v) for r in train_log + val_log for v in r.values()):
        raise AssertionError(f"non-finite finetune numbers: {train_log} {val_log}")
    check_event_files(run_a, "train", train_log)
    check_event_files(run_a, "validation", val_log)
    # The warm start takes every encoder tensor the pretraining model has
    # and the itm head; the rest (the absolute position table, which the
    # WIT pretraining model has not) keeps its fresh initialisation.
    finetuned = CheckpointManager(str(run_a)).restore(FT_STEPS)
    restorable = [n for n in finetuned
                  if n.startswith(("encoder.", "cls_heads.itm.")) and n in pretrain_names]
    fresh = sorted(set(finetuned) - set(restorable))
    restored = [int(line.split("count_restored=")[1].split()[0])
                for line in log if "count_restored=" in line]
    if restored != [len(restorable)]:
        raise AssertionError(f"count_restored {restored}, expected [{len(restorable)}]")
    eval_batches = 2 * math.ceil(FT_VAL_RECORDS / (FT_EVAL_BATCH // (FT_RATIO + 1)))
    expected = {"fwd": layers * (FT_STEPS + eval_batches), "fwd_window": 0,
                "bwd": layers * FT_STEPS, "bwd_window": 0}
    if counts != expected:
        raise AssertionError(f"finetune launches {counts}, expected {expected} "
                             f"({layers} per step and per eval batch)")

    # Eval alone, and the task the next phase profiles: the step-4 weights.
    task = ClassificationTask(cfg.task, cfg.trainer, seed=4)
    task.model.load_state_dict(finetuned)
    del finetuned
    eval_fn = make_eval_fn(task, cfg.task.validation_data, -1, task.device)
    state = TrainState(step=FT_STEPS, model=task.model, optimizer=None)
    eval_fn(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eval_metrics = eval_fn(state)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if eval_metrics.keys() != val_log[-1].keys() - {"step"} or any(
            abs(v - val_log[-1][k]) > 1e-4 for k, v in eval_metrics.items()):
        raise AssertionError(f"eval again {eval_metrics} != the run's {val_log[-1]}")

    # cli.predict on the finetuned checkpoint.
    t0 = time.perf_counter()
    (root / "predict.json").write_text(json.dumps(flickr_experiment(str(root / "vocab.txt"))))
    cli_predict.main([
        f"--config_file={root / 'predict.json'}", f"--input_meta_data_path={root / 'meta.json'}",
        "--predict_split=test", f"--init_checkpoint={run_a}",
        f"--test_output_dir={root / 'out'}", f"--predict_global_batch_size={CLI_BATCH}"])
    predict_s = time.perf_counter() - t0
    rows = (root / "out" / "results.csv").read_text().splitlines()
    recall = json.loads((root / "out" / "recall.json").read_text())
    scores = np.asarray([float(r.split(",")[3]) for r in rows[1:]])
    if len(rows) != 1 + CLI_IMAGES * CLI_TEXTS or len(recall) != 8 \
            or not np.all(np.isfinite(scores)):
        raise AssertionError(f"predict on the finetuned checkpoint: {len(rows)} rows, "
                             f"recall {recall}")

    # Resume: a copy of the run, taken on to step 6, against two
    # uninterrupted 6-step runs (their difference is the run-to-run spread).
    resume_config = finetune_experiment(root, str(root / "pretrain"), FT_RESUME_STEPS)
    run_b = root / "ft_resumed"
    link_copy(run_a, run_b)
    log_b = run_train_cli(resume_config, run_b)
    steps_b = [r["step"] for r in read_jsonl(run_b / "train_summaries.jsonl")]
    if f"resumed from checkpoint at step {FT_STEPS}" not in log_b \
            or steps_b != list(range(1, FT_RESUME_STEPS + 1)):
        raise AssertionError(f"the resumed run did not start at step {FT_STEPS}: {steps_b}")
    resumed = finetune_params(run_b, FT_RESUME_STEPS)
    shutil.rmtree(run_a)
    shutil.rmtree(run_b)
    whole = []
    for name in ("ft_whole", "ft_whole_again"):
        run_train_cli(resume_config, root / name)
        whole.append(finetune_params(root / name, FT_RESUME_STEPS))
        shutil.rmtree(root / name)
    # Preemption: the same 6-step run as a process of the CLI, saving every
    # PREEMPT_CKPT_INTERVAL steps, SIGTERM once its summaries show
    # PREEMPT_AT_STEP; then the same command again.
    run_p = root / "ft_preempted"
    preempt_config = finetune_experiment(root, str(root / "pretrain"), FT_RESUME_STEPS,
                                         checkpoint_interval=PREEMPT_CKPT_INTERVAL)
    command = [sys.executable, "-m", "mmt_tpu_torch.cli.train",
               "--experiment=mmt/classification", "--mode=train_and_eval",
               f"--model_dir={run_p}", f"--config_file={preempt_config}"]
    preempt = preempt_cli(command, run_p, root / "preempted.log", at_step=PREEMPT_AT_STEP)
    k = preempt["step"]
    preempt["checkpoint_interval"] = PREEMPT_CKPT_INTERVAL
    if k % PREEMPT_CKPT_INTERVAL == 0:
        raise AssertionError(f"preempted at step {k}, a regular checkpoint step: the watcher's "
                             f"own save did not run")
    if not (k < FT_RESUME_STEPS and (run_p / str(k) / "model.pt").exists()
            and (run_p / "data_stream" / f"step_{k}.pkl").exists()):
        raise AssertionError(f"preempted at step {k}: no checkpoint or stream snapshot there")
    t0 = time.perf_counter()
    rerun = subprocess.run(command, cwd=REPO, capture_output=True, text=True,
                           timeout=PREEMPT_WAIT_S)
    preempt["rerun_seconds"] = time.perf_counter() - t0
    preempt["rerun_exit_code"] = rerun.returncode
    steps_p = [r["step"] for r in read_jsonl(run_p / "train_summaries.jsonl")]
    if rerun.returncode != 0 or f"resumed from checkpoint at step {k}" not in rerun.stderr \
            or steps_p != list(range(1, FT_RESUME_STEPS + 1)):
        raise AssertionError(f"the rerun after preemption exited {rerun.returncode}, steps "
                             f"{steps_p}: {rerun.stderr[-3000:]}")
    preempt.update(resume_errors(finetune_params(run_p, FT_RESUME_STEPS), whole))
    shutil.rmtree(run_p)
    resume = resume_errors(resumed, whole)
    del resumed, whole

    later = [1.0 / r["steps_per_sec"] for r in train_log[1:]]
    ms_step = float(np.mean(later)) * 1e3
    eval_examples = FT_VAL_RECORDS * (FT_RATIO + 1)
    emit({"phase": "finetune", "global_batch": FT_GLOBAL, "seq_len": CLI_SEQ, "steps": FT_STEPS,
          "train_records": FT_TRAIN_RECORDS, "val_records": FT_VAL_RECORDS, "remat": False,
          "setup_seconds": setup_s, "run_seconds": run_s,
          "first_step_ms": 1e3 / train_log[0]["steps_per_sec"],
          "ms_per_step_after_first": ms_step, "ms_per_step": [t * 1e3 for t in later],
          "examples_per_s": FT_GLOBAL / (ms_step / 1e3),
          "loader_fill_seconds": fill_s, "loader_examples_per_s": 2 * FT_GLOBAL / loader_s,
          "eval_examples": eval_examples, "eval_seconds": eval_s,
          "eval_examples_per_s": eval_examples / eval_s, "peak_memory_gb": peak_gb,
          "launches": counts, "launches_per_step": layers, "eval_batches": eval_batches,
          "count_restored": restored[0], "fresh_tensors": fresh, "best": best_info, "validation": val_log,
          "train": train_log, "predict": {"rows": len(rows) - 1, "seconds": predict_s,
                                          "recall": recall},
          "resume": resume, "preemption": preempt})
    for name, result in (("resumed", resume), ("preempted and resumed", preempt)):
        if result["failing"]:
            raise AssertionError(f"{name} run outside its bound at {result['failing']}")
    return counts, batch, task, restored[0]


def phase_finetune_profile(task, batch):
    """One B=512 training step under the profiler (device time by kernel
    group, idle share, the attention kernels per call); the two kernels at
    that shape and the batch's lengths against their plain versions, alone
    (CUDA events around the wrapper: a profiler session this late in the
    script has dropped kernel records), against SDPA handed the bias mask
    and against the bound."""
    from torch.profiler import ProfilerActivity, profile

    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import batch_to_device
    from mmt_tpu_torch.train.train_state import TrainState

    layers = task.model.config.encoder.mmt.num_hidden_layers
    optimizer = create_optimizer(task.trainer.optimizer_config, task.trainer.train_steps,
                                 task.model)
    state = TrainState.create(task.model, optimizer)
    step = task.make_train_step()
    on_card = batch_to_device(batch, "cuda")
    state, _ = step(state, on_card, DropoutRngs.for_step(0, 0, "cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, on_card, DropoutRngs.for_step(0, 1, "cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    intervals = device_intervals(prof)
    fwd_in_step = kernel_calls_ms(intervals, FWD_KERNEL, layers)
    bwd_in_step = kernel_calls_ms(intervals, BWD_KERNEL, layers)
    summary = trace_summary(intervals, wall_ms, {
        "rel_attention_fwd": ("rel_attention_fwd",), "rel_attention_bwd": ("rel_attention_bwd",),
        "cublas": CUBLAS_TAGS})
    del state, optimizer, on_card, metrics, prof
    task.model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    forward, backward = kernels_at(batch["lengths"].tolist(), DROPOUT, seed=31)
    forward["kernel_ms_per_call_in_step"] = fwd_in_step
    backward["kernel_ms_per_call_in_step"] = bwd_in_step
    lengths = batch["lengths"].tolist()
    emit({"phase": "finetune_profile", "batch": len(lengths), "seq_len": CLI_SEQ, "rate": DROPOUT,
          **summary, "lengths_mean": float(np.mean(lengths)), "tiles": dense_tiles(lengths),
          "forward": forward, "backward": backward})
    check_kernels_at(forward, backward, len(lengths))
    return forward, backward


def kernels_at(lengths, rate, seed, backward=True):
    """The forward kernel (and the backward kernel) at B = len(lengths),
    S = CLI_SEQ with these lengths and this dropout rate: max errors against
    the plain versions, the time alone (CUDA events around the wrapper),
    the plain version's, SDPA handed the bias mask, the bound."""
    from mmt_tpu_torch.ops import fused_attention as fa

    q, k, v, table, geo, lens = attention_inputs(lengths, seed=seed, seq_len=CLI_SEQ)
    seed = 20262
    err_o, err_lse = kernel_errors((q, k, v, table, geo, lens), rate, seed)
    fwd = lambda: fa.relative_attention_forward(q, k, v, table, geo, lens, "cuda",  # noqa: E731
                                                rate, seed)
    f_flops, f_bytes = forward_work(lengths, CLI_SEQ)
    forward = {"ms": cuda_ms(fwd, 20),
               "plain_ms": cuda_ms(lambda: fa.relative_attention_plain(
                   q, k, v, table, geo, lens, rate, seed), 2),
               "library_ms": cuda_ms(sdpa_with_bias(q, k, v, table, geo, lens), 10),
               "flops": f_flops, "bytes": f_bytes, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_lse}
    forward["bound_ms"], forward["bound_by"] = bound_ms(f_flops, f_bytes)
    if not backward:
        del q, k, v
        torch.cuda.empty_cache()
        return forward, None
    o, lse = fwd()
    do = torch.from_numpy(np.random.default_rng(32).standard_normal(q.shape, np.float32)).cuda() \
        .to(torch.bfloat16)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    args = (q, k, v, do, lse, delta, table, geo, lens)
    got = fa.relative_attention_backward(*args, "cuda", rate, seed)
    torch.cuda.synchronize()
    errs = grad_errors(got, fa.relative_attention_backward_plain(*args, rate, seed), lengths)
    del got
    bwd = lambda: fa.relative_attention_backward(*args, "cuda", rate, seed)  # noqa: E731
    b_flops, b_bytes = backward_flops(lengths), backward_bytes(lengths, CLI_SEQ)
    backward = {"ms": cuda_ms(bwd, 10),
                "plain_ms": cuda_ms(lambda: fa.relative_attention_backward_plain(
                    *args, rate, seed), 2),
                "library_ms": sdpa_backward_ms(q, k, v, table, geo, lens, 5),
                "flops": b_flops, "bytes": b_bytes, "errors": errs}
    backward["bound_ms"], backward["bound_by"] = bound_ms(b_flops, b_bytes)
    del q, k, v, do, o, lse, delta, args
    torch.cuda.empty_cache()
    return forward, backward


def check_kernels_at(forward, backward, batch):
    if not (forward["max_abs_err_o"] <= O_BOUND and forward["max_abs_err_lse"] <= LSE_BOUND):
        raise AssertionError(f"forward kernel disagrees with plain at B={batch}, S={CLI_SEQ}: "
                             f"o {forward['max_abs_err_o']} lse {forward['max_abs_err_lse']}")
    if backward is not None:
        check_grad_errors(backward["errors"], f"backward at B={batch}, S={CLI_SEQ}")


def phase_finetune_reference(root: Path, batch):
    """Per-tensor gradients of the classification model on 2 examples of the
    records (one positive, positives weighted FT_POS_WEIGHT), attention
    dropout 0.1 at the same seeds: the kernels (bf16), dense attention
    (bf16) and dense attention in float32 compute.  Replacing dense
    attention by the kernels may add at most TRAIN_GRAD_BOUND to a tensor's
    relative error against the float32 gradient: with the loss on two ITM
    logits alone, the bf16 paths are themselves ~0.3 from float32 on the
    segment table (a sum over ~200 image tokens that nearly cancels), and
    within ~0.05 of each other there."""
    from mmt_tpu_torch.configs import get_experiment_config, override
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.tasks import ClassificationTask, batch_to_device

    labels = np.asarray(batch["label_ids"])
    rows = [int(np.argmax(labels == 1)), int(np.argmax(labels == 0))]
    small = {k: np.asarray(v)[rows] for k, v in batch.items()}
    small["pos_weights"] = np.where(small["label_ids"] > 0, FT_POS_WEIGHT, 1.0).astype(np.float32)
    grads = {}
    for name, impl, dtype in (("kernels", "pallas", "bfloat16"), ("dense", "xla", "bfloat16"),
                              ("dense_fp32", "xla", "float32")):
        experiment = flickr_experiment(str(root / "vocab.txt"), impl)
        experiment["task"]["model"]["encoder"]["mmt"].update(
            {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": DROPOUT,
             "compute_dtype": dtype})
        cfg = override(get_experiment_config("mmt/classification"), experiment)
        task = ClassificationTask(cfg.task, cfg.trainer, seed=7)
        loss, _ = task.compute_loss(batch_to_device(small, task.device),
                                    DropoutRngs(host=torch.Generator().manual_seed(9)))
        loss.backward()
        grads[name] = {n: p.grad for n, p in task.model.named_parameters()}
        del task, loss
        torch.cuda.empty_cache()
    worst, worst_name, n_zero, errors = gradient_errors(grads["kernels"], grads["dense"])
    _, _, _, kernel_err = gradient_errors(grads["kernels"], grads["dense_fp32"])
    _, _, _, dense_err = gradient_errors(grads["dense"], grads["dense_fp32"])
    excess = {n: kernel_err[n] - dense_err[n] for n in kernel_err}
    worst_excess = max(excess, key=excess.get)
    top = sorted(errors.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "finetune_reference", "tensors": len(grads["kernels"]), "zero_tensors": n_zero,
          "lengths": small["lengths"].tolist(), "labels": small["label_ids"].tolist(),
          "pos_weight": FT_POS_WEIGHT, "attention_dropout": DROPOUT,
          "max_rel_frobenius_err_vs_dense": worst, "worst_tensor": worst_name,
          "largest_errors_vs_dense": top,
          "max_excess_over_dense_vs_fp32": excess[worst_excess],
          "worst_excess_tensor": worst_excess,
          "at_worst_excess": {"kernels_vs_fp32": kernel_err[worst_excess],
                              "dense_vs_fp32": dense_err[worst_excess]},
          "max_dense_vs_fp32": max(dense_err.values()),
          "max_kernels_vs_fp32": max(kernel_err.values()), "bound": TRAIN_GRAD_BOUND})
    if not excess[worst_excess] <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"{worst_excess}: the kernels' gradient error against float32 "
                             f"{kernel_err[worst_excess]} exceeds dense attention's "
                             f"{dense_err[worst_excess]} by more than {TRAIN_GRAD_BOUND}")


# ------------------------------------------- continuous finetuning, checkpoints

# continuous_train_and_eval of the finetune yaml at CONT_STEPS steps a
# round: the CLI's watch ends CONT_TIMEOUT_S after it started and polls every
# CONT_POLL_S (3600 s and 10 s in the CLI), which leaves room for two rounds
# and the second checkpoint's save between them.
CONT_STEPS, CONT_TIMEOUT_S, CONT_POLL_S = 2, 30.0, 1.0
# grad_accum: one step of GA_MICRO_BATCHES micro-batches of TRAIN_MICRO;
# the bf16 sum makes 8 roundings of ~2**-9 relative each, held against the
# float32 sum of the same micro-batch gradients.
GA_MICRO_BATCHES, GA_LOSS_REL_BOUND, GA_GRAD_REL_BOUND = 8, 1e-5, 1e-2


def phase_continuous(root: Path, expected_restored: int):
    """``cli.train.main --mode=continuous_train_and_eval`` on the finetune
    yaml at CONT_STEPS steps a round, watching a pretraining directory that
    holds the seeded WIT checkpoint at step 0; once the first results line
    is written, a helper thread saves a second checkpoint (step 1, another
    seed) with ``async_save``.  Two rounds, their numbers, the tensors
    restored in each and the launches; returns the launches."""
    import threading

    from mmt_tpu_torch.cli import train as cli_train
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import PretrainingTask

    pre_dir = root / "continuous_pretrain"
    link_copy(root / "pretrain", pre_dir)
    pre_cfg = pretrain_experiment()
    second = PretrainingTask(pre_cfg.task, pre_cfg.trainer, device="cpu", seed=12).model
    config = finetune_experiment(root, "", CONT_STEPS)
    model_dir = root / "continuous"
    results = model_dir / "continuous_results.jsonl"
    timeline = {}

    def save_second():
        deadline = time.monotonic() + CONT_TIMEOUT_S
        while not results.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        timeline["first_line_s"] = time.perf_counter() - t0
        mgr = CheckpointManager(str(pre_dir), async_save=True)
        t_save = time.perf_counter()
        mgr.save(1, second)
        timeline["save_blocked_ms"] = (time.perf_counter() - t_save) * 1e3
        mgr.wait_until_finished()
        timeline["save_durable_ms"] = (time.perf_counter() - t_save) * 1e3
        while len(results.read_text().splitlines()) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        timeline["second_line_s"] = time.perf_counter() - t0

    saved = cli_train.CONTINUOUS_TIMEOUT_S, cli_train.CONTINUOUS_POLL_S
    cli_train.CONTINUOUS_TIMEOUT_S, cli_train.CONTINUOUS_POLL_S = CONT_TIMEOUT_S, CONT_POLL_S
    helper = threading.Thread(target=save_second)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    helper.start()
    try:
        log = run_train_cli(config, model_dir, mode="continuous_train_and_eval",
                            extra=[f"--pretrain_model_dir={pre_dir}"])
    finally:
        cli_train.CONTINUOUS_TIMEOUT_S, cli_train.CONTINUOUS_POLL_S = saved
        helper.join(timeout=CONT_TIMEOUT_S)
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    del second
    lines = read_jsonl(results)
    restored = [int(line.split("count_restored=")[1].split()[0])
                for line in log if "continuous finetune @" in line and "count_restored=" in line]
    layers = pre_cfg.task.model.encoder.mmt.num_hidden_layers
    eval_batches = math.ceil(FT_VAL_RECORDS / (FT_EVAL_BATCH // (FT_RATIO + 1)))
    expected = {"fwd": layers * 2 * (CONT_STEPS + eval_batches), "fwd_window": 0,
                "bwd": layers * 2 * CONT_STEPS, "bwd_window": 0}
    emit({"phase": "continuous", "steps_per_round": CONT_STEPS, "global_batch": FT_GLOBAL,
          "timeout_s": CONT_TIMEOUT_S, "poll_s": CONT_POLL_S, "run_seconds": run_s,
          **timeline, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "results": lines, "count_restored": restored, "launches": counts,
          "expected_launches": expected})
    if [l["pretrain_step"] for l in lines] != [0, 1] or not all(
            math.isfinite(l[k]) for l in lines for k in ("cls_accuracy", "cls_loss", "auc")):
        raise AssertionError(f"continuous results {lines}")
    if restored != [expected_restored] * 2:
        raise AssertionError(f"count_restored {restored}, expected {expected_restored} a round")
    if counts != expected:
        raise AssertionError(f"continuous launches {counts}, expected {expected}")
    shutil.rmtree(pre_dir)
    shutil.rmtree(model_dir)
    torch.cuda.empty_cache()
    return counts


def phase_checkpoint(root: Path) -> None:
    """``CheckpointManager.save`` of the WIT pretraining model and its AdamW
    state (moments filled from a seed), synchronous and asynchronous in
    turns: the ms the caller is blocked and the ms until the checkpoint is
    durable, the bytes written, and the restored tensors bit-equal to the
    saved ones."""
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import PretrainingTask

    cfg = pretrain_experiment()
    task = PretrainingTask(cfg.task, cfg.trainer, device="cuda", seed=13)
    optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps,
                                 task.model)
    gen = torch.Generator("cuda").manual_seed(13)
    with torch.no_grad():
        for name in optimizer.mu:
            optimizer.mu[name].normal_(generator=gen)
            optimizer.nu[name].uniform_(generator=gen)
    optimizer.count = 7
    want_model = {k: v.cpu() for k, v in task.model.state_dict().items()}
    want_opt = {key: {n: t.cpu() for n, t in getattr(optimizer, key).items()}
                for key in ("mu", "nu")}
    runs = []
    for i, async_save in enumerate((False, True, True, False)):
        directory = root / f"checkpoint_{i}"
        mgr = CheckpointManager(str(directory), async_save=async_save)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, task.model, optimizer)
        blocked_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait_until_finished()
        durable_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size for f in (directory / "1").iterdir())
        got = mgr.restore(1)
        got_opt = torch.load(directory / "1" / "optimizer.pt", map_location="cpu",
                             weights_only=True)
        unequal = [n for n, v in want_model.items() if not torch.equal(got[n], v)]
        unequal += [f"{key}.{n}" for key, ts in want_opt.items() for n, t in ts.items()
                    if not torch.equal(got_opt[key][n], t)]
        if got.keys() != want_model.keys() or got_opt["count"] != 7 or unequal:
            raise AssertionError(f"restored checkpoint differs from the saved state: "
                                 f"{unequal[:5]}")
        runs.append({"async": async_save, "blocked_ms": blocked_ms, "durable_ms": durable_ms,
                     "bytes": nbytes})
        del got, got_opt
        shutil.rmtree(directory)
    emit({"phase": "checkpoint", "model": "WIT pretraining (mlm_itm_2d.yaml) + AdamW",
          "tensors": len(want_model), "runs": runs})
    del task, optimizer
    torch.cuda.empty_cache()


class GradKeeper:
    """An optimizer stand-in that keeps the summed gradient it is handed
    and updates nothing."""

    def __init__(self, model):
        self.model = model
        self.grads = None

    def step(self):
        self.grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                      for n, p in self.model.named_parameters()}

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)


class MicroGradSums:
    """Post-accumulate-grad hooks on every parameter of ``model``: each
    gradient the backward leaves in ``.grad`` is added to a float32 sum and,
    rounded to bfloat16, to a bfloat16 sum.  In a step that accumulates in
    bfloat16 ``.grad`` is cleared after every micro-batch, so the hooks see
    each micro-batch's gradient."""

    def __init__(self, model):
        self.params = dict(model.named_parameters())
        self.f32 = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
        self.bf16 = {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in self.params.items()}
        self.handles = [p.register_post_accumulate_grad_hook(self._hook(n))
                        for n, p in self.params.items()]

    def _hook(self, name):
        def hook(p):
            self.f32[name] += p.grad
            self.bf16[name] += p.grad.to(torch.bfloat16)
        return hook

    def remove(self):
        for handle in self.handles:
            handle.remove()


def phase_grad_accum():
    """One WIT pretraining step of GA_MICRO_BATCHES micro-batches of 64 (the
    same parameters, batch and dropout seed) with float32, bfloat16, and
    again bfloat16 under ``MicroGradSums``.  That step's summed gradient
    must equal the bf16 sum of the micro-batches' gradients it recorded bit
    for bit, and lie per tensor within GA_GRAD_REL_BOUND of their float32
    sum's norm (``gradient_errors``' rule: the key bias against the query
    bias's norm); both sums are of the same gradients, so the backward's
    run-to-run spread drops out.  The losses within GA_LOSS_REL_BOUND
    relative: the three steps drove the same forward (the accumulation
    starts after the loss).  Reports the worst tensors, the float32 step's
    distance from the bfloat16 step (run-to-run spread included) and the
    peak memory of the first two runs; returns the launches."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.tasks import PretrainingTask
    from mmt_tpu_torch.train.train_state import TrainState

    cfg = pretrain_experiment()
    task = PretrainingTask(cfg.task, cfg.trainer, device="cuda", seed=14)
    gen = torch.Generator("cuda").manual_seed(14)
    batch = synthetic_pretrain_batch(cfg.task.train_data, cfg.task.model.encoder.mmt.vocab_size,
                                     GA_MICRO_BATCHES * TRAIN_MICRO, gen)
    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    runs = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for dtype, recorded in (("float32", False), ("bfloat16", False), ("bfloat16", True)):
        keeper = GradKeeper(task.model)
        step = task.make_train_step(TRAIN_MICRO, dtype)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sums = MicroGradSums(task.model) if recorded else None
        t0 = time.perf_counter()
        _, metrics = step(TrainState(step=0, model=task.model, optimizer=keeper), batch,
                          DropoutRngs.for_step(0, 0, "cuda"))
        torch.cuda.synchronize()
        run = {"dtype": dtype, "recorded": recorded, "grads": keeper.grads,
               "loss": metrics["total_loss"][0].item()}
        if recorded:
            sums.remove()
        else:
            run.update(seconds=time.perf_counter() - t0,
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(run)
    counts = launch_counts()
    g32, g16, g16_rec = (r.pop("grads") for r in runs)
    unequal = [n for n, g in g16_rec.items() if not torch.equal(g, sums.bf16[n].float())]
    _, _, n_zero, errors = gradient_errors(g16_rec, sums.f32)
    _, _, _, across = gradient_errors(g16, g32)
    worst = max(errors, key=errors.get)
    loss_rel = max(abs(r["loss"] - runs[0]["loss"]) for r in runs) / abs(runs[0]["loss"])
    expected = layers * GA_MICRO_BATCHES * len(runs)
    emit({"phase": "grad_accum", "micro_batches": GA_MICRO_BATCHES, "micro_batch": TRAIN_MICRO,
          "seq_len": TRAIN_SEQ, "rate": DROPOUT, "runs": runs,
          "loss_rel_diff": loss_rel, "loss_bound": GA_LOSS_REL_BOUND,
          "bf16_sum_unequal_tensors": len(unequal), "bound": GA_GRAD_REL_BOUND,
          "max_grad_rel_err": errors[worst], "worst_tensor": worst,
          "largest_errors": sorted(errors.items(), key=lambda kv: -kv[1])[:5],
          "float32_step_vs_bf16_step": sorted(across.items(), key=lambda kv: -kv[1])[:5],
          "zero_tensors": n_zero, "launches": counts})
    del runs, task, batch, g16, g32, g16_rec, sums
    torch.cuda.empty_cache()
    if unequal:
        raise AssertionError(f"bf16 accumulation: the step's sum is not the bf16 sum of its "
                             f"micro-batches' gradients at {unequal[:5]}")
    if not (loss_rel <= GA_LOSS_REL_BOUND and errors[worst] <= GA_GRAD_REL_BOUND):
        raise AssertionError(f"bf16 accumulation: loss {loss_rel}, {worst} {errors[worst]}")
    if counts != {"fwd": expected, "fwd_window": 0, "bwd": expected, "bwd_window": 0}:
        raise AssertionError(f"grad_accum launches {counts}, expected {expected} each")
    return counts


# ------------------------------------------------- WIT pretraining from records

# configs/exp_yamls/pretrain/wit/mlm_itm_2d.yaml from records: global batch
# 4096 (2048 records matched at ratio 1) in micro-batches of 64, validation
# at the last step on PR_EVAL_STEPS batches of 256.  The schedule is cut to
# the steps that measure something: with N loader processes the first N
# batches arrive together after the shuffle buffers fill, so a run takes
# N + 1 steps (one steady step after them), and 2 with the loader in the
# training process.
PR_TRAIN_FILES, PR_RECORDS_PER_FILE, PR_VAL_RECORDS = 8, 512, 512
PR_EVAL_BATCH, PR_EVAL_STEPS = 256, 2
PR_PROFILE_ROWS = 1024  # a no-shuffle batch of the records, tiled to 4096 rows
PR_REF_RECORDS = 64  # 224 x 224 images (ship_raw_images takes no resize)
PR_IMAGE_SIZES = ((192, 256), (256, 192), (200, 300))  # (height, width), resized to 224
PR_IMAGES_PER_FILE = 128  # distinct PNGs per record file, cycled
# The loss of a micro-batch, kernels against dense attention: a mean of
# ~2000 cross-entropy terms over bf16 logits.
LOSS_REL_BOUND = 1e-2
# Batches of host memory one loader process may hold: its queue (4, the
# default ``prefetch_per_worker``) and, in the process, the ~3 matched
# batches its stream's shuffle buffer still views, the batch being stacked
# and the one being copied out (``data/prefetch.py``).
WORKER_BATCHES_HELD = 9
# Share of the host's available memory the loader processes may take.
WORKER_MEMORY_SHARE = 0.6
# Share of a kernel's launches a one-step trace must record (the profiler
# dropped 1 of 768 forward calls in a 64-micro-batch step).
TRACE_MIN_SHARE = 0.99


def records_steps(num_workers: int) -> int:
    return num_workers + 1 if num_workers else 2


def smooth_image(rng, height, width):
    """A seeded smooth uint8 pattern: a linear gradient per channel
    (wrapping at 256), which PNG compresses to ~2 KB."""
    y, x = np.mgrid[0:height, 0:width]
    slope = rng.integers(-3, 4, (3, 2))
    offset = rng.integers(0, 256, 3)
    return np.stack([(slope[c, 0] * x + slope[c, 1] * y + offset[c]) % 256 for c in range(3)],
                    -1).astype(np.uint8)


def write_wit_records(path: Path, n: int, seed: int, sizes=PR_IMAGE_SIZES) -> str:
    """Seeded WIT-style records: a smooth PNG image (PR_IMAGES_PER_FILE
    distinct ones cycled, their sizes cycling through ``sizes``),
    ``canonical_doc_id`` (two records a page) and the attribution and
    reference captions, 8-40 words each."""
    import io

    from PIL import Image

    from mmt_tpu_torch.data.tfrecord import TFRecordWriter, build_example

    rng = np.random.default_rng(seed)
    images = []
    for j in range(min(n, PR_IMAGES_PER_FILE)):
        buf = io.BytesIO()
        Image.fromarray(smooth_image(rng, *sizes[j % len(sizes)])).save(buf, format="PNG")
        images.append(buf.getvalue())
    words = np.asarray(CLI_WORD_LIST)
    with TFRecordWriter(str(path)) as w:
        for i in range(n):
            att, ref = (" ".join(rng.choice(words, size=int(rng.integers(8, 41)))).encode()
                        for _ in range(2))
            w.write(build_example({"image_data": [images[i % len(images)]],
                                   "canonical_doc_id": [f"wit{seed}_{i // 2}".encode()],
                                   "caption_attribution_description": [att],
                                   "caption_reference_description": [ref]}))
    return str(path)


def wit_records_experiment(root: Path, num_workers: int = 0, train_steps: int = 2,
                           attention_impl="pallas") -> dict:
    """configs/exp_yamls/pretrain/wit/mlm_itm_2d.yaml as nested overrides of
    mmt/pretraining (written out as JSON text) with its placeholders filled
    and only its schedule cut: ``train_steps`` steps, validation at the last
    on PR_EVAL_STEPS batches, one-step windows; ``num_workers`` loader
    processes when not 0."""
    data = {"seed": 128, "cycle_length": 8, "deterministic": True,
            "vocab_filename": str(root / "vocab.txt"), "max_seq_len": TRAIN_SEQ,
            "image_data_field": "image_data", "image_key_field": "canonical_doc_id",
            "text_special_token_field_dict": '{"caption_attribution_description": "[ATT]",'
                                             ' "caption_reference_description":"[REF]"}',
            "tasks": "mlm,itm", "mpp_fraction_to_mask": 0.0, "relative_att_num_core_layers": 1}
    workers = {"num_workers": num_workers} if num_workers else {}
    return {
        "task": {
            "model": {
                "encoder": {"type": "mmt", "mmt": {
                    "relative_att_num_core_layers": 1, "relative_pos_max_distance": 12,
                    "relative_vocab_size": 49, "attention_impl": attention_impl,
                    "compute_dtype": "bfloat16"}},
                "cls_heads": [{"inner_dim": 768, "num_classes": 2, "name": "itm"}]},
            "train_data": {**data, "input_path": str(root / "train-*.tfrecord"),
                           "is_training": True, "global_batch_size": TRAIN_GLOBAL,
                           "use_rand_aug": True, **workers},
            "validation_data": {**data, "input_path": str(root / "val.tfrecord"),
                                "is_training": False, "global_batch_size": PR_EVAL_BATCH}},
        "trainer": {"checkpoint_interval": 1000, "max_to_keep": 32, "steps_per_loop": 1,
                    "summary_interval": 1, "train_steps": train_steps,
                    "validation_interval": train_steps, "validation_steps": PR_EVAL_STEPS,
                    "micro_batch_size": TRAIN_MICRO,
                    "optimizer_config": {
                        "polynomial": {"initial_learning_rate": 0.0005, "decay_steps": 20000},
                        "warmup": {"warmup_steps": 2000}}}}


def host_memory_used() -> int:
    """Bytes of the host's memory in use (MemTotal - MemAvailable): the
    processes and the shared-memory blocks queued between them."""
    with open("/proc/meminfo") as f:
        info = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    return info["MemTotal"] - info["MemAvailable"]


class HostMemory:
    """Peak of ``host_memory_used`` while the block runs, sampled every
    ``interval`` seconds from a thread, and its value at the start."""

    def __init__(self, interval: float = 0.25):
        import threading

        self.interval, self.start_gb, self.peak_gb = interval, 0.0, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self.start_gb = self.peak_gb = host_memory_used() / 1e9
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.peak_gb = max(self.peak_gb, host_memory_used() / 1e9)


def pretrain_batch_bytes(data_cfg) -> int:
    """Host bytes of one training batch of the records experiment (its
    patch vectors; the rest is < 1%)."""
    return data_cfg.global_batch_size * data_cfg.num_patches * 3 * data_cfg.patch_size**2 * 4


def choose_workers(batch_bytes: int):
    """Loader processes for the worker run: as many as the host's cores
    allow (two kept for the training process and the system) and as its
    available memory allows at WORKER_BATCHES_HELD batches a process within
    WORKER_MEMORY_SHARE of it; with the figures it came from."""
    import os

    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    cores = len(os.sched_getaffinity(0))
    by_memory = int(WORKER_MEMORY_SHARE * avail // (WORKER_BATCHES_HELD * batch_bytes))
    workers = max(1, min(cores - 2, by_memory))
    return workers, {"cores": cores, "mem_available_gb": avail / 1e9, "by_memory": by_memory,
                     "batch_gb": batch_bytes / 1e9, "batches_held_per_worker": WORKER_BATCHES_HELD}


VALIDATION_KEYS = ("mlm_loss", "mpp_loss", "itm_loss", "mlm_accuracy", "mpp_accuracy",
                   "itm_accuracy", "total_loss")


def run_records_cli(root: Path, num_workers: int, layers: int) -> dict:
    """One ``cli.train.main`` run of the records experiment; its numbers,
    launches and peak memory, checked."""
    import shutil

    steps = records_steps(num_workers)
    config = root / f"wit_records_w{num_workers}.json"
    config.write_text(json.dumps(wit_records_experiment(root, num_workers, steps)))
    model_dir = root / f"pt_w{num_workers}"
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with HostMemory() as host:
        t0 = time.perf_counter()
        log = run_train_cli(config, model_dir, "mmt/pretraining")
        run_s = time.perf_counter() - t0
    counts = launch_counts()
    micro = TRAIN_GLOBAL // TRAIN_MICRO
    expected = {"fwd": layers * (micro * steps + PR_EVAL_STEPS), "fwd_window": 0,
                "bwd": layers * micro * steps, "bwd_window": 0}
    if counts != expected:
        raise AssertionError(f"records run ({num_workers} workers): launches {counts}, "
                             f"expected {expected}")
    for name in ("params.yaml", "train_summaries.jsonl", "validation_summaries.jsonl",
                 str(steps)):
        if not (model_dir / name).exists():
            raise AssertionError(f"the records run wrote no {name}")
    if (model_dir / "data_stream").exists() != (num_workers == 0):
        raise AssertionError("only the in-process stream has a snapshot to write")
    train_log = read_jsonl(model_dir / "train_summaries.jsonl")
    val_log = read_jsonl(model_dir / "validation_summaries.jsonl")
    if [r["step"] for r in train_log] != list(range(1, steps + 1)) \
            or [r["step"] for r in val_log] != [steps]:
        raise AssertionError(f"summaries at {[r['step'] for r in train_log]}, "
                             f"{[r['step'] for r in val_log]}")
    if not all(k in val_log[0] for k in VALIDATION_KEYS) or "auc" in val_log[0]:
        raise AssertionError(f"validation metrics {sorted(val_log[0])}")
    if not all(math.isfinite(v) for r in train_log + val_log for v in r.values()):
        raise AssertionError(f"non-finite numbers: {train_log} {val_log}")
    first_batch = [float(line.split("first batch after ")[1].split()[0])
                   for line in log if "first batch after " in line]
    shutil.rmtree(model_dir)
    # Steady steps: after the first num_workers (whose batches arrive
    # together after the fill) or, in process, after the first.
    steady = train_log[max(1, num_workers):]
    ms_step = float(np.mean([1e3 / r["steps_per_sec"] for r in steady]))
    input_s = float(np.mean([r["input_seconds"] for r in steady]))
    return {"num_workers": num_workers, "steps": steps, "run_seconds": run_s,
            "first_batch_seconds": first_batch[0],
            "first_step_ms": 1e3 / train_log[0]["steps_per_sec"],
            "ms_per_step": [1e3 / r["steps_per_sec"] for r in train_log[1:]],
            "steady_steps": [r["step"] for r in steady], "ms_per_steady_step": ms_step,
            "examples_per_s": TRAIN_GLOBAL / (ms_step / 1e3),
            "input_seconds_per_steady_step": input_s,
            "loader_examples_per_s": TRAIN_GLOBAL / input_s if input_s else None,
            "host_used_gb_at_start": host.start_gb, "peak_host_used_gb": host.peak_gb,
            "peak_card_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
            "validation": val_log[0], "train": train_log}


def loader_profile(data_cfg, records: int = 64) -> dict:
    """cProfile of the loader's per-record work (decode with RandAugment,
    then MPP and MLM masking) over ``records`` training records in this
    process: seconds, and the functions with the most time of their own."""
    import cProfile
    import pstats

    from mmt_tpu_torch.data.loaders import MmtPretrainLoader

    loader = MmtPretrainLoader(data_cfg)
    cursor = loader._record_iter(data_cfg.input_path, 0, 1, data_cfg.seed, True)
    rng = np.random.default_rng(0)
    loader._mask_example(loader._decode(next(cursor), rng, True), rng)  # imports, tables
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(records):
        loader._mask_example(loader._decode(next(cursor), rng, True), rng)
    prof.disable()
    seconds = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    own = sorted(((f"{Path(fn).name}:{line}({name})", tt) for (fn, line, name), (_, _, tt, _, _)
                  in stats.items()), key=lambda kv: -kv[1])[:8]
    return {"records": records, "seconds": seconds, "ms_per_record": seconds / records * 1e3,
            "top_own_seconds": [[name, tt] for name, tt in own]}


def phase_pretrain_records(root: Path):
    """WIT pretraining from records through ``cli.train.main`` at full width,
    with the loader in the training process and in N processes, and
    validation alone.  Returns the launches of both runs, the task holding
    seeded weights, its config and the runs' numbers."""
    from mmt_tpu_torch.cli.train import build_experiment_config, make_eval_fn, parse_args
    from mmt_tpu_torch.train.tasks import PretrainingTask
    from mmt_tpu_torch.train.train_state import TrainState

    t0 = time.perf_counter()
    write_flickr_vocab(root)
    for i in range(PR_TRAIN_FILES):
        write_wit_records(root / f"train-{i:05d}-of-{PR_TRAIN_FILES:05d}.tfrecord",
                          PR_RECORDS_PER_FILE, seed=100 + i)
    write_wit_records(root / "val.tfrecord", PR_VAL_RECORDS, seed=99)
    setup_s = time.perf_counter() - t0
    (root / "wit_records.json").write_text(json.dumps(wit_records_experiment(root)))
    cfg = build_experiment_config(parse_args([
        "--experiment=mmt/pretraining", "--model_dir=unused",
        f"--config_file={root / 'wit_records.json'}"]))
    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    workers, workers_from = choose_workers(pretrain_batch_bytes(cfg.task.train_data))

    runs = [run_records_cli(root, n, layers) for n in (0, workers)]
    decode_profile = loader_profile(cfg.task.train_data)

    # Validation alone (records -> metrics, 2 batches of 256), on seeded
    # weights: the runs' checkpoints are gone.
    task = PretrainingTask(cfg.task, cfg.trainer, seed=3)
    eval_fn = make_eval_fn(task, cfg.task.validation_data, PR_EVAL_STEPS, task.device)
    state = TrainState(step=0, model=task.model, optimizer=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eval_metrics = eval_fn(state)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if sorted(eval_metrics) != sorted(VALIDATION_KEYS) or not all(
            math.isfinite(v) for v in eval_metrics.values()):
        raise AssertionError(f"validation alone: {eval_metrics}")
    eval_examples = PR_EVAL_STEPS * PR_EVAL_BATCH
    emit({"phase": "pretrain_records", "global_batch": TRAIN_GLOBAL, "micro_batch": TRAIN_MICRO,
          "seq_len": TRAIN_SEQ, "train_records": PR_TRAIN_FILES * PR_RECORDS_PER_FILE,
          "val_records": PR_VAL_RECORDS, "setup_seconds": setup_s,
          "workers": workers, "workers_from": workers_from, "runs": runs,
          "loader_profile": decode_profile, "eval_examples": eval_examples, "eval_seconds": eval_s,
          "eval_examples_per_s": eval_examples / eval_s, "eval_metrics": eval_metrics})
    launches = {k: sum(r["launches"][k] for r in runs) for k in ("fwd", "bwd")}
    return launches, task, cfg, runs


def micro_batch_rows(batch):
    """TRAIN_MICRO rows of ``profile_batch``: half positives, half their
    negatives."""
    half = TRAIN_MICRO // 2
    rows = np.r_[0:half, PR_PROFILE_ROWS // 2:PR_PROFILE_ROWS // 2 + half]
    return {k: np.asarray(v)[rows] for k, v in batch.items()}


def profile_batch(cfg):
    """A training batch of 4096 rows for the device-side phases: a
    no-shuffle batch of PR_PROFILE_ROWS rows of the training records
    (positives, then their negatives), four times over."""
    import dataclasses

    from mmt_tpu_torch.data.loaders import MmtPretrainLoader

    data_cfg = dataclasses.replace(cfg.task.train_data, is_training=False,
                                   global_batch_size=PR_PROFILE_ROWS)
    rows = next(MmtPretrainLoader(data_cfg).load())
    reps = TRAIN_GLOBAL // PR_PROFILE_ROWS
    return {k: np.concatenate([v] * reps) for k, v in rows.items()}


def phase_pretrain_records_profile(task, cfg, batch, runs):
    """One optimizer step (64 micro-batches of 64) of a records batch
    (``profile_batch``) already on the card under the profiler: device time
    by kernel group, idle share, the attention kernels per call, and the
    host's share of the runs' steady steps.  Then the kernels at this
    slice's shapes with the records' lengths: K1 and K3 at the first
    micro-batch (B=64, rate 0.1), K1 at a validation batch (B=256, rate 0),
    each against its plain version, SDPA and the bound."""
    from torch.profiler import ProfilerActivity, profile

    from mmt_tpu_torch.data.loaders import MmtPretrainLoader
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import batch_to_device
    from mmt_tpu_torch.train.train_state import TrainState

    layers = cfg.task.model.encoder.mmt.num_hidden_layers
    micro = TRAIN_GLOBAL // TRAIN_MICRO
    optimizer = create_optimizer(cfg.trainer.optimizer_config, cfg.trainer.train_steps,
                                 task.model)
    state = TrainState.create(task.model, optimizer)
    step = task.make_train_step(TRAIN_MICRO)
    on_card = batch_to_device(batch, "cuda")
    state, _ = step(state, on_card, DropoutRngs.for_step(0, 0, "cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, on_card, DropoutRngs.for_step(0, 1, "cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    intervals = device_intervals(prof)
    # A step's trace holds ~60000 kernels; the profiler may drop a few.
    recorded = {name: sum(name in n for n, _, _ in intervals) for name in (FWD_KERNEL, BWD_KERNEL)}
    fwd_in_step = kernel_calls_ms(intervals, FWD_KERNEL, layers * micro, TRACE_MIN_SHARE)
    bwd_in_step = kernel_calls_ms(intervals, BWD_KERNEL, layers * micro, TRACE_MIN_SHARE)
    summary = trace_summary(intervals, wall_ms, {
        "rel_attention_fwd": ("rel_attention_fwd",), "rel_attention_bwd": ("rel_attention_bwd",),
        "cublas": CUBLAS_TAGS})
    del state, optimizer, on_card, metrics, prof
    task.model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    host_share = {f"workers_{r['num_workers']}": 1 - summary["device_busy_ms"]
                  / r["ms_per_steady_step"] for r in runs}

    lengths = micro_batch_rows(batch)["lengths"].tolist()
    forward, backward = kernels_at(lengths, DROPOUT, seed=41)
    forward["kernel_ms_per_call_in_step"] = fwd_in_step
    backward["kernel_ms_per_call_in_step"] = bwd_in_step
    val_lengths = next(MmtPretrainLoader(cfg.task.validation_data).load())["lengths"].tolist()
    val_forward, _ = kernels_at(val_lengths, 0.0, seed=43, backward=False)
    emit({"phase": "pretrain_records_profile", "global_batch": TRAIN_GLOBAL,
          "micro_batches": micro, **summary, "host_share_of_step": host_share,
          "kernel_calls_recorded": recorded, "kernel_calls_launched": layers * micro,
          "lengths_mean": float(np.mean(batch["lengths"])),
          "micro_batch": {"lengths_mean": float(np.mean(lengths)), "tiles": dense_tiles(lengths),
                          "rate": DROPOUT, "forward": forward, "backward": backward},
          "validation_batch": {"batch": len(val_lengths),
                               "lengths_mean": float(np.mean(val_lengths)),
                               "tiles": dense_tiles(val_lengths), "rate": 0.0,
                               "forward": val_forward}})
    check_kernels_at(forward, backward, len(lengths))
    check_kernels_at(val_forward, None, len(val_lengths))
    return forward, backward, val_forward


def logits_errors(got, want):
    """ITM logits: max abs error against 4 bf16 spacings at the largest
    logit (phase reference); MLM and MPP logits: relative Frobenius error
    against SEQUENCE_REL_BOUND (the encoder output's bound).  Returns the
    errors and the names outside their bounds."""
    out, failing = {}, []
    err = (got["itm_logits"] - want["itm_logits"]).abs().max().item()
    bound = 4 * 2.0 ** (math.floor(math.log2(want["itm_logits"].abs().max().item())) - 7)
    out["itm"] = {"max_abs_err": err, "bound": bound}
    if not err <= bound:
        failing.append("itm")
    for head in ("mlm", "mpp"):
        g, w = got[f"{head}_logits"].float(), want[f"{head}_logits"].float()
        rel = ((g - w).norm() / w.norm()).item()
        out[head] = {"rel_frobenius_err": rel, "bound": SEQUENCE_REL_BOUND}
        if not rel <= SEQUENCE_REL_BOUND:
            failing.append(head)
    return out, failing


def phase_pretrain_records_reference(root: Path, batch):
    """(1) A micro-batch of 64 rows of the records (``micro_batch_rows``),
    kernels against dense attention (hidden dropout 0, attention dropout 0.1 from the same
    seeds): the loss within LOSS_REL_BOUND and every parameter tensor's
    gradient within TRAIN_GRAD_BOUND (train_reference's rule), or, where a
    tensor falls outside, the kernels' error against dense attention in
    float32 at most TRAIN_GRAD_BOUND above dense bf16 attention's
    (finetune_reference's rule).  (2) One batch of MLM + MPP + ITM at MPP
    0.5, RandAugment off, from 224 x 224 records, in host mode and in
    ``ship_raw_images`` mode: the MLM, MPP and ITM logits on the card of the
    two modes against each other, and against dense attention."""
    from mmt_tpu_torch.cli.train import build_experiment_config, parse_args
    from mmt_tpu_torch.configs import override
    from mmt_tpu_torch.data.loaders import MmtPretrainLoader
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device

    def task_for(impl, dtype="bfloat16", hidden_dropout=0.0, attention_dropout=DROPOUT):
        path = root / "wit_records.json"
        cfg = build_experiment_config(parse_args(["--experiment=mmt/pretraining",
                                                  "--model_dir=unused", f"--config_file={path}"]))
        cfg = override(cfg, {"task": {"model": {"encoder": {"mmt": {
            "attention_impl": impl, "compute_dtype": dtype, "hidden_dropout_prob": hidden_dropout,
            "attention_probs_dropout_prob": attention_dropout}}}}})
        return PretrainingTask(cfg.task, cfg.trainer, seed=7)

    micro = micro_batch_rows(batch)
    grads, losses = {}, {}
    for name, impl, dtype in (("kernels", "pallas", "bfloat16"), ("dense", "xla", "bfloat16"),
                              ("dense_fp32", "xla", "float32")):
        task = task_for(impl, dtype)
        loss, _ = task.compute_loss(batch_to_device(micro, task.device),
                                    DropoutRngs(host=torch.Generator().manual_seed(9)))
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {n: p.grad for n, p in task.model.named_parameters()}
        del task, loss
        torch.cuda.empty_cache()
    worst, worst_name, n_zero, errors = gradient_errors(grads["kernels"], grads["dense"])
    _, _, _, kernel_err = gradient_errors(grads["kernels"], grads["dense_fp32"])
    _, _, _, dense_err = gradient_errors(grads["dense"], grads["dense_fp32"])
    del grads
    outside = [n for n, e in errors.items() if e > TRAIN_GRAD_BOUND]
    excess = {n: kernel_err[n] - dense_err[n] for n in outside}
    loss_err = abs(losses["kernels"] - losses["dense"]) / abs(losses["dense"])
    top = sorted(errors.items(), key=lambda kv: -kv[1])[:5]

    # (2) MPP on 224 x 224 records, host mode against raw mode.
    write_wit_records(root / "ref.tfrecord", PR_REF_RECORDS, seed=98, sizes=((224, 224),))
    data = {**wit_records_experiment(root)["task"]["validation_data"],
            "input_path": str(root / "ref.tfrecord"), "tasks": "mlm,mpp,itm",
            "mpp_fraction_to_mask": 0.5, "use_rand_aug": False, "global_batch_size": PR_REF_RECORDS}
    from mmt_tpu_torch.configs.data import MmtPretrainDataConfig

    modes = {raw: next(MmtPretrainLoader(MmtPretrainDataConfig(
        **{**data, "ship_raw_images": raw})).load()) for raw in (False, True)}
    if not modes[True]["patch_mask"].any():
        raise AssertionError("the MPP batch masks no patch")
    logits = {}
    for impl in ("pallas", "xla"):
        task = task_for(impl, attention_dropout=0.0)
        for raw, mpp_batch in modes.items():
            with torch.inference_mode():
                _, (outputs, _) = task.compute_loss(batch_to_device(mpp_batch, task.device),
                                                    deterministic=True)
            logits[(impl, raw)] = {k: outputs[k] for k in ("mlm_logits", "mpp_logits",
                                                           "itm_logits")}
        del task
        torch.cuda.empty_cache()
    raw_vs_host, fail_modes = logits_errors(logits[("pallas", True)], logits[("pallas", False)])
    raw_vs_dense, fail_dense = logits_errors(logits[("pallas", True)], logits[("xla", True)])
    emit({"phase": "pretrain_records_reference", "micro_batch": TRAIN_MICRO,
          "lengths_mean": float(np.mean(micro["lengths"])), "attention_dropout": DROPOUT,
          "loss": losses, "loss_rel_err": loss_err, "loss_bound": LOSS_REL_BOUND,
          "tensors": len(errors) + n_zero, "zero_tensors": n_zero,
          "max_rel_frobenius_err_vs_dense": worst, "worst_tensor": worst_name,
          "largest_errors_vs_dense": top, "bound": TRAIN_GRAD_BOUND,
          "outside_bound_vs_dense": outside,
          "excess_over_dense_vs_fp32": excess,
          "max_dense_vs_fp32": max(dense_err.values()),
          "max_kernels_vs_fp32": max(kernel_err.values()),
          "mpp_batch": {"examples": len(modes[True]["lengths"]),
                        "masked_patches": int(modes[True]["patch_mask"].sum()),
                        "raw_vs_host": raw_vs_host, "raw_vs_dense": raw_vs_dense}})
    if not loss_err <= LOSS_REL_BOUND:
        raise AssertionError(f"loss {losses['kernels']} against dense {losses['dense']}")
    bad = [n for n, e in excess.items() if not e <= TRAIN_GRAD_BOUND]
    if bad:
        raise AssertionError(f"{bad}: gradients outside both rules")
    if fail_modes or fail_dense:
        raise AssertionError(f"MPP batch logits outside their bounds: raw vs host {fail_modes}, "
                             f"raw vs dense {fail_dense}")



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
    entry, fwd_alone = phase_kernel()
    model = MmtClassificationModel(flagship_config("pallas"))
    launches, batch = phase_main(model)
    phase_profile(model, batch, fwd_alone["flagship"])
    phase_reference(model, batch)
    del model, batch
    torch.cuda.empty_cache()
    entry["max_abs_err"] = max(entry["max_abs_err"], phase_kernel_dropout())
    bwd_entry = phase_kernel_bwd()
    task, cfg, train_launches = phase_train()
    # The forward runs on the main paths of retrieval (phase main),
    # pretraining (phase train), the predict CLI (phase predict_cli), int8
    # serving (phase int8), the exported artifacts (phase export),
    # finetuning (phase finetune), continuous finetuning (phase continuous),
    # bf16 gradient accumulation (phase grad_accum) and pretraining from
    # records (phase pretrain_records), the last seven added below; the
    # backward on all of them but retrieval, the predict CLI, int8 and the
    # export.
    entry["launches"] = launches + train_launches["fwd"]
    bwd_entry["launches"] = train_launches["bwd"]
    phase_train_profile(task, cfg, fwd_alone["train"], bwd_entry["ms"])
    del task
    torch.cuda.empty_cache()
    phase_train_reference()
    win_entry = phase_kernel_window()
    win_bwd_entry = phase_kernel_bwd_window()
    task, cfg, win_launches = phase_train_window()
    win_entry["launches"] = win_launches["fwd_window"]
    win_bwd_entry["launches"] = win_launches["bwd_window"]
    phase_train_window_profile(task, cfg)
    del task
    torch.cuda.empty_cache()
    phase_train_window_reference()
    probe_entries = [*phase_probe_split(), *phase_probe_op_cost(), *phase_probe_hopper()]
    entry["launches"] += phase_predict_cli()
    entry["launches"] += phase_int8()
    entry["launches"] += phase_export()
    with tempfile.TemporaryDirectory() as tmp:
        ft_launches, ft_batch, task, ft_restored = phase_finetune(Path(tmp))
        entry["launches"] += ft_launches["fwd"]
        bwd_entry["launches"] += ft_launches["bwd"]
        phase_finetune_profile(task, ft_batch)
        del task
        torch.cuda.empty_cache()
        phase_finetune_reference(Path(tmp), ft_batch)
        cont_launches = phase_continuous(Path(tmp), ft_restored)
        entry["launches"] += cont_launches["fwd"]
        bwd_entry["launches"] += cont_launches["bwd"]
        phase_checkpoint(Path(tmp))
        ga_launches = phase_grad_accum()
        entry["launches"] += ga_launches["fwd"]
        bwd_entry["launches"] += ga_launches["bwd"]
        root = Path(tmp, "wit")
        root.mkdir()
        pr_launches, task, pr_cfg, pr_runs = phase_pretrain_records(root)
        entry["launches"] += pr_launches["fwd"]
        bwd_entry["launches"] += pr_launches["bwd"]
        pr_batch = profile_batch(pr_cfg)
        phase_pretrain_records_profile(task, pr_cfg, pr_batch, pr_runs)
        del task
        torch.cuda.empty_cache()
        phase_pretrain_records_reference(root, pr_batch)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    kernels = {"kernels": [entry, bwd_entry, win_entry, win_bwd_entry, *probe_entries]}
    print(json.dumps(kernels), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.jsonl").write_text("\n".join(_lines + [json.dumps(kernels)]) + "\n")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
