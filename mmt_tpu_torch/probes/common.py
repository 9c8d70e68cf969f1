"""Pieces shared by the probe modules: timing, inputs, checks."""

from __future__ import annotations

import subprocess
from typing import Sequence

import numpy as np
import torch

from mmt_tpu_torch.ops.fused_attention import RelGeometry

# The retrieval path's attention shape and relative-id scheme.
SEQ_LEN, HEADS, HEAD_DIM, REL_VOCAB = 4096, 12, 64, 49
BATCH = 32
FLAGSHIP = RelGeometry(text_max_distance=12, num_patch_per_row=14, num_core_layers=1)
TILE = 64


def require_cuda(**tensors) -> None:
    """The probes have no CPU path: a tensor that is not on the card raises."""
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the probe kernels run on CUDA "
                             "tensors only (their plain versions are separate functions)")


def raise_on_error(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.mmt_cuda_error_string(err).decode()})")


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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def attention_inputs(lengths: Sequence[int], seed: int, seq_len: int = SEQ_LEN,
                     heads: int = HEADS, device="cuda"):
    """Seeded bf16 q, k, v [B, S, H, 64], an fp32 table [49, H, 64] and
    int32 lengths, made with numpy."""
    rng = np.random.default_rng(seed)
    shape = (len(lengths), seq_len, heads, HEAD_DIM)
    dev = torch.device(device)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)
               for _ in range(3))
    table = torch.from_numpy(
        rng.standard_normal((REL_VOCAB, heads, HEAD_DIM), np.float32)).to(dev)
    return q, k, v, table, torch.tensor(list(lengths), dtype=torch.int32, device=dev)


def retrieval_lengths(seed: int = 2, batch: int = BATCH, seq_len: int = SEQ_LEN):
    """Lengths ~ U[S / 2, S], the retrieval path's mix."""
    return np.random.default_rng(seed).integers(seq_len // 2, seq_len + 1, batch).tolist()
