"""Dynamic int8 dense layers (the serving path).

Counterpart of ``mmt_tpu/ops/quant.py``, with its arithmetic in float32:

* Weights: symmetric int8 with one scale per output channel (max |w| over
  the input features / 127), quantized from the float32 parameter on
  every call (JAX quantizes at trace time); the parameters keep the
  ``nn.Linear`` layout, so a float checkpoint loads unchanged.
* Activations: symmetric per-tensor dynamic int8, one scale for the whole
  input tensor (every row of the batch, padded positions included).
* The product accumulates in int32 and is dequantized by
  ``x_scale * w_scale`` (that product first), the bias added in float32,
  then cast to the compute dtype.

On CUDA tensors the int32 product is ``torch._int_mm`` (cuBLASLt; the JAX
package computes it in plain XLA, not in a kernel of its own); on CPU
tensors ``int8_matmul_plain``, the exact product in float64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def quantize_symmetric(w: torch.Tensor, contracting_dims: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per output channel: ``(w_q int8,
    scale float32)``, ``scale`` with the contracting dims kept as size 1,
    ``w ~= w_q * scale``."""
    w = w.to(torch.float32)
    absmax = torch.amax(w.abs(), dim=tuple(contracting_dims), keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def dynamic_quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic symmetric int8: ``(x_q int8, scale float32 0-dim)``.

    ``x`` is cast to float32 before the division (a bf16 tensor divided by
    a float32 0-dim tensor would stay bf16)."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<int32>[M, N] = a [M, K] int8 @ b [N, K]^T int8, exact: a float64
    product (every partial sum is an integer below 2**53 for K < 2**38)."""
    return (a.to(torch.float64) @ b.to(torch.float64).t()).to(torch.int32)


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of a [M, K] and b [N, K]^T, padded to its shape
    rules (M > 16, K and N multiples of 8) with zeros, which add nothing."""
    m, k = a.shape
    n = b.shape[0]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if pad_m or pad_n else out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<int32>[M, N] = a [M, K] int8 @ b [N, K]^T int8: ``torch._int_mm`` on
    CUDA tensors, ``int8_matmul_plain`` on CPU tensors."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.device.type == "cuda":
        return _int_mm_padded(a, b)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    raise ValueError(f"unsupported device {a.device}")


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """The dynamic-int8 ``F.linear``: x [..., in], weight [out, in] float,
    bias [out] -> [..., out] in ``dtype`` (JAX ``int8_dot_general`` + bias)."""
    x_q, x_scale = dynamic_quantize_activations(x)
    w_q, w_scale = quantize_symmetric(weight, contracting_dims=(1,))
    acc = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
    out_scale = x_scale * w_scale.reshape(-1)
    out = acc.to(torch.float32) * out_scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.reshape(*x.shape[:-1], weight.shape[0]).to(dtype)


class Int8Linear(nn.Linear):
    """``nn.Linear`` with the dynamic-int8 compute path: the same
    ``weight`` / ``bias`` parameters, so a float checkpoint loads
    unchanged.  Inference only (rounding has no gradient); ``dtype`` sets
    the output dtype alone (JAX ``Int8Dense`` / ``Int8DenseGeneral``)."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return int8_linear(x, self.weight, self.bias, dtype)


def dense_cls(quantize: Optional[str]) -> type:
    """The linear layer class of a config's ``quantize`` mode."""
    if quantize in ("none", "", None):
        return nn.Linear
    if quantize == "int8_dynamic":
        return Int8Linear
    raise ValueError(f"Unknown quantize mode {quantize!r}; "
                     "expected 'none' or 'int8_dynamic'.")
