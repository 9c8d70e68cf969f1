"""Relative-bias multi-head attention and the transformer stack.

Torch counterpart of ``mmt_tpu/models/relative_attention.py``:

* score(b,h,q,k) = (q . k  +  q . R[id(q,k), h]) / sqrt(head_dim), with
  out-of-vocabulary relative ids giving **zero** bias;
* pairs across the length boundary get -10000;
* post order: x = LN(x + drop(att(x))); x = LN(x + drop(ffn(x)))
  pre order:  x = x + drop(att(LN(x))); x = x + drop(ffn(LN(x)));
* the FFN uses the tanh-approximated GELU.

``attention_impl="xla"`` runs the dense path through autograd
(``relative_attention_plain``); ``"pallas"`` runs the fused op
(``relative_attention``: the Hopper forward and backward kernels on CUDA
tensors, their plain versions on CPU tensors).  Both derive the id map
from the static geometry and the padding mask from ``lengths``.

Dropout is active in ``train()`` mode: hidden dropout on the attention and
FFN outputs from the device stream of ``DropoutRngs``, and attention-probs
dropout inside the attention op, from one int32 seed per layer per call
drawn on the host.  Both attention impls apply the same hash mask
(``fused_attention.dropout_keep``) for a given seed, so they agree in
training too (the JAX package's dense path draws a Bernoulli mask
instead).

Parameter layout: the q/k/v projections are ``nn.Linear(hidden, A*D)``
(Flax DenseGeneral kernel ``[hidden, A, D]``), the output projection
``nn.Linear(A*D, hidden)`` (kernel ``[A, D, hidden]``), and the relative
table keeps the Flax layout ``[V, A, D]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmt_tpu_torch.models.common import DropoutRngs, dense, gelu, layer_norm
from mmt_tpu_torch.ops.fused_attention import (
    RelGeometry,
    relative_attention,
    relative_attention_plain,
)

ATTENTION_IMPLS = ("xla", "pallas")


class RelativeAttention(nn.Module):
    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        relative_vocab_size: Optional[int],
        geometry: Optional[RelGeometry],
        dtype: torch.dtype,
        attention_impl: str = "xla",
        attention_dropout: float = 0.0,
        device=None,
    ):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by {num_heads} heads")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                             f"got {attention_impl!r}")
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.geometry = geometry
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.attention_dropout = attention_dropout
        self.query = nn.Linear(hidden_size, hidden_size, device=device)
        self.key = nn.Linear(hidden_size, hidden_size, device=device)
        self.value = nn.Linear(hidden_size, hidden_size, device=device)
        self.relative_emb_table = None
        if relative_vocab_size:
            self.relative_emb_table = nn.Parameter(torch.empty(
                relative_vocab_size, num_heads, self.head_dim, device=device))
        self.output = nn.Linear(hidden_size, hidden_size, device=device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rngs: Optional[DropoutRngs] = None) -> torch.Tensor:
        batch, seq_len, _ = x.shape
        shape = (batch, seq_len, self.num_heads, self.head_dim)
        q = dense(x, self.query, self.dtype).view(shape)
        k = dense(x, self.key, self.dtype).view(shape)
        v = dense(x, self.value, self.dtype).view(shape)
        rate, seed = 0.0, None
        if self.training and self.attention_dropout > 0.0:
            rate, seed = self.attention_dropout, (rngs or DropoutRngs()).seed()
        if self.attention_impl == "pallas":
            ctx = relative_attention(q, k, v, self.relative_emb_table, self.geometry, lengths,
                                     rate, seed, device=x.device.type)
        else:
            ctx, _ = relative_attention_plain(
                q, k, v, self.relative_emb_table, self.geometry, lengths, rate, seed)
        return dense(ctx.reshape(batch, seq_len, -1), self.output, self.dtype)


class RelativeTransformerLayer(nn.Module):
    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        intermediate_size: int,
        relative_vocab_size: Optional[int],
        geometry: Optional[RelGeometry],
        dtype: torch.dtype,
        use_pre_activation_order: bool = False,
        attention_impl: str = "xla",
        hidden_dropout: float = 0.0,
        attention_dropout: float = 0.0,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.use_pre_activation_order = use_pre_activation_order
        self.hidden_dropout = hidden_dropout
        self.attention = RelativeAttention(
            hidden_size, num_heads, relative_vocab_size, geometry, dtype,
            attention_impl, attention_dropout, device=device)
        self.attention_layer_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.ffn_layer_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.intermediate = nn.Linear(hidden_size, intermediate_size, device=device)
        self.ffn_output = nn.Linear(intermediate_size, hidden_size, device=device)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        h = gelu(dense(h, self.intermediate, self.dtype))
        return dense(h, self.ffn_output, self.dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rngs: Optional[DropoutRngs] = None) -> torch.Tensor:
        rngs = rngs or DropoutRngs()

        def drop(h):
            return rngs.dropout(h, self.hidden_dropout, self.training)

        if self.use_pre_activation_order:
            x = x + drop(self.attention(
                layer_norm(x, self.attention_layer_norm).to(self.dtype), lengths, rngs))
            return x + drop(self._ffn(layer_norm(x, self.ffn_layer_norm).to(self.dtype)))
        x = layer_norm(x + drop(self.attention(x, lengths, rngs)), self.attention_layer_norm)
        return layer_norm(x + drop(self._ffn(x.to(self.dtype))), self.ffn_layer_norm)


class RelativeTransformerLayers(nn.Module):
    def __init__(self, num_hidden_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            RelativeTransformerLayer(**layer_kwargs) for _ in range(num_hidden_layers))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rngs: Optional[DropoutRngs] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, lengths, rngs)
        return x
