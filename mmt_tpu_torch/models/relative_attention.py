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

``geometry.window > 0`` restricts attention to the sliding-window +
prefix-global pattern, in both impls (the kernels' windowed variants on
CUDA tensors).

Dropout is active in ``train()`` mode: hidden dropout on the attention and
FFN outputs, and attention-probs dropout inside the attention op.  A layer
call takes both from its ``LayerSeeds``, drawn on the host before it runs:
the hidden masks from a device generator seeded with ``seeds.hidden``, the
attention mask from the hash of ``seeds.attention``.  Both attention impls
apply the same hash mask (``fused_attention.dropout_keep``) for a given
seed, so they agree in training too (the JAX package's dense path draws a
Bernoulli mask instead).

``remat=True`` wraps each layer in ``torch.utils.checkpoint`` (the
counterpart of ``nn.remat`` at ``mmt_tpu/models/relative_attention.py:299``):
only the layer's input is kept, and the backward runs the layer's forward
again, attention kernel included, from the same seeds, so remat on and off
give the same function and the same gradients.

``quantize="int8_dynamic"`` makes the q/k/v/output projections and the
FFN's two layers ``ops.quant.Int8Linear`` (dynamic int8, inference only:
``train()`` mode raises); LayerNorm, attention, embeddings and heads stay
as they are (``mmt_tpu/models/relative_attention.py:86-91,217``).

Parameter layout: the q/k/v projections are ``nn.Linear(hidden, A*D)``
(Flax DenseGeneral kernel ``[hidden, A, D]``), the output projection
``nn.Linear(A*D, hidden)`` (kernel ``[A, D, hidden]``), and the relative
table keeps the Flax layout ``[V, A, D]``.

Tensor parallelism (``parallel/param_sharding.py`` sets ``tp``): an
attention module whose ``tp`` is set holds its heads' rows of q/k/v and
their columns of the output projection for the ranks it runs, and runs
each rank's heads with ``head_start`` on its slice of the (replicated)
relative table, summing the output projections' partial products over
the model axis before the (replicated) bias; a layer whose ``tp`` is set
does the same with the FFN's intermediate width.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmt_tpu_torch.models.common import DropoutRngs, LayerSeeds, dense, gelu, layer_norm
from mmt_tpu_torch.ops.fused_attention import (
    RelGeometry,
    relative_attention,
    relative_attention_plain,
)
from mmt_tpu_torch.ops.quant import dense_cls

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
        quantize: str = "none",
        device=None,
    ):
        super().__init__()
        linear = dense_cls(quantize)
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
        self.quantize = quantize
        self.query = linear(hidden_size, hidden_size, device=device)
        self.key = linear(hidden_size, hidden_size, device=device)
        self.value = linear(hidden_size, hidden_size, device=device)
        self.relative_emb_table = None
        if relative_vocab_size:
            self.relative_emb_table = nn.Parameter(torch.empty(
                relative_vocab_size, num_heads, self.head_dim, device=device))
        self.output = linear(hidden_size, hidden_size, device=device)
        self.tp = None  # a parallel.param_sharding.TensorParallel once sharded

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                dropout_seed: Optional[int] = None, batch_start: int = 0) -> torch.Tensor:
        """``dropout_seed``: the int32 seed of the attention dropout, used in
        ``train()`` mode at a rate > 0 (required there); ``batch_start``:
        the global index of the batch's first example, which its hash
        takes."""
        if self.quantize != "none" and self.training:
            raise ValueError(
                "quantize='int8_dynamic' is an inference-only path "
                "(rounding has zero gradient); train with quantize='none'.")
        rate, seed = 0.0, None
        if self.training and self.attention_dropout > 0.0:
            rate, seed = self.attention_dropout, dropout_seed
        if self.tp is not None:
            return self._sharded(x, lengths, rate, seed, batch_start)
        batch, seq_len, _ = x.shape
        shape = (batch, seq_len, self.num_heads, self.head_dim)
        q = dense(x, self.query, self.dtype).view(shape)
        k = dense(x, self.key, self.dtype).view(shape)
        v = dense(x, self.value, self.dtype).view(shape)
        ctx = self._attend(q, k, v, self.relative_emb_table, lengths, rate, seed, batch_start)
        return dense(ctx.reshape(batch, seq_len, -1), self.output, self.dtype)

    def _attend(self, q, k, v, table, lengths, rate, seed, batch_start, head_start=0):
        if self.attention_impl == "pallas":
            return relative_attention(q, k, v, table, self.geometry, lengths, rate, seed,
                                      device=q.device.type, batch_start=batch_start,
                                      head_start=head_start)
        ctx, _ = relative_attention_plain(q, k, v, table, self.geometry, lengths, rate, seed,
                                          batch_start=batch_start, head_start=head_start)
        return ctx

    def _sharded(self, x, lengths, rate, seed, batch_start):
        """The head-sharded forward: each rank's heads, their partial output
        projections summed over the model axis, then the bias."""
        tp, dt = self.tp, self.dtype
        batch, seq_len, _ = x.shape
        heads = self.num_heads // tp.size
        x = tp.copy(x.to(dt))
        partials = []
        for i, rank in enumerate(tp.ranks):
            q, k, v = (F.linear(x, tp.piece(m.weight, i).to(dt), tp.piece(m.bias, i).to(dt))
                       .view(batch, seq_len, heads, self.head_dim)
                       for m in (self.query, self.key, self.value))
            table = self.relative_emb_table
            if table is not None:
                table = table[:, rank * heads:(rank + 1) * heads]
            ctx = self._attend(q, k, v, table, lengths, rate, seed, batch_start, rank * heads)
            partials.append(F.linear(ctx.reshape(batch, seq_len, -1),
                                     tp.piece(self.output.weight, i, 1).to(dt)))
        return (tp.reduce(partials) + self.output.bias.to(dt)).to(dt)


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
        quantize: str = "none",
        device=None,
    ):
        super().__init__()
        linear = dense_cls(quantize)
        self.dtype = dtype
        self.use_pre_activation_order = use_pre_activation_order
        self.hidden_dropout = hidden_dropout
        self.attention = RelativeAttention(
            hidden_size, num_heads, relative_vocab_size, geometry, dtype,
            attention_impl, attention_dropout, quantize, device=device)
        self.attention_layer_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.ffn_layer_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.intermediate = linear(hidden_size, intermediate_size, device=device)
        self.ffn_output = linear(intermediate_size, hidden_size, device=device)
        self.tp = None  # a parallel.param_sharding.TensorParallel once the FFN is sharded

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            h = gelu(dense(h, self.intermediate, self.dtype))
            return dense(h, self.ffn_output, self.dtype)
        tp, dt = self.tp, self.dtype
        h = tp.copy(h.to(dt))
        partials = [F.linear(gelu(F.linear(h, tp.piece(self.intermediate.weight, i).to(dt),
                                           tp.piece(self.intermediate.bias, i).to(dt))),
                             tp.piece(self.ffn_output.weight, i, 1).to(dt))
                    for i in range(len(tp.ranks))]
        return (tp.reduce(partials) + self.ffn_output.bias.to(dt)).to(dt)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                seeds: Optional[LayerSeeds] = None) -> torch.Tensor:
        """``seeds`` carries all of the call's randomness in ``train()`` mode
        (drawn here from torch's default CPU generator when None)."""
        if self.training and seeds is None:
            seeds = DropoutRngs().layer_seeds()
        hidden, attention_seed, batch_start = DropoutRngs(), None, 0
        if seeds is not None:
            hidden = DropoutRngs(batch_start=seeds.batch_start, batch_rows=seeds.batch_rows)
            attention_seed, batch_start = seeds.attention, seeds.batch_start
        if self.training and self.hidden_dropout > 0.0:
            hidden.device = torch.Generator(device=x.device).manual_seed(seeds.hidden)

        def drop(h):
            return hidden.dropout(h, self.hidden_dropout, self.training)

        if self.use_pre_activation_order:
            x = x + drop(self.attention(
                layer_norm(x, self.attention_layer_norm).to(self.dtype), lengths,
                attention_seed, batch_start))
            return x + drop(self._ffn(layer_norm(x, self.ffn_layer_norm).to(self.dtype)))
        x = layer_norm(x + drop(self.attention(x, lengths, attention_seed, batch_start)),
                       self.attention_layer_norm)
        return layer_norm(x + drop(self._ffn(x.to(self.dtype))), self.ffn_layer_norm)


class RelativeTransformerLayers(nn.Module):
    def __init__(self, num_hidden_layers: int, remat: bool = False, **layer_kwargs):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            RelativeTransformerLayer(**layer_kwargs) for _ in range(num_hidden_layers))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rngs: Optional[DropoutRngs] = None) -> torch.Tensor:
        return self.apply_layers(x, lengths, self.layer_seeds(rngs), range(len(self.layers)),
                                 self.remat)

    def layer_seeds(self, rngs: Optional[DropoutRngs] = None) -> list:
        """Every layer's seeds for one call, in layer order (None each in
        ``eval()`` mode), drawn before any runs, so that a recompute replays
        them."""
        rngs = rngs or DropoutRngs()
        return [rngs.layer_seeds() if self.training else None for _ in self.layers]

    def apply_layers(self, x: torch.Tensor, lengths: torch.Tensor, seeds: list, indices,
                     remat: bool) -> torch.Tensor:
        """Layers ``indices`` (in order) on x, layer i with ``seeds[i]``;
        ``remat`` recomputes each one's forward in the backward."""
        for i in indices:
            layer = self.layers[i]
            if remat and torch.is_grad_enabled():
                # The layer draws nothing from torch's default generators.
                x = checkpoint(layer, x, lengths, seeds[i], use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, lengths, seeds[i])
        return x
