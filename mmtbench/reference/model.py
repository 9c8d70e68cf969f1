"""The plain float32 MMT model that judges the benchmark's outputs.

Written from the MMT description (github.com/googleinterns/
multimodal-long-transformer-2021: a BERT-geometry encoder over [CLS],
[PATCH], 196 image patches and text, with 2D relative attention) and kept
independent of the code under test: it imports torch and numpy only, and
takes the weights, the batches and the dropout seeds that the benchmark
made, never anything the program derived from them.

* Embeddings: the word table's rows (ids clipped to the vocabulary), a
  LayerNorm (eps 1e-12) on them alone, embedding dropout, then the segment
  rows (ids outside the segment vocabulary give zero), the absolute
  positions when the configuration has them, and the projected patches
  added in slots [2, 2 + N).
* Layers (pre-activation order): x + drop(att(LN(x))), then
  x + drop(ffn(LN(x))); GELU is the tanh approximation.
* Attention: (q.k + q.R[id(q, k)]) / sqrt(d), ids at or past the relative
  vocabulary give zero bias; a pair across the length boundary gets
  -10000; softmax, then the dropout keep factors of the hash below, then
  p.v.  The ids are the 2D scheme over the first P**2 positions (the
  reference's misalignment with the patch slots kept) and clipped 1D
  offsets over the text.
* Heads: MLM (dense, GELU, LayerNorm, the tied word table, an output
  bias), the ITM head ([CLS], dense, tanh, dense).

``Precision("fp8")`` turns the same model into the control: every matrix
product takes operands rounded to float8 e4m3 with a per-tensor scale and
passes its gradient on rounded to e5m2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -10000.0
LN_EPS = 1e-12
_U32 = 0xFFFFFFFF
_HASH_I, _HASH_J, _HASH_HEAD = 0x9E3779B9, 0x85EBCA6B, 0x27D4EB2D
_HASH_M1, _HASH_M2 = 0x45D9F3B, 0x2C1B3C6D
_BATCH_FOLD = 0x96658E39
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


# ------------------------------------------------------------ precision


def _fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    if x.numel() == 0:
        return x
    scale = _FP8_MAX[dtype] / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _RoundOperand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


class Precision:
    """How the matrix products run: "fp32" (the reference) or "fp8" (the
    control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {name!r}")
        self.name = name

    def _in(self, x):
        return _RoundOperand.apply(x) if self.name == "fp8" else x

    def _out(self, y):
        return _RoundGradient.apply(y) if self.name == "fp8" else y

    def linear(self, x, weight, bias=None):
        y = self._out(F.linear(self._in(x), self._in(weight)))
        return y if bias is None else y + bias

    def einsum(self, eq, a, b):
        return self._out(torch.einsum(eq, self._in(a), self._in(b)))


FP32 = Precision("fp32")


# ------------------------------------------------------------ relative ids


def _ids_1d(off: np.ndarray, max_distance: int) -> np.ndarray:
    pos = np.minimum(np.abs(off), max_distance)
    return np.where(off >= 0, pos, max_distance + pos)


def _ids_2d(dy: np.ndarray, dx: np.ndarray, r: int) -> np.ndarray:
    d = 2 * r + 1
    fine = np.mod(dy * d + dx, d * d)
    up, down, left, right = dy < -r, dy > r, dx < -r, dx > r
    mid_y, mid_x = ~up & ~down, ~left & ~right
    coarse = np.zeros_like(fine)
    directions = [up & mid_x, up & right, mid_y & right, down & right,
                  down & mid_x, down & left, mid_y & left, up & left]
    for i, where in enumerate(directions):
        coarse = np.where(where, d * d + i, coarse)
    return np.where((np.abs(dy) <= r) & (np.abs(dx) <= r), fine, coarse)


def relative_ids(seq_len: int, patches_per_row: int, core: int, text_max: int) -> np.ndarray:
    """<int64>[S, S]: 2D ids among the first P**2 positions, the image-part
    id (text row, image column), the text-part id (image row, text column)
    and clipped 1D ids among the rest."""
    n = patches_per_row**2
    image_part = n + 8 + 2 * text_max + 1
    rows = np.arange(patches_per_row)
    yy, xx = np.meshgrid(rows, rows, indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    ids = np.empty((seq_len, seq_len), np.int64)
    ids[:n, :n] = _ids_2d(yy[None] - yy[:, None], xx[None] - xx[:, None], core)
    ids[:n, n:] = image_part + 1
    ids[n:, :n] = image_part
    t = np.arange(seq_len - n)
    ids[n:, n:] = _ids_1d(t[None] - t[:, None], text_max)
    return ids


# ------------------------------------------------------------ dropout


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def attention_keep(seed: int, rows: torch.Tensor, heads: int, seq_len: int,
                   rate: float) -> torch.Tensor:
    """[B, H, S, S] keep factors (0 or 1/(1 - rate) in float32) of the
    attention dropout: a multiply-xorshift hash of (the example's seed,
    head, query position, key position) in 32-bit arithmetic; the
    example's seed is ``seed + row * 0x96658E39`` (mod 2**32)."""
    dev = rows.device
    pos = torch.arange(seq_len, dtype=torch.int64, device=dev)
    pair = _mul32(pos, _HASH_I)[:, None] ^ _mul32(pos, _HASH_J)[None, :]
    ex = ((seed & _U32) + _mul32(rows.to(torch.int64) & _U32, _BATCH_FOLD)) & _U32
    h = _mul32(torch.arange(heads, dtype=torch.int64, device=dev), _HASH_HEAD)
    x = pair[None, None] ^ ((ex[:, None] + h[None]) & _U32)[:, :, None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_M2)
    x = x ^ (x >> 16)
    keep = (x & 0xFFFFFF) >= int(round(rate * (1 << 24)))
    return keep.to(torch.float32) * float(np.float32(1.0 / (1.0 - rate)))


class StepDropout:
    """The dropout of one training step seeded (``seed``, ``step``), split
    into ``micro`` streams, one per micro-batch: each stream's host
    generator gives two int32 seeds per layer (the attention hash's, then
    the hidden masks' generator's), its device generator the embedding
    mask.  ``rate`` 0 turns it off."""

    def __init__(self, seed: int, step: int, micro: int, rate: float):
        host, dev = np.random.SeedSequence([seed, step]).generate_state(2)
        host_gen = torch.Generator().manual_seed(int(host))
        self.rate = rate
        if micro == 1:
            self.streams = [(host_gen, int(dev))]
        else:
            self.streams = []
            for _ in range(micro):
                h, d = (int(v) for v in torch.randint(0, 1 << 62, (2,), generator=host_gen))
                self.streams.append((torch.Generator().manual_seed(h), d))

    def micro_batch(self, m: int, layers: int) -> "MicroDropout":
        host, dev = self.streams[m]
        seeds = []
        for _ in range(layers):
            attention = int(torch.randint(-(1 << 31), 1 << 31, (), generator=host))
            hidden = int(torch.randint(-(1 << 31), 1 << 31, (), generator=host))
            seeds.append((attention, hidden))
        return MicroDropout(self.rate, dev, seeds)


class MicroDropout:
    """One micro-batch's dropout: the seed of its embedding mask's
    generator and each layer's (attention hash, hidden masks) seeds.  Every
    mask is drawn over the whole micro-batch, so a block of its rows takes
    its rows of the masks."""

    def __init__(self, rate: float, embedding_seed: int, layer_seeds):
        self.rate, self.embedding_seed, self.layer_seeds = rate, embedding_seed, layer_seeds

    def masks(self, seed: int, count: int, shape, rows: slice, device) -> list:
        """The first ``count`` masks of a generator seeded ``seed``, each
        drawn over ``shape``, at ``rows``."""
        gen = torch.Generator(device).manual_seed(seed)
        out = []
        for _ in range(count):
            keep = torch.rand(shape, generator=gen, device=device)[rows] >= self.rate
            out.append(keep.to(torch.float32) / (1.0 - self.rate))
        return out


# ------------------------------------------------------------ the model


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def gelu(x):
    return F.gelu(x, approximate="tanh")


class Geometry:
    """The static shapes of one configuration."""

    def __init__(self, cfg: dict, seq_len: int):
        self.seq_len = seq_len
        self.hidden = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.head_dim = self.hidden // self.heads
        self.layers = cfg["num_hidden_layers"]
        self.vocab = cfg["vocab_size"]
        self.segment_vocab = cfg["segment_vocab_size"]
        self.rel_vocab = cfg["relative_vocab_size"]
        self.patches_per_row = cfg["image_size"] // cfg["patch_size"]
        self.ids = relative_ids(seq_len, self.patches_per_row,
                                cfg["relative_att_num_core_layers"],
                                cfg["relative_pos_max_distance"])
        self.hidden_dropout = cfg["hidden_dropout_prob"]
        self.attention_dropout = cfg["attention_probs_dropout_prob"]


def attention(x, lengths, p, pre, g: Geometry, prec: Precision,
              drop: Optional[MicroDropout], seed: Optional[int], rows):
    b, s, _ = x.shape
    shape = (b, s, g.heads, g.head_dim)
    q = prec.linear(x, p[f"{pre}.query.weight"], p[f"{pre}.query.bias"]).view(shape)
    k = prec.linear(x, p[f"{pre}.key.weight"], p[f"{pre}.key.bias"]).view(shape)
    v = prec.linear(x, p[f"{pre}.value.weight"], p[f"{pre}.value.bias"]).view(shape)
    logits = prec.einsum("bqhd,bkhd->bhqk", q, k)
    table = p[f"{pre}.relative_emb_table"]
    ids = torch.as_tensor(g.ids, device=x.device)
    valid = ids < table.shape[0]
    qr = prec.einsum("bqhd,vhd->bhqv", q, table)
    bias = torch.gather(qr, -1, torch.where(valid, ids, 0)[None, None].expand(b, g.heads, s, s))
    logits = (logits + bias * valid) / math.sqrt(g.head_dim)
    pos = torch.arange(s, device=x.device)
    real = pos[None] < lengths[:, None]
    same_side = real[:, :, None] == real[:, None, :]
    logits = logits + (~same_side)[:, None].to(torch.float32) * NEG_INF
    probs = torch.softmax(logits, dim=-1)
    if drop is not None and g.attention_dropout > 0:
        probs = probs * attention_keep(seed, rows, g.heads, s, g.attention_dropout)
    ctx = prec.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, g.hidden)
    return prec.linear(ctx, p[f"{pre}.output.weight"], p[f"{pre}.output.bias"])


def encode(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], g: Geometry,
           prec: Precision = FP32, drop: Optional[MicroDropout] = None,
           rows: slice = slice(None)) -> torch.Tensor:
    """<float32>[b, S, H]: the encoder's sequence output for ``batch``'s
    rows ``rows`` (the dropout masks are drawn over the whole batch)."""
    full = (batch["word_ids"].shape[0], g.seq_len, g.hidden)
    batch = {k: v[rows] for k, v in batch.items()}
    words = batch["word_ids"].long()
    b, s = words.shape
    dev = words.device
    dropping = drop is not None and g.hidden_dropout > 0
    lengths = batch["lengths"].long()
    emb = p["encoder.word_embeddings.embedding_table"][words.clamp(0, g.vocab - 1)]
    emb = layer_norm(emb, p, "encoder.embeddings_layer_norm")
    if dropping:
        emb = emb * drop.masks(drop.embedding_seed, 1, full, rows, dev)[0]
    seg = batch["segment_ids"].long()
    seg_ok = (seg >= 0) & (seg < g.segment_vocab)
    emb = emb + p["encoder.segment_embeddings.embedding_table"][seg.clamp(0, g.segment_vocab - 1)
                                                               ] * seg_ok[..., None]
    if "encoder.absolute_position_embeddings" in p:
        emb = emb + p["encoder.absolute_position_embeddings"][None, :s]
    patches = batch["patch_embeddings"].to(dev, torch.float32)
    projected = prec.linear(patches, p["encoder.patch_embedding_projection.weight"],
                            p["encoder.patch_embedding_projection.bias"])
    x = emb + F.pad(projected, (0, 0, 2, s - 2 - patches.shape[1]))
    row_ids = torch.arange(full[0], device=dev)[rows]
    for layer in range(g.layers):
        pre = f"encoder.transformer.layers.{layer}"
        seed, hidden = None, (None, None)
        if drop is not None:
            seed, hidden_seed = drop.layer_seeds[layer]
            if dropping:
                hidden = drop.masks(hidden_seed, 2, full, rows, dev)
        h = attention(layer_norm(x, p, f"{pre}.attention_layer_norm"), lengths, p,
                      f"{pre}.attention", g, prec, drop, seed, row_ids)
        x = x + (h if hidden[0] is None else h * hidden[0])
        h = layer_norm(x, p, f"{pre}.ffn_layer_norm")
        h = gelu(prec.linear(h, p[f"{pre}.intermediate.weight"], p[f"{pre}.intermediate.bias"]))
        h = prec.linear(h, p[f"{pre}.ffn_output.weight"], p[f"{pre}.ffn_output.bias"])
        x = x + (h if hidden[1] is None else h * hidden[1])
    return x


def itm_logits(p, sequence, prec: Precision = FP32, head: str = "cls_heads.itm"):
    x = torch.tanh(prec.linear(sequence[:, 0], p[f"{head}.pooler_dense.weight"],
                               p[f"{head}.pooler_dense.bias"]))
    return prec.linear(x, p[f"{head}.out_proj.weight"], p[f"{head}.out_proj.bias"])


def mlm_logits(p, rows, prec: Precision = FP32):
    """MLM logits of the hidden vectors ``rows`` [N, H]."""
    x = gelu(prec.linear(rows, p["masked_lm.transform_dense.weight"],
                         p["masked_lm.transform_dense.bias"]))
    x = layer_norm(x, p, "masked_lm.transform_layer_norm")
    return prec.linear(x, p["encoder.word_embeddings.embedding_table"],
                       p["masked_lm.output_bias"])


def weighted_ce(logits, labels, weights, den, pos_weights=None):
    """Sum(w * pos_w * CE) / den, 0 when den is 0."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    if pos_weights is not None:
        ce = ce * pos_weights
    return torch.where(den > 0, (ce * weights).sum() / den.clamp(min=1e-30), den * 0)


def pretraining_loss(p, batch, g: Geometry, prec: Precision = FP32,
                     drop: Optional[MicroDropout] = None, rows: slice = slice(None)):
    """MLM + ITM on the rows ``rows`` of one micro-batch: MLM counted on
    ITM-positive examples alone, each loss a weighted mean over the whole
    micro-batch (its denominators).  The batch masks no patches, so masked
    patch prediction adds 0."""
    if bool((batch["mpp_label_weights"] != 0).any()):
        raise ValueError("the reference covers batches without masked patches")
    mlm_w = batch["mlm_label_weights"].float() * batch["itm_label_ids"].float()[:, None]
    mlm_den, itm_den = mlm_w.sum(), batch["itm_label_weights"].float().sum()
    seq = encode(p, batch, g, prec, drop, rows)
    mlm_w = mlm_w[rows]
    b_idx, m_idx = torch.nonzero(mlm_w > 0, as_tuple=True)
    positions = batch["mlm_positions"][rows].long()[b_idx, m_idx]
    logits = mlm_logits(p, seq[b_idx, positions], prec)
    mlm = weighted_ce(logits, batch["mlm_label_ids"][rows].long()[b_idx, m_idx],
                      mlm_w[b_idx, m_idx], mlm_den)
    itm = weighted_ce(itm_logits(p, seq, prec), batch["itm_label_ids"][rows],
                      batch["itm_label_weights"][rows].float(), itm_den)
    return mlm + itm


def classification_loss(p, batch, g: Geometry, prec: Precision = FP32,
                        drop: Optional[MicroDropout] = None, rows: slice = slice(None)):
    """The ITM head's two-class cross entropy on the rows ``rows``, weighted
    by the label and positive weights, over the whole batch's label
    weights."""
    den = batch["label_weights"].float().sum()
    seq = encode(p, batch, g, prec, drop, rows)
    return weighted_ce(itm_logits(p, seq, prec), batch["label_ids"][rows],
                       batch["label_weights"][rows].float(), den,
                       batch["pos_weights"][rows].float())


@torch.no_grad()
def itm_probabilities(p, batch, g: Geometry, prec: Precision = FP32) -> torch.Tensor:
    """<float32>[B]: softmax of the ITM logits, class 1, no dropout."""
    return torch.softmax(itm_logits(p, encode(p, batch, g, prec), prec), -1)[:, 1]
