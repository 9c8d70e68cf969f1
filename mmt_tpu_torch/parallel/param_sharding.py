"""Megatron-style tensor parallelism of the parameters over the mesh's model axis.

Counterpart of ``mmt_tpu/parallel/param_sharding.py``.  JAX states the
rules as parameter shardings and lets GSPMD place the collectives; here the
same rules pick the parameters, ``shard_params`` keeps each one's slice for
this rank, and the modules run the collectives themselves over
``mesh.model_group`` (``torch.distributed``).

Rules (per Flax path, as JAX's regexes; ``convert.flax_paths`` names the
port's parameters so):

  attention q/k/v kernels  [H, heads, dh]  -> (None, model, None)
  attention q/k/v bias     [heads, dh]     -> (model, None)
  attention output kernel  [heads, dh, H]  -> (model, None, None)
  ffn intermediate kernel  [H, I]          -> (None, model)
  ffn intermediate bias    [I]             -> (model,)
  ffn output kernel        [I, H]          -> (model, None)
  word embedding table     [V, E]          -> (model, None)  (vocabulary)
  everything else          replicated

A rule whose dimension does not divide by the model axis's size leaves
that parameter replicated, and a model axis of size 1 replicates every
parameter, as in JAX.  In the port's layouts (``nn.Linear`` weights are
[out, in]) q/k/v and the intermediate layer keep rows of their weight
(column-parallel), the attention output and ``ffn_output`` columns
(row-parallel), the table its rows.

What the sharded modules do (``models/relative_attention.py``,
``models/embeddings.py``):

* column-parallel input: the identity in the forward, the input gradient
  summed over the group in the backward (``TensorParallel.copy``);
* row-parallel output: the partial products summed over the group
  (``TensorParallel.reduce``), then the replicated bias, added once;
* attention: each rank runs its ``H / tp`` heads with ``head_start = rank
  H / tp`` on its heads' slice of the replicated ``relative_emb_table``;
  that table's gradient from one rank covers only its heads, so it is
  summed over the group (``tp_partial``);
* vocabulary-parallel embedding: ids clamped first (JAX's clip mode), each
  rank looks up its row range, zero elsewhere, summed over the group;
* the tied MLM projection: each rank's logits over its rows, gathered over
  the group before the loss (``TensorParallel.gather``; its backward is a
  slice);
* the optimizer's clipping norm: each sharded parameter carries
  ``norm_sum`` (``TensorParallel.all_sum``), which sums its slices'
  squares over the group (``train/optimizer.py``).

Replicated parameters stay bit-equal over the group: the data-parallel
step takes their gradients from the group's first rank
(``train.tasks.DataParallel``).  ``shard_params_in_process`` runs every
rank of the model axis in one process instead (the parameters stay whole,
each rank's share taken as a slice of them, the partial products summed
in rank order): the one-card machine and the CPU tests drive it.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from mmt_tpu_torch.convert import flax_paths
from mmt_tpu_torch.models.embeddings import EmbeddingLookup
from mmt_tpu_torch.models.relative_attention import RelativeAttention

MODEL = "model"
# (Flax path pattern, spec over the Flax shape, the dimension of the port's
# tensor that it splits)
_RULES = [
    (r".*/attention/(query|key|value)/kernel", (None, MODEL, None), 0),
    (r".*/attention/(query|key|value)/bias", (MODEL, None), 0),
    (r".*/attention/output/kernel", (MODEL, None, None), 1),
    (r".*/intermediate/kernel", (None, MODEL), 0),
    (r".*/intermediate/bias", (MODEL,), 0),
    (r".*/ffn_output/kernel", (MODEL, None), 1),
    (r".*word_embeddings/embedding_table", (MODEL, None), 0),
]


def param_spec(path: str) -> tuple:
    """The spec of the Flax path ``path`` (JAX's ``PartitionSpec`` as a
    tuple); () is replicated."""
    for pattern, spec, _ in _RULES:
        if re.fullmatch(pattern, path):
            return spec
    return ()


def _torch_dim(path: str) -> int:
    return next(dim for pattern, _, dim in _RULES if re.fullmatch(pattern, path))


# ---------------------------------------------------------------- collectives


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return grad[..., rank * ctx.width:(rank + 1) * ctx.width].contiguous(), None


class TensorParallel:
    """The model axis as a sharded module sees it: ``size`` ranks, of which
    this process runs ``ranks`` (its own model rank under a process group;
    all of them in process), and ``group``, the process group that joins
    the others (None in process)."""

    def __init__(self, size: int, ranks: Sequence[int], group=None):
        self.size, self.ranks, self.group = size, tuple(ranks), group

    def piece(self, p: torch.Tensor, i: int, dim: int = 0) -> torch.Tensor:
        """The share of ``self.ranks[i]`` of a sharded parameter ``p`` (which
        holds the shares of this process's ranks along ``dim``)."""
        n = p.shape[dim] // len(self.ranks)
        return p.narrow(dim, i * n, n)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel input: x, whose gradient is summed over the group."""
        return x if self.group is None else _CopyToGroup.apply(x, self.group)

    def reduce(self, partials: list) -> torch.Tensor:
        """The float32 sum of the ranks' partial products (``partials``, this
        process's ranks in order), over the group."""
        out = partials[0].float()
        for p in partials[1:]:
            out = out + p.float()
        return out if self.group is None else _ReduceFromGroup.apply(out, self.group)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the group (a sharded parameter's ``norm_sum``: the
        optimizer's clipping norm over the whole tensor)."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, parts: list) -> torch.Tensor:
        """The ranks' column blocks ``parts`` joined along the last dimension,
        over the group, in rank order."""
        out = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        return out if self.group is None else _GatherFromGroup.apply(out, self.group)


# ------------------------------------------------------------------ sharding


def _modules(model, name: str):
    """(parent of the parameter's module, its module, the leaf name)."""
    module_name, _, leaf = name.rpartition(".")
    parent_name = module_name.rpartition(".")[0]
    return model.get_submodule(parent_name), model.get_submodule(module_name), leaf


def _flax_shape(model, name: str, p: torch.Tensor) -> tuple:
    """The Flax shape of the port's parameter ``name`` (``convert``'s
    layouts)."""
    parent, module, leaf = _modules(model, name)
    if isinstance(parent, RelativeAttention):  # q / k / v / output
        heads, head_dim = parent.num_heads, parent.head_dim
        if module is parent.output:
            return (heads, head_dim, p.shape[0]) if leaf == "weight" else tuple(p.shape)
        return (p.shape[1], heads, head_dim) if leaf == "weight" else (heads, head_dim)
    if leaf == "weight" and isinstance(module, torch.nn.Linear):
        return (p.shape[1], p.shape[0])
    return tuple(p.shape)


def sharding_plan(model: torch.nn.Module, size: int) -> Dict[str, tuple]:
    """Parameter name -> its spec on a model axis of ``size`` ranks, after
    the fallback: () where the rule's dimension does not divide or ``size``
    is 1."""
    params = dict(model.named_parameters())
    plan = {}
    for name, path in flax_paths(model).items():
        spec = param_spec(path) if size > 1 else ()
        if spec and _flax_shape(model, name, params[name])[spec.index(MODEL)] % size:
            spec = ()
        plan[name] = spec
    return plan


def _shard(model: torch.nn.Module, tp: TensorParallel) -> Dict[str, tuple]:
    plan = sharding_plan(model, tp.size)
    paths = flax_paths(model)
    params = dict(model.named_parameters())
    for name, spec in plan.items():
        if not spec:
            continue
        p = params[name]
        if tp.group is not None:  # keep this rank's slice
            dim = _torch_dim(paths[name])
            n = p.shape[dim] // tp.size
            with torch.no_grad():
                p.data = p.data.narrow(dim, tp.ranks[0] * n, n).clone()
            p.tp_shard, p.norm_sum = tp, tp.all_sum
        parent, module, _ = _modules(model, name)
        owner = module if isinstance(module, EmbeddingLookup) else parent
        owner.tp = tp
        if isinstance(owner, RelativeAttention) and owner.relative_emb_table is not None \
                and tp.group is not None:
            owner.relative_emb_table.tp_partial = tp
    return plan


def shard_params(mesh, model: torch.nn.Module) -> Dict[str, tuple]:
    """Shards ``model`` in place over ``mesh``'s model axis (module
    docstring): every matching parameter keeps this rank's slice and its
    module runs the collectives over ``mesh.model_group``.  Call it before
    the optimizer is built.  Returns each parameter's spec (() replicated);
    a model axis of size 1 replicates everything, as in JAX."""
    group = mesh.model_group if mesh.num_model > 1 else None
    if mesh.num_model > 1 and group is None:
        raise ValueError(f"a model axis of {mesh.num_model} needs a process group")
    return _shard(model, TensorParallel(mesh.num_model, (mesh.model_rank,), group))


def shard_params_in_process(model: torch.nn.Module, size: int) -> Dict[str, tuple]:
    """Runs ``model`` as ``size`` tensor-parallel ranks in this process: the
    parameters stay whole, and each sharded module computes rank by rank on
    its slices, summing the partial products in rank order where the ranks
    would all-reduce them.  Returns each parameter's spec."""
    return _shard(model, TensorParallel(size, range(size)))


def tp_param_kind(p: torch.Tensor) -> Optional[str]:
    """"shard" for a parameter that holds a rank's slice, "partial" for one
    whose gradient is summed over the model group, else None."""
    if getattr(p, "tp_shard", None) is not None:
        return "shard"
    if getattr(p, "tp_partial", None) is not None:
        return "partial"
    return None
