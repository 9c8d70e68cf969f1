"""GPipe pipeline parallelism of the encoder's layer stack over the mesh's pipe axis.

Counterpart of ``mmt_tpu/parallel/pipeline.py``.  Consecutive transformer
layers run on successive stages of the ``pipe`` axis, micro-batches stream
through the stages, and each stage hands its activation to the next.

* Parameters: every stage keeps the whole model, as JAX's train state keeps
  the canonical unrolled tree on every device and slices the stacked layers
  by stage inside the step (``pipeline.py:57-68``).  Stage s runs layers
  ``[s L / S, (s + 1) L / S)``; checkpoints stay the one-process
  state_dict.  L must divide by S (ValueError otherwise).
* Schedule (``GPipe``): the M micro-batches go forward through the stages,
  then their gradients come back in the same order, stage by stage.
  Autograd does not cross ranks: a stage's received activation is a leaf
  that requires grad, and its ``.grad`` is what goes back to the previous
  stage.  A stage only receives from the one before it and sends to the one
  after it (the reverse in the backward), so the order cannot deadlock.
* Carry dtype: the activation between stages is the layers' output dtype,
  the compute dtype in pre-activation order and float32 in post-activation
  order (its last LayerNorm); the receive buffers take it (JAX up-casts
  its scan carry for the same reason, ``pipeline.py:147-154``).  The first
  stage's input is the embeddings in the compute dtype, as in the unrolled
  stack.
* Transports: ``P2PTransport`` puts one stage on each rank of
  ``mesh.pipe_group`` (``isend`` / ``irecv``: gloo on the CPU, nccl on
  cards); ``InProcessTransport(S)`` runs every stage in turn in this
  process (the one-card machine, and fast CPU tests).  The second is only
  ever chosen by an explicit argument.
* Dropout, the port's own derivation: micro-batch m's layers take their
  seeds from ``rngs.split(M)[m]``, drawn in layer order (the layer's
  global index), as the port's accumulation step draws micro-batch m's
  streams; its attention hash and hidden masks place the micro-batch's
  rows of a data rank d at ``batch_start = d b`` of ``num_data b`` rows.
  So the pipelined stack equals the unpipelined stack run micro-batch by
  micro-batch on those streams.  (JAX folds per (micro-batch, global
  layer) keys instead, ``pipeline.py:130-141``: a different, equally valid
  derivation.)  ``remat`` recomputes each layer in the backward
  (``torch.utils.checkpoint``, seeds drawn before the call).

The embeddings run on the first stage and the heads and loss on the last
(``EncoderPipeline.run``); the train steps (``train/tasks.py:
make_pipelined_train_step``) then sum every gradient over the pipe group.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from mmt_tpu_torch.models.common import DropoutRngs


def microbatch(x: torch.Tensor, num_micro: int) -> List[torch.Tensor]:
    """[B, ...] -> M micro-batches of B / M consecutive rows."""
    if x.shape[0] % num_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into {num_micro} micro-batches")
    return list(x.split(x.shape[0] // num_micro))


def unmicrobatch(parts: List[torch.Tensor]) -> torch.Tensor:
    """The inverse of ``microbatch``."""
    return torch.cat(parts)


def check_pipe_mesh(mesh) -> None:
    if "pipe" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'pipe' axis")


class P2PTransport:
    """One stage per rank of ``mesh.pipe_group`` (this rank's stage is its
    pipe rank); a one-stage mesh needs no group."""

    def __init__(self, mesh):
        check_pipe_mesh(mesh)
        self.num_stages, self.group = mesh.num_pipe, mesh.pipe_group
        if self.num_stages > 1 and self.group is None:
            raise ValueError(f"{self.num_stages} pipeline stages need a process group")
        self.stages = (mesh.pipe_rank,)
        self._pending = []

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, t: torch.Tensor, src: int, dst: int) -> None:
        t = t.contiguous()
        self._pending.append((dist.isend(t, self._peer(dst), group=self.group), t))

    def recv(self, shape, dtype, device, src: int, dst: int) -> torch.Tensor:
        buf = torch.empty(shape, dtype=dtype, device=device)
        dist.irecv(buf, self._peer(src), group=self.group).wait()
        return buf

    def flush(self) -> None:
        """Waits for this stage's sends."""
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_from_last(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(t, self._peer(self.num_stages - 1), group=self.group)
        return t

    def broadcast_metrics(self, sums: dict, device) -> dict:
        """The last stage's metric pairs on every stage."""
        if self.group is None:
            return sums
        names = [sorted(sums)]
        dist.broadcast_object_list(names, self._peer(self.num_stages - 1), group=self.group,
                                   device=device)
        names = names[0]
        if sums:
            flat = torch.stack([torch.stack([torch.as_tensor(sums[n][0]).float(),
                                             torch.as_tensor(sums[n][1]).float()])
                                for n in names]).to(device)
        else:
            flat = torch.empty(len(names), 2, device=device)
        self.broadcast_from_last(flat)
        return {n: (flat[i, 0], flat[i, 1]) for i, n in enumerate(names)}


class InProcessTransport:
    """Every one of ``num_stages`` stages in this process, in turn: a send
    queues the tensor for the next stage, which takes it when it runs."""

    def __init__(self, num_stages: int):
        self.num_stages = num_stages
        self.stages = tuple(range(num_stages))
        self._queues = collections.defaultdict(collections.deque)

    def send(self, t: torch.Tensor, src: int, dst: int) -> None:
        self._queues[src, dst].append(t.detach())

    def recv(self, shape, dtype, device, src: int, dst: int) -> torch.Tensor:
        t = self._queues[src, dst].popleft()
        if t.shape != tuple(shape) or t.dtype != dtype:
            raise RuntimeError(f"stage {dst} expected {dtype} {tuple(shape)} from stage {src}, "
                               f"got {t.dtype} {tuple(t.shape)}")
        return t.detach()

    def flush(self) -> None:
        pass

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def broadcast_from_last(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def broadcast_metrics(self, sums: dict, device) -> dict:
        return sums


class GPipe:
    """The GPipe schedule of ``stage_fn(stage, m, x) -> y`` over a
    transport's stages, for ``num_micro`` micro-batches whose activations
    between stages are ``carry_dtype`` tensors of ``shape``."""

    def __init__(self, stage_fn: Callable, transport, num_micro: int, shape, carry_dtype,
                 device):
        self.stage_fn, self.transport, self.num_micro = stage_fn, transport, num_micro
        self.shape, self.carry_dtype, self.device = tuple(shape), carry_dtype, device
        self.saved = {}

    @property
    def last(self) -> int:
        return self.transport.num_stages - 1

    def forward(self, inputs: Optional[List[torch.Tensor]]) -> Optional[List[torch.Tensor]]:
        """Runs the forward; ``inputs`` are the first stage's micro-batches
        (None where this process does not run it).  Returns the last stage's
        outputs (None where this process does not run it)."""
        tr = self.transport
        for s in tr.stages:
            for m in range(self.num_micro):
                if s == 0:
                    x = inputs[m]
                else:
                    x = tr.recv(self.shape, self.carry_dtype, self.device, s - 1, s)
                    x.requires_grad_()
                y = self.stage_fn(s, m, x)
                if s < self.last:
                    if y.dtype != self.carry_dtype:
                        raise RuntimeError(f"stage {s} gives {y.dtype}, the carry is "
                                           f"{self.carry_dtype}")
                    tr.send(y.detach(), s, s + 1)
                self.saved[s, m] = (x, y)
        tr.flush()
        if self.last in tr.stages:
            return [self.saved[self.last, m][1] for m in range(self.num_micro)]
        return None

    def backward(self, grads: Optional[List[torch.Tensor]]) -> None:
        """Runs the backward from the gradients of the last stage's outputs
        (None where this process does not run it); the first stage's inputs
        receive theirs by autograd."""
        tr = self.transport
        for s in sorted(tr.stages, reverse=True):
            for m in range(self.num_micro):
                x, y = self.saved.pop((s, m))
                if s == self.last:
                    g = grads[m]
                else:
                    g = tr.recv(y.shape, y.dtype, y.device, s + 1, s)
                torch.autograd.backward(y, g)
                if s > 0:
                    tr.send(x.grad, s, s - 1)
        tr.flush()


class EncoderPipeline:
    """The encoder's layer stack (``encoder.transformer``) as a GPipe
    pipeline over ``transport`` in ``num_micro`` micro-batches."""

    def __init__(self, encoder, transport, num_micro: int, remat: bool = False):
        self.encoder, self.transport, self.num_micro, self.remat = (
            encoder, transport, num_micro, remat)
        self.stack = encoder.transformer
        num_layers, num_stages = len(self.stack.layers), transport.num_stages
        if num_layers % num_stages:
            raise ValueError(f"{num_layers} layers not divisible by {num_stages} pipeline stages")
        self.per_stage = num_layers // num_stages
        cfg = encoder.config
        self.carry_dtype = encoder.dtype if cfg.use_pre_activation_order else torch.float32
        self.has_dropout = bool(cfg.hidden_dropout_prob or cfg.attention_probs_dropout_prob)
        self.gpipe = None

    @property
    def first_here(self) -> bool:
        return 0 in self.transport.stages

    def _seeds(self, rngs, micro_rows: int, data_rank: int, num_data: int) -> list:
        if not self.stack.training:
            return [[None] * len(self.stack.layers)] * self.num_micro
        if rngs is None:
            if self.has_dropout:
                raise ValueError("Pipelined training with dropout needs a dropout rng.")
            rngs = DropoutRngs()
        return [self.stack.layer_seeds(dataclasses.replace(
                    r, batch_start=data_rank * micro_rows, batch_rows=num_data * micro_rows))
                for r in rngs.split(self.num_micro)]

    def forward(self, emb: Optional[torch.Tensor], lengths: torch.Tensor, seq_len: int,
                rngs: Optional[DropoutRngs] = None, data_rank: int = 0,
                num_data: int = 1) -> Optional[torch.Tensor]:
        """The stack over ``emb`` ([B, S, H] in the compute dtype, given on
        the first stage) -> the float32 [B, S, H] sequence output on the last
        stage, a leaf whose gradient ``backward`` takes (None elsewhere).
        Every stage gives ``lengths`` (<int>[B]) and ``seq_len`` (S);
        ``rngs`` are the step's streams; ``data_rank`` of ``num_data`` place
        the rows (module docstring)."""
        lens = microbatch(lengths, self.num_micro)
        rows = lens[0].shape[0]
        seeds = self._seeds(rngs, rows, data_rank, num_data)
        per = self.per_stage

        def stage_fn(s, m, x):
            return self.stack.apply_layers(x, lens[m], seeds[m], range(s * per, (s + 1) * per),
                                           self.remat)

        shape = (rows, seq_len, self.encoder.config.hidden_size)
        self.gpipe = GPipe(stage_fn, self.transport, self.num_micro, shape, self.carry_dtype,
                           lengths.device)
        outs = self.gpipe.forward(microbatch(emb, self.num_micro) if self.first_here else None)
        if outs is None:
            return None
        self._outs = outs
        return unmicrobatch([o.detach() for o in outs]).float().requires_grad_()

    def backward(self, grad: Optional[torch.Tensor]) -> None:
        """The backward of the last ``forward`` from ``grad``, the gradient of
        its sequence output (on the last stage; None elsewhere)."""
        grads = None
        if grad is not None:
            grads = [g.to(o.dtype) for g, o in zip(microbatch(grad, self.num_micro), self._outs)]
            self._outs = None
        self.gpipe.backward(grads)

    def run(self, inputs_fn: Callable, loss_fn: Callable, lengths: torch.Tensor, seq_len: int,
            rngs: Optional[DropoutRngs] = None, data_rank: int = 0, num_data: int = 1):
        """One forward and backward through the pipeline: ``inputs_fn()``
        gives the stack's input on the first stage (the embeddings, whose
        graph its backward reaches), ``loss_fn(sequence_output)`` a loss, or
        a tuple led by one, on the last stage.  Leaves this process's
        gradients in the parameters' ``.grad`` and returns ``loss_fn``'s
        result (None where the last stage does not run)."""
        emb = leaf = None
        if self.first_here:
            emb = inputs_fn()
            leaf = emb.detach().requires_grad_()
        seq = self.forward(leaf, lengths, seq_len, rngs, data_rank, num_data)
        result = grad = None
        if seq is not None:
            result = loss_fn(seq)
            (result[0] if isinstance(result, tuple) else result).backward()
            grad = seq.grad
        self.backward(grad)
        if emb is not None and emb.requires_grad:
            emb.backward(leaf.grad)
        return result


def pipeline_encoder_stack(encoder, emb: Optional[torch.Tensor], lengths: torch.Tensor,
                           seq_len: int, *, transport, num_micro: int, remat: bool = False,
                           rngs: Optional[DropoutRngs] = None, data_rank: int = 0,
                           num_data: int = 1) -> torch.Tensor:
    """The pipelined layer stack over ready transformer inputs (``emb`` on
    the first stage) -> the float32 [B, S, H] sequence output on every
    stage (the last stage's, broadcast over the pipe group); no gradient."""
    with torch.no_grad():
        seq = EncoderPipeline(encoder, transport, num_micro, remat).forward(
            emb, lengths, seq_len, rngs, data_rank, num_data)
        if seq is None:
            seq = torch.empty(lengths.shape[0], seq_len, encoder.config.hidden_size,
                              device=lengths.device)
        return transport.broadcast_from_last(seq.detach())


def pipelined_encoder_sequence_output(encoder, batch: dict, *, mesh, num_micro: int,
                                      remat: bool = False, rngs: Optional[DropoutRngs] = None,
                                      transport=None) -> torch.Tensor:
    """The encoder's ``sequence_output`` with its layer stack pipelined over
    ``mesh``'s pipe axis (``transport``: default one stage per rank of the
    pipe group): the embeddings on the first stage, the result on every
    stage; ``batch`` holds this rank's rows of the encoder's inputs."""
    check_pipe_mesh(mesh)
    transport = transport or P2PTransport(mesh)
    word_ids = batch["word_ids"]
    lengths = batch.get("lengths")
    if lengths is None:
        lengths = torch.full((word_ids.shape[0],), word_ids.shape[1], dtype=torch.int32,
                             device=word_ids.device)
    emb = None
    if 0 in transport.stages:
        with torch.no_grad():
            emb, _ = encoder.transformer_inputs(
                word_ids, batch.get("segment_ids"), batch.get("patch_embeddings"), lengths,
                rngs, batch.get("images"))
    data_rank = mesh.data_rank if mesh.distributed else 0
    return pipeline_encoder_stack(encoder, emb, lengths, word_ids.shape[1], transport=transport,
                                  num_micro=num_micro, remat=remat, rngs=rngs,
                                  data_rank=data_rank, num_data=mesh.num_data)
