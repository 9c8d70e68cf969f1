"""A multi-process dry run of the data-parallel training step on the CPU.

Counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package's
n-device dry run): n ``gloo`` processes (``parallel.launch.run_local``)
take one full pretraining step (MLM + MPP + ITM, two micro-batches, AdamW)
at JAX's tiny geometry on a global batch of 4 n examples, first on an
(n, 1) data x model mesh, then on its (n / 2, 2) variant with the
parameters replicated over the model axis, then on that mesh with the
parameters sharded over the model axis (``param_sharding.shard_params``,
the tiny config's 2 heads -> tp = 2); then the ring-schedule
sequence-sharded attention, forward and backward, over the model groups;
then, at n >= 4, a 4-layer encoder pipelined over an (n / 4, 4) data x
pipe mesh (one layer per stage, 2 micro-batches, remat), an MSE loss
through the pipeline into an AdamW update
(``__graft_entry__.py:338-382``).  Each variant prints its loss; the ranks
must agree on every one.

    python -m mmt_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import sys

import numpy as np


_TINY_ENCODER = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, relative_pos_max_distance=3, relative_vocab_size=12,
                     relative_att_num_core_layers=1, compute_dtype="float32")


def _tiny_task():
    from mmt_tpu_torch.configs import PretrainingTaskConfig, TrainerConfig, override
    from mmt_tpu_torch.train.tasks import PretrainingTask

    enc = _TINY_ENCODER
    cfg = override(PretrainingTaskConfig(), {
        "model": {"encoder": {"mmt": enc},
                  "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]},
        "train_data": {"image_size": 32, "patch_size": 16, "max_seq_len": 12}})
    return PretrainingTask(cfg, override(TrainerConfig(), {"train_steps": 10}), device="cpu")


def tiny_batch(batch: int) -> dict:
    """The JAX dry run's batch (``__graft_entry__.py:163-176``)."""
    rng = np.random.default_rng(0)
    S, N = 12, 4
    return {
        "word_ids": rng.integers(0, 100, (batch, S)).astype(np.int32),
        "segment_ids": np.ones((batch, S), np.int32),
        "patch_embeddings": rng.normal(size=(batch, N, 768)).astype(np.float32),
        "lengths": np.full((batch,), S, np.int32),
        "mlm_positions": rng.integers(6, S, (batch, 3)).astype(np.int32),
        "mlm_label_ids": rng.integers(0, 100, (batch, 3)).astype(np.int32),
        "mlm_label_weights": np.ones((batch, 3), np.float32),
        "mpp_positions": rng.integers(2, 6, (batch, 2)).astype(np.int32),
        "mpp_label_ids": rng.integers(0, 512, (batch, 2)).astype(np.int32),
        "mpp_label_weights": np.ones((batch, 2), np.float32),
        "itm_label_ids": rng.integers(0, 2, (batch,)).astype(np.int32),
        "itm_label_weights": np.ones((batch,), np.float32),
    }


def _rank_main(n: int) -> list:
    """One rank of the dry run; returns the variants' losses."""
    import torch

    from mmt_tpu_torch.configs import OptimizationConfig
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.ops import sharded_attention as sa
    from mmt_tpu_torch.ops.fused_attention import RelGeometry
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.train_state import TrainState

    from mmt_tpu_torch.parallel.param_sharding import shard_params

    pm.init_distributed("cpu")
    batch = tiny_batch(4 * n)
    losses = []
    layouts = [(n, 1, False)]
    if n >= 2 and n % 2 == 0:
        layouts += [(n // 2, 2, False), (n // 2, 2, True)]
    for num_data, num_model, tp in layouts:
        mesh = pm.create_mesh(num_data, num_model)
        task = _tiny_task()
        if tp:
            shard_params(mesh, task.model)
        state = TrainState.create(task.model, create_optimizer(OptimizationConfig(), 10,
                                                               task.model))
        step = task.make_train_step(micro_batch_size=2 * n, mesh=mesh)
        _, metrics = step(state, pm.shard_batch(mesh, batch, "cpu"),
                          DropoutRngs.for_step(1, 0, "cpu"))
        total, count = metrics["total_loss"]
        loss = float(total / count)
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        losses.append(((num_data, num_model, tp), loss))
    if len(layouts) > 1:  # the ring over each model group, forward and backward
        rng = np.random.default_rng(1)
        B, S, H, D = num_data, 16 * num_model, 2, 16
        geo = RelGeometry(text_max_distance=3, num_patch_per_row=2, num_core_layers=1)
        q, k, v = (torch.tensor(rng.normal(size=(B, S, H, D)).astype(np.float32))
                   for _ in range(3))
        table = torch.tensor(rng.normal(size=(12, H, D)).astype(np.float32))
        s = S // num_model
        rows, cols = slice(mesh.data_rank, mesh.data_rank + 1), slice(mesh.model_rank * s,
                                                                      (mesh.model_rank + 1) * s)
        q_l, k_l, v_l = (t[rows, cols].clone().requires_grad_() for t in (q, k, v))
        out = sa.ring_sequence_sharded_relative_attention(
            q_l, k_l, v_l, table, geo, torch.tensor([S]), group=mesh.model_group,
            batch_start=mesh.data_rank, device="cpu")
        out.sum().backward()
        grads = torch.stack([g.abs().sum() for g in (q_l.grad, k_l.grad, v_l.grad)])
        if not torch.isfinite(grads).all():
            raise RuntimeError("non-finite ring gradients")
        losses.append(("ring", float(out.detach().pow(2).mean())))
    if n >= 4 and n % 4 == 0:
        losses.append(("pipeline", _pipeline_step(n, batch)))
    return losses


def _pipeline_step(n: int, batch: dict) -> float:
    """One AdamW step of a 4-layer tiny encoder whose stack is pipelined
    over an (n / 4, 4) data x pipe mesh; returns the global MSE loss."""
    import torch

    from mmt_tpu_torch.configs import OptimizationConfig
    from mmt_tpu_torch.configs.encoder import MmtEncoderConfig
    from mmt_tpu_torch.models import DropoutRngs, MmtEncoder
    from mmt_tpu_torch.models.common import init_params
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.parallel.pipeline import EncoderPipeline, P2PTransport
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import DataParallel, _pipe_gradients

    mesh = pm.create_pipe_mesh(n // 4, 4)
    encoder = MmtEncoder(MmtEncoderConfig(**{**_TINY_ENCODER, "num_hidden_layers": 4}),
                         num_patch_per_row=2, patch_dim=768, device="cpu")
    init_params(encoder, 3, encoder.config.initializer_range)
    encoder.train()
    optimizer = create_optimizer(OptimizationConfig(), 10, encoder)
    local = pm.shard_batch(mesh, batch, "cpu")
    rows, seq_len = local["word_ids"].shape
    target = torch.tensor(np.random.default_rng(1).normal(
        size=(4 * n, seq_len, encoder.config.hidden_size)).astype(np.float32))
    target = target[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    transport = P2PTransport(mesh)
    pipe = EncoderPipeline(encoder, transport, num_micro=2, remat=True)
    rngs = DropoutRngs.for_step(1, 0, "cpu")

    def inputs():
        return encoder.transformer_inputs(local["word_ids"], local["segment_ids"],
                                          local["patch_embeddings"], local["lengths"], rngs)[0]

    def loss_fn(seq):  # this rank's share of the global mean
        return ((seq - target) ** 2).sum() / target.numel() / mesh.num_data

    loss = pipe.run(inputs, loss_fn, local["lengths"], seq_len, rngs, mesh.data_rank,
                    mesh.num_data)
    params = list(encoder.parameters())
    _pipe_gradients(transport, params)
    dp = DataParallel(mesh)
    dp.gradients(params)
    optimizer.step()
    loss = transport.broadcast_from_last(
        torch.zeros(()) if loss is None else loss.detach().clone())
    loss = float(dp.all_reduce(loss))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite pipelined loss {loss}")
    return loss


def dryrun_multichip(n_devices: int) -> None:
    """Runs the dry run on ``n_devices`` gloo processes and prints each
    variant's loss; raises if a rank fails or the ranks disagree."""
    from mmt_tpu_torch.parallel.launch import run_local

    results = run_local(_rank_main, n_devices, n_devices)
    for (layout, loss), *others in zip(results[0], *results[1:]):
        if layout == "ring":
            print(f"dryrun_multichip({n_devices}): ring sequence-sharded attention ok")
            continue
        if any(abs(o[1] - loss) > 1e-6 * max(1.0, abs(loss)) for o in others):
            raise RuntimeError(f"ranks disagree on the loss at {layout}: {[loss] + others}")
        if layout == "pipeline":
            print(f"dryrun_multichip({n_devices}): dp x pp mesh {n_devices // 4}x4 pipelined "
                  f"train ok, loss={loss:.4f}")
            continue
        num_data, num_model, tp = layout
        name = "dp x tp" if tp else "dp" if num_model == 1 else "dp x model"
        print(f"dryrun_multichip({n_devices}): {name} mesh {num_data}x{num_model} ok, "
              f"loss={loss:.4f}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
