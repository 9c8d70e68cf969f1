"""Rank-side code of the port's multi-process CPU tests.

Each function runs on every rank of a ``gloo`` group started by
``mmt_tpu_torch.parallel.launch.run_local`` and returns its rank's results
as numpy arrays; the test files hold them against the JAX package.  This
module imports no JAX, so that the ranks start fast.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return None if t is None else t.detach().float().numpy()


def sharded_attention_cases(path: str, num_data: int, num_model: int) -> dict:
    """Every case of ``path`` (an ``.npz`` of inputs, see
    ``test_torch_sharded_attention``) through the port's sharded wrappers
    on a (num_data, num_model) mesh: this rank's output and the gradients
    of sum(out * w)."""
    from mmt_tpu_torch.ops import fused_attention as fa
    from mmt_tpu_torch.ops import sharded_attention as sa
    from mmt_tpu_torch.parallel import mesh as pm

    pm.init_distributed("cpu")
    mesh = pm.create_mesh(num_data, num_model)
    cases = np.load(path, allow_pickle=True)["cases"].item()
    out = {}
    for name, case in cases.items():
        batch, seq = case["q"].shape[:2]
        b, s = batch // num_data, seq // num_model
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        cols = slice(mesh.model_rank * s, (mesh.model_rank + 1) * s)
        q, k, v, w = (torch.tensor(case[x][rows, cols], requires_grad=x != "w")
                      for x in ("q", "k", "v", "w"))
        table = case.get("table")
        table = torch.tensor(table, requires_grad=True) if table is not None else None
        geo = fa.RelGeometry(**case["geometry"]) if case.get("geometry") else None
        fn = (sa.ring_sequence_sharded_relative_attention if case["schedule"] == "ring"
              else sa.sequence_sharded_relative_attention)
        o = fn(q, k, v, table, geo, torch.tensor(case["lengths"][rows]),
               group=mesh.model_group, data_group=mesh.data_group,
               batch_start=mesh.data_rank * b, dropout_rate=case.get("rate", 0.0),
               dropout_seed=case.get("seed"), device="cpu")
        (o * w).sum().backward()
        out[name] = {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad),
                     "drel": _np(table.grad) if table is not None else None}
    return out


def data_parallel_step(task_cfg: dict, trainer: dict, params_path: str, batch: dict,
                       ckpt_dir: str) -> dict:
    """One pretraining step on this rank's slice of ``batch`` with the
    data-parallel step, replicated AdamW then ZeRO-1 from the same
    parameters; the ZeRO-1 state is checkpointed in ``ckpt_dir`` and
    restored into a fresh ZeRO-1 optimizer."""
    from mmt_tpu_torch.configs import PretrainingTaskConfig, TrainerConfig, override
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.parallel import zero
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.tasks import PretrainingTask
    from mmt_tpu_torch.train.train_state import TrainState

    pm.init_distributed("cpu")
    mesh = pm.create_mesh()
    torch.use_deterministic_algorithms(True)
    cfg = override(PretrainingTaskConfig(), task_cfg)
    tcfg = override(TrainerConfig(), trainer)
    task = PretrainingTask(cfg, tcfg, device="cpu")
    initial = torch.load(params_path, weights_only=True)
    local = pm.shard_batch(mesh, batch, "cpu")
    out = {}
    for zero1 in (False, True):
        task.model.load_state_dict(initial)
        optimizer = create_optimizer(tcfg.optimizer_config, tcfg.train_steps, task.model)
        if zero1:
            zero.shard_opt_state(mesh, optimizer)
        grads = {}
        real_step = optimizer.step

        def recording_step():
            grads.update({n: p.grad.numpy().copy() for n, p in task.model.named_parameters()})
            real_step()

        optimizer.step = recording_step
        step = task.make_train_step(tcfg.micro_batch_size, mesh=mesh)
        _, metrics = step(TrainState.create(task.model, optimizer), local)
        key = "zero1" if zero1 else "replicated"
        out[key] = {
            "params": {n: p.detach().numpy().copy() for n, p in task.model.named_parameters()},
            "metrics": {n: (float(t), float(c)) for n, (t, c) in metrics.items()},
            "grads": grads,
            "local_moment_rows": {n: int(optimizer.mu[n].shape[0]) for n in optimizer.slices},
        }
        if zero1:
            manager = CheckpointManager(ckpt_dir)
            manager.save(1, task.model, optimizer)
            full = optimizer.state_dict()
            torch.distributed.barrier()
            fresh = zero.shard_opt_state(mesh, create_optimizer(
                tcfg.optimizer_config, tcfg.train_steps, task.model))
            manager.restore_train_state(TrainState.create(task.model, fresh), 1)
            out["restored_slices_equal"] = all(
                torch.equal(fresh.mu[n], full["mu"][n][fresh.slices[n]]
                            if n in fresh.slices else full["mu"][n]) for n in fresh.mu)
            out["restored_count"] = fresh.count
    return out


def _dropout_task(kind: str, task_cfg: dict, trainer: dict):
    from mmt_tpu_torch.configs import (ClassificationTaskConfig, PretrainingTaskConfig,
                                       TrainerConfig, override)
    from mmt_tpu_torch.train.tasks import ClassificationTask, PretrainingTask

    tcfg = override(TrainerConfig(), trainer)
    if kind == "pretraining":
        return PretrainingTask(override(PretrainingTaskConfig(), task_cfg), tcfg, device="cpu")
    return ClassificationTask(override(ClassificationTaskConfig(), task_cfg), tcfg,
                              device="cpu")


def dropout_train_steps(cases: list, mesh_shape=None) -> list:
    """One train step with dropout on for each case ``(kind, task_cfg,
    trainer, params_path, batch, seed)``: the ``kind`` task ("pretraining"
    or "classification") from the parameters at ``params_path``, with the
    streams ``DropoutRngs.for_step(seed, 0)``; on this rank's slice of
    ``batch`` under a (num_data, num_model) mesh when ``mesh_shape`` is
    given, else on the whole batch in this process.  Returns each case's
    metric pairs and the gradients its optimizer received."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.train.optimizer import create_optimizer
    from mmt_tpu_torch.train.train_state import TrainState

    mesh = None
    if mesh_shape is not None:
        pm.init_distributed("cpu")
        mesh = pm.create_mesh(*mesh_shape)
    torch.use_deterministic_algorithms(True)
    out = []
    for kind, task_cfg, trainer, params_path, batch, seed in cases:
        task = _dropout_task(kind, task_cfg, trainer)
        task.model.load_state_dict(torch.load(params_path, weights_only=True))
        optimizer = create_optimizer(task.trainer.optimizer_config, task.trainer.train_steps,
                                     task.model)
        grads = {}
        real_step = optimizer.step

        def recording_step():
            grads.update({n: p.grad.numpy().copy() for n, p in task.model.named_parameters()})
            real_step()

        optimizer.step = recording_step
        if kind == "pretraining":
            step = task.make_train_step(task.trainer.micro_batch_size, mesh=mesh)
        else:
            step = task.make_train_step(mesh=mesh)
        local = (pm.shard_batch(mesh, batch, "cpu") if mesh is not None
                 else {k: torch.as_tensor(v) for k, v in batch.items()})
        _, metrics = step(TrainState.create(task.model, optimizer), local,
                          DropoutRngs.for_step(seed, 0, "cpu"))
        out.append({"metrics": {n: (float(t), float(c)) for n, (t, c) in metrics.items()},
                    "grads": grads})
    return out


def run_cli(module: str, argv: list, scripted_preemption_rank=None) -> str:
    """``python -m <module>`` on this rank, in process; with
    ``scripted_preemption_rank`` that rank alone flags a preemption before
    its second boundary check (``tests/test_multihost.py``'s script)."""
    import importlib
    import io
    import logging

    sys.path.insert(0, ROOT)
    if scripted_preemption_rank is not None:
        import mmt_tpu_torch.train.loop as loop

        real = loop.PreemptionWatcher
        rank = int(os.environ["RANK"])

        class ScriptedWatcher(real):
            calls = 0

            def should_save(self, at_boundary):
                ScriptedWatcher.calls += 1
                if rank == scripted_preemption_rank and ScriptedWatcher.calls == 2:
                    self.trigger()
                return super().should_save(at_boundary)

        loop.PreemptionWatcher = ScriptedWatcher
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    try:
        result = importlib.import_module(module).main(argv)
    finally:
        logging.getLogger().removeHandler(handler)
    return {"log": log.getvalue(), "result": None if result is None else repr(type(result))}


def run_continuous_cli(argv: list, stop_after: int = 0, timeout_s: float = 1e-3) -> str:
    """``cli.train`` (``--mode=continuous_train_and_eval``) on this rank
    with two compute threads, its watch polling every 0.05 s and ending
    after ``stop_after`` rounds (0: no limit) or ``timeout_s`` after its
    start (the test's shortening of the CLI's 3600 s)."""
    from mmt_tpu_torch.train import continuous

    torch.set_num_threads(2)
    orig = continuous.run_continuous_finetune
    continuous.run_continuous_finetune = lambda **kw: orig(**{
        **kw, "poll_interval_s": 0.05, "timeout_s": timeout_s, "stop_after": stop_after})
    return run_cli("mmt_tpu_torch.cli.train", argv)


def _task(kind: str, task_cfg: dict, trainer: dict, state: dict):
    task = _dropout_task(kind, task_cfg, trainer)
    task.model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return task


def _recorded_optimizer(task):
    """The task's AdamW, recording the gradients it steps on."""
    from mmt_tpu_torch.train.optimizer import create_optimizer

    optimizer = create_optimizer(task.trainer.optimizer_config, task.trainer.train_steps,
                                 task.model)
    grads, real_step = {}, optimizer.step

    def recording_step():
        grads.update({n: p.grad.numpy().copy() for n, p in task.model.named_parameters()})
        real_step()

    optimizer.step = recording_step
    return optimizer, grads


def _encoder(cfg: dict, state: dict):
    from mmt_tpu_torch.configs.encoder import MmtEncoderConfig
    from mmt_tpu_torch.models import MmtEncoder

    encoder = MmtEncoder(MmtEncoderConfig(**cfg), num_patch_per_row=2,
                         patch_dim=state["patch_embedding_projection.weight"].shape[1],
                         device="cpu")
    encoder.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return encoder


def _encoder_case(case: dict, mesh, transport) -> dict:
    """One encoder case through ``transport``: the pipelined sequence output
    on this rank's rows and, with a target, the gradients of the global MSE
    summed over the pipe and data groups."""
    from mmt_tpu_torch.parallel import pipeline as pp
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.train.tasks import DataParallel, _pipe_gradients

    transport = transport if transport is not None else pp.P2PTransport(mesh)
    encoder = _encoder(case["config"], case["state"])
    local = pm.shard_batch(mesh, case["batch"], "cpu")
    out = {"out": _np(pp.pipelined_encoder_sequence_output(
        encoder, local, mesh=mesh, num_micro=case["num_micro"], transport=transport))}
    target = case.get("target")
    if target is not None:
        rows, seq_len = local["word_ids"].shape
        tgt = torch.as_tensor(target[mesh.data_rank * rows:(mesh.data_rank + 1) * rows])
        pipe = pp.EncoderPipeline(encoder, transport, case["num_micro"], case.get("remat", False))
        pipe.run(lambda: encoder.transformer_inputs(
                     local["word_ids"], local["segment_ids"], local["patch_embeddings"],
                     local["lengths"])[0],
                 lambda seq: ((seq - tgt) ** 2).sum() / target.size,
                 local["lengths"], seq_len, None, mesh.data_rank, mesh.num_data)
        params = list(encoder.parameters())
        _pipe_gradients(transport, params)
        DataParallel(mesh).gradients(params)
        out["grads"] = {n: _np(p.grad) for n, p in encoder.named_parameters()}
    return out


def _step_case(case: dict, mesh, transport) -> dict:
    """One pipelined train step of ``case``'s task through ``transport``:
    its metric pairs, the gradients its optimizer got and the updated
    parameters."""
    from mmt_tpu_torch.models import DropoutRngs
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.train.train_state import TrainState

    task = _task(case["kind"], case["task_cfg"], case["trainer"], case["state"])
    optimizer, grads = _recorded_optimizer(task)
    step = task.make_pipelined_train_step(mesh, case["num_micro"], remat=case.get("remat", True),
                                          zero1=case.get("zero1", False), transport=transport)
    seed = case.get("seed")
    rngs = DropoutRngs.for_step(seed, 0, "cpu") if seed is not None else None
    _, metrics = step(TrainState.create(task.model, optimizer),
                      pm.shard_batch(mesh, case["batch"], "cpu"), rngs)
    return {"metrics": {n: (float(t), float(c)) for n, (t, c) in metrics.items()},
            "grads": grads, "sharded_moments": len(optimizer.slices),
            "params": {n: p.detach().numpy().copy() for n, p in task.model.named_parameters()}}


def pipeline_cases(path: str) -> dict:
    """Every case of ``path`` (a ``torch.save``d dict, see
    ``test_torch_pipeline``) on its (num_data, num_pipe) pipe mesh, once
    with one stage per rank (gloo point-to-point) and once with every stage
    in this process (``InProcessTransport``): encoder cases give the
    pipelined sequence output (and gradients), step cases a pipelined train
    step."""
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.parallel.pipeline import InProcessTransport

    pm.init_distributed("cpu")
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)
    cases = torch.load(path, weights_only=False)
    meshes = {shape: pm.create_pipe_mesh(*shape)  # every rank, in one order
              for shape in sorted({tuple(c["mesh"]) for c in cases.values()})}
    out = {}
    for name, case in cases.items():
        mesh = meshes[tuple(case["mesh"])]
        run = _encoder_case if case["type"] == "encoder" else _step_case
        out[name] = {"p2p": run(case, mesh, None),
                     "in_process": run(case, mesh, InProcessTransport(mesh.num_pipe))}
    return out


def tensor_parallel_cases(path: str) -> dict:
    """Every case of ``path`` (a ``torch.save``d dict, see
    ``test_torch_param_sharding``) on its (num_data, num_model) mesh with
    the parameters sharded by ``shard_params``: the specs, this rank's
    eval-mode logits and, after one train step on its rows, its metric
    pairs and parameter slices."""
    from mmt_tpu_torch.parallel import mesh as pm
    from mmt_tpu_torch.parallel.param_sharding import shard_params
    from mmt_tpu_torch.train.tasks import MODEL_INPUT_KEYS
    from mmt_tpu_torch.train.train_state import TrainState

    pm.init_distributed("cpu")
    torch.use_deterministic_algorithms(True)
    out = {}
    for name, case in torch.load(path, weights_only=False).items():
        mesh = pm.create_mesh(*case["mesh"])
        task = _task(case["kind"], case["task_cfg"], case["trainer"], case["state"])
        specs = shard_params(mesh, task.model)
        local = pm.shard_batch(mesh, case["batch"], "cpu")
        with torch.no_grad():
            logits = task.model(**{k: local[k] for k in MODEL_INPUT_KEYS if k in local})
        optimizer, _ = _recorded_optimizer(task)
        step = task.make_train_step(mesh=mesh)
        _, metrics = step(TrainState.create(task.model, optimizer), local)
        out[name] = {"specs": specs, "logits": _np(logits["itm_logits"]),
                     "metrics": {n: (float(t), float(c)) for n, (t, c) in metrics.items()},
                     "params": {n: p.detach().numpy().copy()
                                for n, p in task.model.named_parameters()}}
    return out
