"""GPipe pipelining of the layer stack (``parallel/pipeline.py``) and the
pipelined train steps against the JAX package, on the CPU.

The JAX references are ``tests/test_pipeline.py``'s: JAX's
``pipelined_encoder_sequence_output`` on (data, pipe) meshes and the
unrolled stack (forward 1e-5, bf16 2e-2; gradients of an MSE atol 2e-5,
rtol 2e-4), and JAX's ``make_pipelined_train_step`` at dropout 0 (loss
rtol 1e-5; parameters atol 1e-5, rtol 1e-4).  The port runs on four
``gloo`` ranks (``parallel.launch.run_local``; the ranks' code is
``tests/torch_gloo_workers.py``) on (1, 4) and (2, 2) meshes, one stage per
rank, and each rank runs the same case again with every stage in its
process (``InProcessTransport``): the two transports must agree bit for
bit.  The pretraining step runs with ``zero1`` (AdamW's moments sharded
over the data group by the step), and runs again with dropout 0.1 in
the embeddings, the layers and the ITM head, where the transports are held
to each other alone.  The (2, 4) mesh on eight ranks is ``slow``.  In one process: 8
stages x 1 layer, the dropout derivation (the pipelined stack equals the
unpipelined stack run micro-batch by micro-batch on the same streams; the
same rngs give the same loss, others another), and JAX's errors.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mmt_tpu.configs import ClassificationTaskConfig as JaxClsConfig
from mmt_tpu.configs import PretrainingTaskConfig as JaxTaskConfig
from mmt_tpu.configs import TrainerConfig as JaxTrainerConfig
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.models import MmtEncoder as JaxEncoder
from mmt_tpu.parallel.mesh import shard_batch as jax_shard_batch
from mmt_tpu.parallel.pipeline import pipelined_encoder_sequence_output as jax_pipelined
from mmt_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from mmt_tpu.train.tasks import ClassificationTask as JaxClsTask
from mmt_tpu.train.tasks import PretrainingTask as JaxTask
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.configs.encoder import MmtEncoderConfig
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.models import DropoutRngs, MmtEncoder
from mmt_tpu_torch.models.common import init_params
from mmt_tpu_torch.parallel import mesh as pm
from mmt_tpu_torch.parallel import pipeline as pp
from mmt_tpu_torch.parallel.launch import run_local
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.train_state import TrainState
from tests import torch_gloo_workers
from tests.test_models import tiny_encoder_config

B, S = 8, 16
TRAINER = {"train_steps": 100}
# The steps' tiny model: 4 layers, S = 24 with a 2 x 2 image of 48-wide patches.
TASK_S, TASK_PATCH = 24, 48
_TASK_CFG = {
    "model": {"encoder": {"mmt": {
        "vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 4, "num_attention_heads": 2,
        "intermediate_size": 64, "relative_pos_max_distance": 3, "relative_vocab_size": 12,
        "relative_att_num_core_layers": 1, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0, "compute_dtype": "float32",
        "attention_impl": "pallas"}},
        "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]},
    "train_data": {"input_path": "dummy", "max_seq_len": TASK_S, "image_size": 8,
                   "patch_size": 4, "input_channels": 3, "global_batch_size": B,
                   "mlm_max_selections_per_seq": 4, "mpp_max_selections_per_seq": 2,
                   "output_channel_bits": 2},
}


def _encoder_kw(num_layers=4, **kw):
    cfg = dict(vocab_size=64, segment_vocab_size=4, hidden_size=32, num_hidden_layers=num_layers,
               num_attention_heads=2, intermediate_size=64, relative_pos_max_distance=3,
               relative_vocab_size=12, relative_att_num_core_layers=1, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, compute_dtype="float32")
    cfg.update(kw)
    return cfg


def _encoder_inputs(batch=B):
    rng = np.random.default_rng(0)
    return {"word_ids": rng.integers(0, 60, (batch, S)).astype(np.int32),
            "segment_ids": rng.integers(1, 3, (batch, S)).astype(np.int32),
            "patch_embeddings": rng.normal(size=(batch, 4, 12)).astype(np.float32),
            "lengths": np.asarray([S, S - 3, S - 1, S, S - 5, S, S - 2, S][:batch], np.int32)}


def _jax_encoder(**kw):
    """JAX's encoder (attention ``xla``), its parameters and the port's
    encoder config of the same model (``attention_impl`` from ``kw``)."""
    cfg = _encoder_kw(**kw)
    jax_cfg = {k: v for k, v in cfg.items() if k != "attention_impl"}
    enc = JaxEncoder(config=tiny_encoder_config(**jax_cfg), num_patch_per_row=2)
    inputs = {k: jnp.asarray(v) for k, v in _encoder_inputs().items()}
    layers = cfg["num_hidden_layers"]
    if layers not in _PARAMS:  # float32 parameters whatever the compute dtype
        init = JaxEncoder(config=tiny_encoder_config(num_hidden_layers=layers),
                          num_patch_per_row=2)
        _PARAMS[layers] = init.init(jax.random.PRNGKey(0), **inputs)
    return enc, _PARAMS[layers], inputs, cfg


_PARAMS = {}


def _port_state(cfg, params):
    encoder = MmtEncoder(MmtEncoderConfig(**cfg), num_patch_per_row=2, patch_dim=12,
                         device="cpu")
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params), encoder)
    return encoder, {k: v.numpy() for k, v in state.items()}


def _jax_mesh(data, pipe):
    return Mesh(np.asarray(jax.devices()[:data * pipe]).reshape(data, pipe), ("data", "pipe"))


def _rows(mesh_shape, rank):
    data, pipe = mesh_shape
    b = B // data
    return slice((rank // pipe) * b, (rank // pipe + 1) * b)


# ------------------------------------------------------------- task steps

def _task_cfg(kind):
    cfg = copy.deepcopy(_TASK_CFG)
    if kind == "classification":
        cfg["model"]["num_classes"] = 2
        cfg["train_data"] = {k: v for k, v in cfg["train_data"].items()
                             if k in ("max_seq_len", "image_size", "patch_size",
                                      "input_channels", "global_batch_size")}
        cfg["train_data"]["input_path"] = "unused"
    return cfg


def _task_batch(kind):
    rng = np.random.default_rng(3)
    batch = {
        "word_ids": rng.integers(0, 100, (B, TASK_S)).astype(np.int32),
        "segment_ids": np.where(np.arange(TASK_S)[None] < 6, 1, 2).repeat(B, 0).astype(np.int32),
        "patch_embeddings": rng.normal(size=(B, 4, TASK_PATCH)).astype(np.float32),
        "lengths": rng.integers(12, TASK_S + 1, (B,)).astype(np.int32),
        "mlm_positions": rng.integers(6, 12, (B, 4)).astype(np.int32),
        "mlm_label_ids": rng.integers(0, 100, (B, 4)).astype(np.int32),
        "mlm_label_weights": (rng.random((B, 4)) < 0.7).astype(np.float32),
        "mpp_positions": rng.integers(2, 6, (B, 2)).astype(np.int32),
        "mpp_label_ids": rng.integers(0, 64, (B, 2)).astype(np.int32),
        "mpp_label_weights": np.ones((B, 2), np.float32),
        "itm_label_ids": np.tile(np.asarray([1, 0, 1, 1], np.int32), B // 4),
        "itm_label_weights": np.ones(B, np.float32),
    }
    if kind == "pretraining":
        return batch
    out = {k: batch[k] for k in ("word_ids", "segment_ids", "patch_embeddings", "lengths")}
    out.update(label_ids=rng.integers(0, 2, (B,)).astype(np.int32),
               label_weights=np.ones(B, np.float32),
               pos_weights=rng.uniform(0.5, 2.0, (B,)).astype(np.float32))
    return out


def _jax_task(kind, **enc):
    cfg = _task_cfg(kind)
    cfg["model"]["encoder"]["mmt"] = {**cfg["model"]["encoder"]["mmt"], "attention_impl": "xla",
                                      **enc}
    trainer = jax_override(JaxTrainerConfig(), TRAINER)
    if kind == "pretraining":
        return JaxTask(jax_override(JaxTaskConfig(), cfg), trainer)
    return JaxClsTask(jax_override(JaxClsConfig(), cfg), trainer)


def _port_task(kind, params, **enc):
    cfg = _task_cfg(kind)
    cfg["model"]["encoder"]["mmt"].update(enc)
    task = torch_gloo_workers._dropout_task(kind, cfg, TRAINER)
    task.model.load_state_dict(params_from_flax(params, task.model))
    return task, cfg


def _jax_pipelined_step(kind, mesh_shape):
    """JAX's pipelined step from its initial parameters: (initial numpy
    parameter tree, loss, updated parameters)."""
    jtask = _jax_task(kind)
    batch = {k: jnp.asarray(v) for k, v in _task_batch(kind).items()}
    params = jax.tree_util.tree_map(np.asarray, jtask.init(jax.random.PRNGKey(0), batch))
    tx = jax_create_optimizer(jtask.trainer.optimizer_config, 100)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    mesh = _jax_mesh(*mesh_shape)
    with mesh:
        step = jtask.make_pipelined_train_step(mesh, num_micro=2)
        new, metrics = step(state, jax_shard_batch(mesh, batch), jax.random.PRNGKey(1))
    return params, float(metrics["total_loss"][0]), jax.tree_util.tree_map(np.asarray, new.params)


# ------------------------------------------------------------ gloo cases

ENCODER_CASES = {  # name: (mesh, num_micro, encoder kw, forward tolerance, JAX pipelined)
    "fwd_1x4": ((1, 4), 4, {}, 1e-5, True),
    "fwd_2x2": ((2, 2), 2, {}, 1e-5, True),
    # against the unrolled stack (JAX's pipeline equals it: tests/test_pipeline.py)
    "post_activation": ((2, 2), 2, {"use_pre_activation_order": False}, 1e-5, False),
    "bf16": ((2, 2), 2, {"compute_dtype": "bfloat16"}, 2e-2, False),
    # the port's fused op (its plain version here) against JAX's dense path
    "fused_attention": ((2, 2), 2, {"attention_impl": "pallas"}, 1e-5, True),
}
GRAD_CASES = {"grads": False, "grads_remat": True}


def _gloo_cases(tmp, mesh_shapes, steps):
    cases, want, jax_outputs = {}, {}, {}
    for name, (mesh, micro, kw, tol, pipelined) in ENCODER_CASES.items():
        if mesh not in mesh_shapes:
            continue
        enc, params, inputs, cfg = _jax_encoder(**kw)
        _, state = _port_state(cfg, params)
        key = (mesh, micro, tuple(sorted((k, v) for k, v in kw.items()
                                         if k != "attention_impl")))
        if key not in jax_outputs:
            jax_outputs[key] = {"unrolled": np.asarray(enc.apply(params, **inputs)
                                                       ["sequence_output"])}
            if pipelined:
                jax_outputs[key]["pipelined"] = np.asarray(jax_pipelined(
                    enc, params, inputs, mesh=_jax_mesh(*mesh), num_micro=micro))
        cases[name] = {"type": "encoder", "mesh": mesh, "config": cfg, "state": state,
                       "batch": _encoder_inputs(), "num_micro": micro}
        want[name] = {**jax_outputs[key], "tol": tol}
    for mesh in mesh_shapes[-1:]:  # gradients of an MSE: JAX's unrolled stack's
        enc, params, inputs, cfg = _jax_encoder()
        _, state = _port_state(cfg, params)
        target = np.random.default_rng(1).normal(size=(B, S, 32)).astype(np.float32)

        def loss(p):
            out = enc.apply(p, **inputs)["sequence_output"]
            return jnp.mean((out - jnp.asarray(target)) ** 2)

        grads = params_from_flax(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(params)), _port_state(cfg, params)[0])
        for name, remat in GRAD_CASES.items():
            key = f"{name}_{mesh[0]}x{mesh[1]}"
            cases[key] = {"type": "encoder", "mesh": mesh, "config": cfg, "state": state,
                          "batch": _encoder_inputs(), "num_micro": 2, "target": target,
                          "remat": remat}
            want[key] = {"grads": {k: v.numpy() for k, v in grads.items()}}
    for kind, mesh in steps:
        params, loss, new = _jax_pipelined_step(kind, mesh)
        task, cfg = _port_task(kind, params)
        key = f"{kind}_{mesh[0]}x{mesh[1]}"
        cases[key] = {"type": "step", "mesh": mesh, "kind": kind, "task_cfg": cfg,
                      "trainer": TRAINER, "batch": _task_batch(kind), "num_micro": 2,
                      "state": {k: v.numpy() for k, v in task.model.state_dict().items()},
                      "zero1": kind == "pretraining"}  # moments sharded by the step
        want[key] = {"loss": loss, "params": {k: v.numpy()
                                              for k, v in params_from_flax(new, task.model).items()}}
    for kind, mesh in steps[:1]:  # dropout everywhere: the transports agree bit for bit
        cfg = _task_cfg(kind)
        cfg["model"]["encoder"]["mmt"].update(hidden_dropout_prob=0.1,
                                              attention_probs_dropout_prob=0.1)
        cfg["model"]["cls_heads"][0]["dropout_rate"] = 0.1
        task = torch_gloo_workers._dropout_task(kind, cfg, TRAINER)
        key = f"{kind}_dropout_{mesh[0]}x{mesh[1]}"
        cases[key] = {"type": "step", "mesh": mesh, "kind": kind, "task_cfg": cfg,
                      "trainer": TRAINER, "batch": _task_batch(kind), "num_micro": 2, "seed": 5,
                      "state": {k: v.numpy() for k, v in task.model.state_dict().items()}}
        want[key] = {}
    torch.save(cases, tmp / "cases.pt")
    return want


def _check_gloo(ranks, want, mesh_shapes):
    for name, expect in want.items():
        for rank, result in enumerate(ranks):
            got = result[name]
            # the two transports: bit for bit
            for a, b in zip(jax.tree_util.tree_leaves(got["p2p"]),
                            jax.tree_util.tree_leaves(got["in_process"])):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} transports, rank {rank}")
            got = got["p2p"]
            if "unrolled" in expect:
                rows = _rows(ENCODER_CASES[name][0], rank)
                for ref in ("pipelined", "unrolled"):
                    if ref in expect:
                        np.testing.assert_allclose(got["out"], expect[ref][rows],
                                                   atol=expect["tol"], rtol=expect["tol"],
                                                   err_msg=f"{name} {ref}")
            if "grads" in expect:
                for n, g in expect["grads"].items():
                    np.testing.assert_allclose(got["grads"][n], g, atol=2e-5, rtol=2e-4,
                                               err_msg=f"{name} {n}")
            if "loss" in expect:
                assert (got["sharded_moments"] > 0) == name.startswith("pretraining")
                total, count = got["metrics"]["total_loss"]
                np.testing.assert_allclose(total / count, expect["loss"], rtol=1e-5, atol=0,
                                           err_msg=name)
                for n, p in expect["params"].items():
                    np.testing.assert_allclose(got["params"][n], p, atol=1e-5, rtol=1e-4,
                                               err_msg=f"{name} {n}")
    # remat gives the gradients of the plain schedule
    for rank in ranks:
        for key in [k for k in want if k.startswith("grads_remat")]:
            plain = rank[key.replace("grads_remat", "grads")]["p2p"]["grads"]
            for n, g in rank[key]["p2p"]["grads"].items():
                np.testing.assert_allclose(g, plain[n], atol=1e-5, rtol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    meshes = [(1, 4), (2, 2)]
    want = _gloo_cases(tmp, meshes, [("pretraining", (2, 2)), ("classification", (2, 2))])
    ranks = run_local(torch_gloo_workers.pipeline_cases, 4, str(tmp / "cases.pt"))
    return ranks, want, meshes


@pytest.mark.parametrize("group", ["forward", "gradients", "steps"])
def test_four_ranks_match_jax_and_transports_agree(four_ranks, group):
    ranks, want, meshes = four_ranks
    select = {"forward": lambda k: k in ENCODER_CASES,
              "gradients": lambda k: k.startswith("grads"),
              "steps": lambda k: k.startswith(("pretraining", "classification"))}[group]
    _check_gloo(ranks, {k: v for k, v in want.items() if select(k)}, meshes)


@pytest.mark.slow
def test_eight_ranks_2x4_mesh(tmp_path):
    want = _gloo_cases(tmp_path, [(2, 4)], [("pretraining", (2, 4))])
    ranks = run_local(torch_gloo_workers.pipeline_cases, 8, str(tmp_path / "cases.pt"))
    _check_gloo(ranks, want, [(2, 4)])


# -------------------------------------------------------------- in process

def test_eight_stages_one_layer_each():
    enc, params, inputs, cfg = _jax_encoder(num_layers=8)
    want = np.asarray(jax_pipelined(enc, params, inputs, mesh=_jax_mesh(1, 8), num_micro=4))
    encoder, state = _port_state(cfg, params)
    encoder.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    batch = {k: torch.as_tensor(v) for k, v in _encoder_inputs().items()}
    got = pp.pipelined_encoder_sequence_output(encoder, batch, mesh=pm.create_pipe_mesh(),
                                               num_micro=4, transport=pp.InProcessTransport(8))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(enc.apply(params, **inputs)
                                                       ["sequence_output"]), atol=1e-5, rtol=1e-5)


def test_pipelined_stack_with_dropout_is_the_stack_per_micro_batch():
    """The port's dropout derivation: micro-batch m's layers draw from
    ``rngs.split(M)[m]`` in layer order, so the pipelined stack in train
    mode equals the unpipelined stack run on each micro-batch with that
    stream (hidden and attention dropout 0.1, remat on)."""
    cfg = _encoder_kw(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                      attention_impl="pallas")
    encoder = MmtEncoder(MmtEncoderConfig(**cfg), num_patch_per_row=2, patch_dim=12,
                         device="cpu")
    init_params(encoder, 0, 0.02)
    encoder.train()
    batch = {k: torch.as_tensor(v) for k, v in _encoder_inputs().items()}
    emb, lengths = encoder.transformer_inputs(batch["word_ids"], batch["segment_ids"],
                                              batch["patch_embeddings"], batch["lengths"],
                                              DropoutRngs.for_step(4, 0, "cpu"))
    emb = emb.detach()
    pipe = pp.EncoderPipeline(encoder, pp.InProcessTransport(2), num_micro=4, remat=True)
    got = pipe.forward(emb, lengths, S, DropoutRngs.for_step(9, 0, "cpu"))
    streams = DropoutRngs.for_step(9, 0, "cpu").split(4)
    want = torch.cat([
        encoder.transformer(e, n, dataclasses.replace(r, batch_rows=2))
        for e, n, r in zip(emb.split(2), lengths.split(2), streams)]).float()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.equal(got, encoder.transformer(emb, lengths, DropoutRngs.for_step(
        9, 0, "cpu")).float())


def test_pipelined_step_with_dropout_is_deterministic_per_rng():
    cfg = _task_cfg("pretraining")
    cfg["model"]["encoder"]["mmt"].update(hidden_dropout_prob=0.1,
                                          attention_probs_dropout_prob=0.1)

    def one_step(seed):
        task = torch_gloo_workers._dropout_task("pretraining", cfg, TRAINER)
        step = task.make_pipelined_train_step(pm.create_pipe_mesh(), 2,
                                              transport=pp.InProcessTransport(4))
        state = TrainState.create(task.model, create_optimizer(
            task.trainer.optimizer_config, 100, task.model))
        batch = {k: torch.as_tensor(v) for k, v in _task_batch("pretraining").items()}
        _, metrics = step(state, batch, DropoutRngs.for_step(seed, 0, "cpu"))
        return float(metrics["total_loss"][0])

    torch.use_deterministic_algorithms(True)
    try:
        a, a2, b = one_step(1), one_step(1), one_step(2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert np.isfinite(a) and np.isfinite(b)
    assert a == a2
    assert a != b


def test_microbatch_roundtrip_and_errors():
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(pp.unmicrobatch(pp.microbatch(x, 2)), x)
    with pytest.raises(ValueError, match="does not split"):
        pp.microbatch(x, 3)
    encoder = MmtEncoder(MmtEncoderConfig(**_encoder_kw(num_layers=3)), num_patch_per_row=2,
                         patch_dim=12, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pp.EncoderPipeline(encoder, pp.InProcessTransport(4), 2)
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        pp.P2PTransport(pm.create_mesh())
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        torch_gloo_workers._dropout_task("pretraining", _task_cfg("pretraining"), TRAINER) \
            .make_pipelined_train_step(pm.create_mesh(), 2)
