"""Megatron-style tensor parallelism (``parallel/param_sharding.py``) and the
kernels' head offset against the JAX package, on the CPU.

* ``param_spec`` gives JAX's specs on Flax paths, and the port's plan
  (with its per-parameter fallback) gives the specs that JAX's
  ``shard_params`` places, at tp = 2 and at tp = 4 with 2 heads (the
  attention falls back to replication, the FFN and the vocabulary shard).
* The head offset is a seed fold: the keep factors of a head shard from
  the folded seed are bit-equal to the plain version's explicit
  ``head_start``, and to the unsharded call's heads.  A head-sharded call
  with dropout (``relative_attention``: the plain versions here) against
  the same heads of JAX's Pallas kernels in interpret mode, forward and
  gradients, at ``tests/test_torch_offsets.py``'s bounds (2e-5, 3e-4).
* In one process (``shard_params_in_process``), tp = 2 and 4 with dropout:
  the loss and every gradient equal the unsharded model's (1e-5 of each
  tensor's norm).
* On four ``gloo`` ranks (``tests/torch_gloo_workers.py``): the TP forward's
  ``itm_logits`` against JAX's ``shard_params`` forward (1e-5), and one TP
  training step (AdamW) against JAX's replicated step (loss rtol 1e-5;
  parameters, reassembled from the ranks' slices, atol 1e-5 rtol 1e-4), on
  a (2, 2) mesh and, falling back, a (1, 4) mesh; the replicated
  parameters bit-equal across each model group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu.parallel import create_mesh as jax_create_mesh
from mmt_tpu.parallel import shard_batch as jax_shard_batch
from mmt_tpu.parallel.param_sharding import param_spec as jax_param_spec
from mmt_tpu.parallel.param_sharding import shard_params as jax_shard_params
from mmt_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.convert import flax_paths, params_from_flax
from mmt_tpu_torch.models import DropoutRngs
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.parallel import param_sharding as ps
from mmt_tpu_torch.parallel.launch import run_local
from tests import torch_gloo_workers
from tests.test_torch_pipeline import TRAINER, _jax_task, _port_task, _task_batch, _task_cfg

FWD_TOL, GRAD_TOL = 2e-5, 3e-4


def _jax_params(kind="pretraining"):
    jtask = _jax_task(kind)
    batch = {k: jnp.asarray(v) for k, v in _task_batch(kind).items()}
    return jtask, batch, jax.tree_util.tree_map(np.asarray,
                                                jtask.init(jax.random.PRNGKey(0), batch))


def _flat_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(k.key for k in path): tuple(leaf.sharding.spec) for path, leaf in flat}


# ------------------------------------------------------------------- rules

def test_param_spec_rules_are_jax_rules():
    for path in ("encoder/transformer/layer_0/attention/query/kernel",
                 "encoder/transformer/layer_3/attention/value/bias",
                 "encoder/transformer/layer_0/attention/output/kernel",
                 "encoder/transformer/layer_0/intermediate/kernel",
                 "encoder/transformer/layer_0/intermediate/bias",
                 "encoder/transformer/layer_0/ffn_output/kernel",
                 "encoder/transformer/layer_0/ffn_output/bias",
                 "encoder/word_embeddings/embedding_table",
                 "encoder/embeddings_layer_norm/scale",
                 "encoder/transformer/layer_0/attention/relative_emb_table"):
        assert ps.param_spec(path) == tuple(jax_param_spec(path)), path


@pytest.mark.parametrize("num_model", [2, 4])
def test_plan_is_what_jax_shard_params_places(num_model):
    """tp = 2 shards everything the rules name; tp = 4 with the model's 2
    heads leaves the attention replicated (JAX's fallback) and shards the
    FFN and the 100-row vocabulary."""
    jtask, _, params = _jax_params()
    mesh = jax_create_mesh(num_data=8 // num_model, num_model=num_model)
    want = _flat_specs(jax_shard_params(mesh, params))
    task, _ = _port_task("pretraining", params)
    plan = ps.sharding_plan(task.model, num_model)
    paths = flax_paths(task.model)
    assert {paths[n]: spec for n, spec in plan.items()} == {
        p.removeprefix("params/"): tuple(s for s in spec) for p, spec in want.items()}
    attention = {n for n in plan if n.endswith((".attention.query.weight", ".attention.output.weight"))}
    assert all(bool(plan[n]) == (num_model == 2) for n in attention)
    assert plan["encoder.word_embeddings.embedding_table"] == ("model", None)
    assert plan["encoder.transformer.layers.0.intermediate.weight"] == (None, "model")
    assert not any(ps.sharding_plan(task.model, 1).values())


# ------------------------------------------------------------- head offset

B, S, H, D, V = 2, 128, 4, 16, 24
SEED, BATCH_START, HEAD_START, HEADS = 4242, 5, 2, 2
GEO = jax_pa.RelGeometry(5, 4, 1)


def test_head_start_fold_is_the_explicit_offset():
    rows = torch.arange(BATCH_START, BATCH_START + B)
    pos = torch.arange(64)
    full = fa._dropout_block(SEED, rows, H, pos, pos, 0.1)
    for start in range(H - HEADS + 1):
        explicit = fa._dropout_block(SEED, rows, HEADS, pos, pos, 0.1, head_start=start)
        folded = fa._dropout_block(fa.head_seed(SEED, start), rows, HEADS, pos, pos, 0.1)
        assert torch.equal(explicit, folded)
        assert torch.equal(explicit, full[:, start:start + HEADS])
    assert fa.head_seed(-5, 3) == np.int32(np.int64(-5) + 3 * 0x27D4EB2D & 0xFFFFFFFF)


def test_head_shard_counter_counts_kernel_launches_only():
    """``.launches_head_shard`` counts where a kernel launches (the forward
    in the registered op's CUDA version): a call on the CPU counts nothing,
    and the mark the forward launcher sets for the op is cleared after
    every call, a failed one too."""
    q = torch.zeros(1, 64, 2, 16)
    lengths = torch.tensor([64], dtype=torch.int32)
    counters = (fa.relative_attention_forward, fa.relative_attention_backward)
    before = [c.launches_head_shard for c in counters]
    o, lse = fa.relative_attention_forward(q, q, q, None, None, lengths, "cpu", head_start=2)
    fa.relative_attention_backward(q, q, q, o, lse, torch.zeros_like(lse), None, None, lengths,
                                   "cpu", head_start=2)
    assert not fa._head_shard_call.active
    with pytest.raises(RuntimeError):
        fa.relative_attention_forward(q, torch.zeros(1, 64, 3, 16), q, None, None, lengths,
                                      "cpu", head_start=2)
    assert not fa._head_shard_call.active
    assert [c.launches_head_shard for c in counters] == before


def test_head_shard_matches_jax_interpret_kernels():
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    table = rng.normal(size=(V, H, D)).astype(np.float32)
    lengths = np.asarray([128, 77], np.int32)
    do = do * (np.arange(S)[None, :] < lengths[:, None])[:, :, None, None]
    out, lse = jax_pa._attention_forward(
        *(jnp.asarray(x) for x in (q, k, v, table)), GEO, jnp.asarray(lengths), 64, 64, True,
        dropout_rate=0.1, dropout_seed=jnp.int32(SEED), batch_start=jnp.int32(BATCH_START))
    offs = jnp.stack([jnp.int32(0), jnp.int32(0), jnp.int32(SEED), jnp.int32(BATCH_START)])
    residuals = (*(jnp.asarray(x) for x in (q, k, v, table, lengths)), offs, out, lse)
    want = jax_pa._attention_backward(residuals, jnp.asarray(do), GEO, 64, 64, True,
                                      dropout_rate=0.1)[:4]
    heads = slice(HEAD_START, HEAD_START + HEADS)
    tq, tk, tv = (torch.tensor(x[:, :, heads], requires_grad=True) for x in (q, k, v))
    ttable = torch.tensor(table[:, heads], requires_grad=True)
    o = fa.relative_attention(tq, tk, tv, ttable, fa.RelGeometry(**vars(GEO)),
                              torch.from_numpy(lengths), 0.1, SEED, device="cpu",
                              batch_start=BATCH_START, head_start=HEAD_START)
    (o * torch.from_numpy(do[:, :, heads])).sum().backward()
    real = np.arange(S)[None, :] < lengths[:, None]
    for b in range(B):
        np.testing.assert_allclose(o.detach().numpy()[b, real[b]],
                                   np.asarray(out)[b, real[b]][:, heads], atol=FWD_TOL,
                                   rtol=FWD_TOL, err_msg=f"o, example {b}")
        for name, g, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(g.numpy()[b, real[b]], np.asarray(ref)[b, real[b]][:, heads],
                                       atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"{name} {b}")
    np.testing.assert_allclose(ttable.grad.numpy(), np.asarray(want[3])[:, heads], atol=GRAD_TOL,
                               rtol=GRAD_TOL, err_msg="drel")


# -------------------------------------------------------------- in process

def _loss_and_grads(task, batch):
    loss, _ = task.compute_loss(batch, DropoutRngs.for_step(1, 0, "cpu"))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in task.model.named_parameters()}


@pytest.mark.parametrize("size", [2, 4])
def test_in_process_shards_give_the_unsharded_model(size):
    cfg = _task_cfg("pretraining")
    cfg["model"]["encoder"]["mmt"].update(hidden_dropout_prob=0.1,
                                          attention_probs_dropout_prob=0.1)
    batch = {k: torch.as_tensor(v) for k, v in _task_batch("pretraining").items()}
    torch.use_deterministic_algorithms(True)
    try:
        task = torch_gloo_workers._dropout_task("pretraining", cfg, TRAINER)
        want_loss, want = _loss_and_grads(task, batch)
        task = torch_gloo_workers._dropout_task("pretraining", cfg, TRAINER)
        plan = ps.shard_params_in_process(task.model, size)
        got_loss, got = _loss_and_grads(task, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert task.model.encoder.word_embeddings.tp is not None
    assert (task.model.encoder.transformer.layers[0].attention.tp is not None) == (size == 2)
    assert any(plan.values())
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for name, g in want.items():
        if name.endswith("attention.key.bias"):  # its exact gradient is 0
            continue
        err = float((got[name] - g).norm())
        assert err <= 1e-5 * float(g.norm()) + 1e-7, (name, err, float(g.norm()))


# -------------------------------------------------------------- gloo ranks

MESHES = {"tp_2x2": (2, 2), "tp_1x4_fallback": (1, 4)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    jtask, batch, params = _jax_params()
    task, cfg = _port_task("pretraining", params)
    state = {k: v.numpy() for k, v in task.model.state_dict().items()}
    tx = jax_create_optimizer(jtask.trainer.optimizer_config, 100)
    new, metrics = jtask.make_train_step()(
        JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx), batch,
        jax.random.PRNGKey(1))
    want = {"loss": float(metrics["total_loss"][0]),
            "params": {k: v.numpy() for k, v in params_from_flax(
                jax.tree_util.tree_map(np.asarray, new.params), task.model).items()}}
    inputs = {k: batch[k] for k in ("word_ids", "segment_ids", "patch_embeddings", "lengths")}
    cases = {}
    for name, (num_data, num_model) in MESHES.items():
        mesh = jax_create_mesh(num_data=num_data, num_model=num_model)
        with mesh:
            sharded = jax_shard_params(mesh, jax.tree_util.tree_map(jnp.asarray, params))
            logits = jax.jit(lambda p, x: jtask.model.apply(p, **x, deterministic=True)
                             ["itm_logits"])(sharded, jax_shard_batch(mesh, inputs))
        want[name] = np.asarray(logits)
        cases[name] = {"mesh": (num_data, num_model), "kind": "pretraining", "task_cfg": cfg,
                       "trainer": TRAINER, "state": state, "batch": _task_batch("pretraining")}
    torch.save(cases, tmp / "cases.pt")
    ranks = run_local(torch_gloo_workers.tensor_parallel_cases, 4, str(tmp / "cases.pt"))
    return ranks, want, flax_paths(task.model)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_tp_forward_and_step_match_jax(four_ranks, name):
    ranks, want, paths = four_ranks
    num_data, num_model = MESHES[name]
    rows = 8 // num_data
    for rank, result in enumerate(ranks):
        got = result[name]
        d = rank // num_model
        np.testing.assert_allclose(got["logits"], want[name][d * rows:(d + 1) * rows],
                                   atol=1e-5, rtol=1e-5, err_msg=f"logits, rank {rank}")
        total, count = got["metrics"]["total_loss"]
        np.testing.assert_allclose(total / count, want["loss"], rtol=1e-5, atol=0)
    for d in range(num_data):
        group = [ranks[d * num_model + j][name] for j in range(num_model)]
        for param, ref in want["params"].items():
            spec = group[0]["specs"][param]
            if spec:
                dim = ps._torch_dim(paths[param])
                assert group[0]["params"][param].shape[dim] * num_model == ref.shape[dim]
                full = np.concatenate([g["params"][param] for g in group], axis=dim)
            else:
                full = group[0]["params"][param]
                for g in group[1:]:
                    np.testing.assert_array_equal(g["params"][param], full, err_msg=param)
            np.testing.assert_allclose(full, ref, atol=1e-5, rtol=1e-4, err_msg=param)
    if name == "tp_1x4_fallback":
        specs = ranks[0][name]["specs"]
        assert not specs["encoder.transformer.layers.0.attention.query.weight"]
        assert specs["encoder.transformer.layers.0.intermediate.weight"]
