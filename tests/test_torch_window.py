"""The port's sliding-window + prefix-global attention against the JAX package.

A pair (i, j) is allowed iff i < num_global, j < num_global or |i - j| <=
window; a disallowed pair gets -10000 after the scale and the length mask.

Tolerances (float32 on the CPU):

* plain forward against ``pallas_relative_attention(..., interpret=True)``
  (K2's windowed live-tile list) and against JAX's dense window oracle
  (``tests/test_window_attention.py:dense_window_reference``): 2e-5 (atol
  = rtol) on real rows, sums in another order;
* plain backward and ``RelativeAttentionFunction`` on the CPU against
  ``jax.grad`` of the dense window oracle and of the Pallas interpret
  kernels (K4, the fused windowed backward over the live-tile list):
  3e-4 (atol = rtol, the bound of ``tests/test_pallas_backward.py``);
* window >= S: exactly the dense plain version (the window term adds 0.0);
* a tiny windowed pretraining model (2 layers, hidden 32, S=128, P=4, auto
  num_global = 2 + P**2 = 18) against JAX's ``xla`` and
  ``pallas_interpret`` models with bridged params: 1e-4 on the logits;
* the windowed task with ``remat: true`` against JAX's with ``remat:
  true``: gradients within 1e-4 of each tensor's norm plus 1e-6 of the
  whole gradient's norm, two AdamW steps within 1e-5 (the tolerances of
  ``test_torch_train.py``);
* remat on and off give bit-identical gradients with hidden and attention
  dropout at 0.1 from the same seeds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmt_tpu.configs import PretrainingTaskConfig as JaxTaskConfig
from mmt_tpu.configs import TrainerConfig as JaxTrainerConfig
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.ops import pallas_attention as jax_pa
from mmt_tpu.train import optimizer as jax_optimizer
from mmt_tpu.train.tasks import PretrainingTask as JaxTask
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.configs import PretrainingTaskConfig, TrainerConfig, override
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.models import DropoutRngs
from mmt_tpu_torch.models.relative_attention import RelativeTransformerLayer
from mmt_tpu_torch.ops import fused_attention as fa
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_pretraining import _inputs as model_inputs
from tests.test_torch_pretraining import _jax_model, torch_pretraining_model
from tests.test_torch_train import (
    _TASK_CFG,
    _assert_trees_close,
    _batch,
    _GradRecorder,
    _to_port_names,
)
from tests.test_window_attention import dense_window_reference

FWD_TOL, BWD_TOL, MODEL_TOL = 2e-5, 3e-4, 1e-4

# The JAX window tests' three geometries (tests/test_window_attention.py):
# (geometry, B, S, H, D, V, lengths, block_q, block_k).
FORWARD_CASES = {
    "2d_multi_tile": (jax_pa.RelGeometry(text_max_distance=5, num_patch_per_row=4,
                                         num_core_layers=1, window=48, num_global=18),
                      2, 512, 2, 32, 32, [512, 300], 64, 64),
    "unaligned": (jax_pa.RelGeometry(text_max_distance=3, num_patch_per_row=4,
                                     num_core_layers=1, window=37, num_global=21),
                  2, 256, 2, 16, 40, [256, 150], 64, 64),
    "1d": (jax_pa.RelGeometry(text_max_distance=12, window=64, num_global=16),
           2, 384, 2, 32, 25, [384, 200], 64, 128),
}


def _arrays(B, S, H, D, V, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    table = rng.normal(size=(V, H, D)).astype(np.float32)
    return q, k, v, table


def _port(geo):
    return fa.RelGeometry(**vars(geo))


def _ids(geo, S):
    return jnp.asarray(fa.relative_att_ids(_port(geo), S))


def _assert_real_rows(got, want, lengths, tol, name=""):
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=tol, rtol=tol, err_msg=name)


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_plain_forward_matches_pallas_interpret(case):
    geo, B, S, H, D, V, lengths, bq, bk = FORWARD_CASES[case]
    q, k, v, table = _arrays(B, S, H, D, V)
    want = np.asarray(jax_pa.pallas_relative_attention(
        *(jnp.asarray(x) for x in (q, k, v, table)), geo, jnp.asarray(lengths, jnp.int32),
        block_q=bq, block_k=bk, interpret=True))
    got, _ = fa.relative_attention_forward(
        *(torch.from_numpy(x) for x in (q, k, v, table)), _port(geo),
        torch.tensor(lengths), device="cpu")
    _assert_real_rows(got.numpy(), want, lengths, FWD_TOL)


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_plain_forward_matches_dense_window_oracle(case):
    geo, B, S, H, D, V, lengths, _, _ = FORWARD_CASES[case]
    q, k, v, table = _arrays(B, S, H, D, V, seed=1)
    want = np.asarray(dense_window_reference(
        *(jnp.asarray(x) for x in (q, k, v, table)), _ids(geo, S),
        jnp.asarray(lengths, jnp.int32), geo.window, geo.num_global))
    got, lse = fa.relative_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, table)), _port(geo), torch.tensor(lengths))
    _assert_real_rows(got.numpy(), want, lengths, FWD_TOL)
    assert torch.isfinite(lse).all()


def test_window_at_least_seq_is_the_dense_plain_version():
    dense = fa.RelGeometry(5, 4, 1)
    windowed = fa.RelGeometry(5, 4, 1, window=256, num_global=18)
    q, k, v, table = (torch.from_numpy(x) for x in _arrays(2, 256, 2, 16, 32, seed=2))
    lengths = torch.tensor([256, 150])
    o_d, lse_d = fa.relative_attention_plain(q, k, v, table, dense, lengths, 0.1, 5)
    o_w, lse_w = fa.relative_attention_plain(q, k, v, table, windowed, lengths, 0.1, 5)
    assert torch.equal(o_d, o_w) and torch.equal(lse_d, lse_w)
    do = torch.from_numpy(np.random.default_rng(3).normal(size=q.shape).astype(np.float32))
    delta = torch.einsum("bshd,bshd->bhs", do, o_d)
    grads_d = fa.relative_attention_backward_plain(q, k, v, do, lse_d, delta, table, dense,
                                                   lengths, 0.1, 5)
    grads_w = fa.relative_attention_backward_plain(q, k, v, do, lse_d, delta, table, windowed,
                                                   lengths, 0.1, 5)
    for name, g_d, g_w in zip(("dq", "dk", "dv", "drel"), grads_d, grads_w):
        assert torch.equal(g_d, g_w), name


def test_allowed_real_pairs_counts_the_pattern():
    geo = fa.RelGeometry(5, 4, 1, window=37, num_global=21)
    lengths = [256, 150, 21, 5, 0]
    pos = torch.arange(256)
    allowed = fa.window_allowed(geo, pos[:, None], pos[None, :])
    want = sum(int(allowed[:n, :n].sum()) for n in lengths)
    assert fa.allowed_real_pairs(geo, lengths) == want
    assert fa.allowed_real_pairs(fa.RelGeometry(5), lengths) == sum(n * n for n in lengths)
    assert fa.allowed_real_pairs(None, [7]) == 49


# ---------------------------------------------------------------- backward

BACKWARD_CASES = {
    "2d": (jax_pa.RelGeometry(text_max_distance=5, num_patch_per_row=4, num_core_layers=1,
                              window=48, num_global=18), 2, 256, 2, 16, 32, [256, 170]),
    "1d": (jax_pa.RelGeometry(text_max_distance=7, window=40, num_global=16),
           2, 256, 2, 16, 15, [256, 131]),
}


def _loss_weights(shape, lengths, seed):
    rng = np.random.default_rng(seed)
    real = (np.arange(shape[1])[None, :] < np.asarray(lengths)[:, None])[:, :, None, None]
    return (rng.normal(size=shape) * real).astype(np.float32)


_ORACLE_GRADS = {}


def _oracle_grads(case):
    """jax.grad of sum(out * w) through the dense window oracle."""
    if case not in _ORACLE_GRADS:
        geo, B, S, H, D, V, lengths = BACKWARD_CASES[case]
        arrays = _arrays(B, S, H, D, V, seed=3)
        w = _loss_weights((B, S, H, D), lengths, 4)
        ids, lens = _ids(geo, S), jnp.asarray(lengths, jnp.int32)

        def loss(q, k, v, table):
            out = dense_window_reference(q, k, v, table, ids, lens, geo.window, geo.num_global)
            return jnp.sum(out * w)

        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in arrays))
        _ORACLE_GRADS[case] = [np.asarray(g) for g in grads]
    return _ORACLE_GRADS[case]


def _assert_grads(got, want, lengths, tol):
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else g
        if name == "drel":
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)
        else:
            _assert_real_rows(g, w, lengths, tol, name)


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_plain_backward_matches_jax_grad_of_oracle(case):
    geo, B, S, H, D, V, lengths = BACKWARD_CASES[case]
    q, k, v, table = (torch.from_numpy(x) for x in _arrays(B, S, H, D, V, seed=3))
    w = torch.from_numpy(_loss_weights((B, S, H, D), lengths, 4))
    lens = torch.tensor(lengths)
    o, lse = fa.relative_attention_plain(q, k, v, table, _port(geo), lens)
    delta = torch.einsum("bshd,bshd->bhs", w, o)
    got = fa.relative_attention_backward_plain(q, k, v, w, lse, delta, table, _port(geo), lens)
    _assert_grads(got, _oracle_grads(case), lengths, BWD_TOL)


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_function_matches_jax_grad_of_oracle(case):
    geo, B, S, H, D, V, lengths = BACKWARD_CASES[case]
    leaves = [torch.from_numpy(x).requires_grad_() for x in _arrays(B, S, H, D, V, seed=3)]
    w = torch.from_numpy(_loss_weights((B, S, H, D), lengths, 4))
    out = fa.relative_attention(*leaves, _port(geo), torch.tensor(lengths), device="cpu")
    got = torch.autograd.grad((out * w).sum(), leaves)
    _assert_grads(got, _oracle_grads(case), lengths, BWD_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_function_matches_pallas_interpret_backward(rate):
    """K4 (``_bwd_fused_list_kernel``, the default windowed backward) in
    interpret mode at S=128 with 32-blocks, dropout included."""
    geo = jax_pa.RelGeometry(text_max_distance=5, num_patch_per_row=4, num_core_layers=1,
                             window=24, num_global=18)
    B, S, H, D, V, lengths, seed = 2, 128, 2, 16, 32, [128, 77], -987654
    arrays = _arrays(B, S, H, D, V, seed=5)
    w = _loss_weights((B, S, H, D), lengths, 6)

    def loss(q, k, v, table):
        out = jax_pa.pallas_relative_attention(
            q, k, v, table, geo, jnp.asarray(lengths, jnp.int32), block_q=32, block_k=32,
            interpret=True, dropout_rate=rate, dropout_seed=jnp.int32(seed) if rate else None)
        return jnp.sum(out * w)

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in arrays))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = fa.relative_attention(*leaves, _port(geo), torch.tensor(lengths), rate,
                                seed if rate else None, device="cpu")
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    _assert_grads(got, want, lengths, BWD_TOL)


# ------------------------------------------------------------------- model

WINDOW, TINY = 24, dict(hidden_size=32, num_attention_heads=2, intermediate_size=64)


_JAX_LOGITS = {}


def _jax_windowed_logits(impl):
    """Logits of JAX's tiny windowed pretraining model (bridged params from
    ``test_torch_pretraining``'s init at hidden 32)."""
    if impl not in _JAX_LOGITS:
        inputs = {k: jnp.asarray(v) for k, v in model_inputs().items()}
        if "params" not in _JAX_LOGITS:
            _JAX_LOGITS["params"] = jax.tree_util.tree_map(
                np.asarray, _jax_model(True, **TINY).init(jax.random.PRNGKey(0), **inputs))
        model = _jax_model(True, **TINY, attention_window=WINDOW, attention_impl=impl,
                           attention_block_q=32, attention_block_k=32)
        out = model.apply(_JAX_LOGITS["params"], **inputs, deterministic=True)
        _JAX_LOGITS[impl] = {k: np.asarray(out[k]) for k in ("mlm_logits", "mpp_logits",
                                                            "itm_logits")}
    return _JAX_LOGITS[impl]


@pytest.mark.parametrize("torch_impl", ["xla", "pallas"])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_tiny_windowed_model_matches_jax(jax_impl, torch_impl):
    want = _jax_windowed_logits(jax_impl)
    params = _JAX_LOGITS["params"]
    inputs = {k: torch.from_numpy(v) for k, v in model_inputs().items()}
    outs, geos = {}, {}
    for window in (WINDOW, 0):
        model = torch_pretraining_model(True, **TINY, attention_window=window,
                                        attention_impl=torch_impl).eval()
        model.load_state_dict(params_from_flax(params, model))
        geo = model.encoder.transformer.layers[0].attention.geometry
        geos[window] = (geo.window, geo.num_global)
        with torch.no_grad():
            outs[window] = model(**inputs)
    assert geos == {WINDOW: (WINDOW, 18), 0: (0, 18)}  # auto num_global: 2 + P**2
    for key, value in want.items():
        np.testing.assert_allclose(outs[WINDOW][key].numpy(), value, atol=MODEL_TOL, rtol=0,
                                   err_msg=key)
    # The pattern changes the function by more than the tolerance above.
    changed = (outs[WINDOW]["mlm_logits"] - outs[0]["mlm_logits"]).abs().max().item()
    assert changed > 2 * MODEL_TOL, changed


# -------------------------------------------------------------- task, remat


def _task_cfg(**enc):
    cfg = copy.deepcopy(_TASK_CFG)
    cfg["model"]["encoder"]["mmt"].update(attention_window=WINDOW, remat=True, **enc)
    return cfg


def _jax_task(micro=0, opt=None, steps=3):
    trainer = jax_override(JaxTrainerConfig(), {
        "train_steps": steps, "micro_batch_size": micro, "optimizer_config": opt or {}})
    return JaxTask(jax_override(JaxTaskConfig(), _task_cfg(attention_impl="xla")), trainer)


def _torch_task(micro=0, opt=None, steps=3, **enc):
    trainer = override(TrainerConfig(), {
        "train_steps": steps, "micro_batch_size": micro, "optimizer_config": opt or {}})
    return PretrainingTask(override(PretrainingTaskConfig(), _task_cfg(**enc)), trainer,
                           device="cpu")


_TASK_PARAMS = {}


def _bridged(task, jax_task):
    if "params" not in _TASK_PARAMS:
        b = {k: jnp.asarray(v) for k, v in _batch().items()}
        _TASK_PARAMS["params"] = jax.tree_util.tree_map(
            np.asarray, jax_task.init(jax.random.PRNGKey(0), b))
    task.model.load_state_dict(params_from_flax(_TASK_PARAMS["params"], task.model))
    return _TASK_PARAMS["params"]


@pytest.mark.parametrize("micro", [0, 2], ids=["one_batch", "micro_batches"])
def test_remat_window_task_grads_match_jax(micro):
    jax_task, task = _jax_task(micro), _torch_task(micro)
    assert jax_task.config.model.encoder.mmt.remat and task.model.encoder.transformer.remat
    params = _bridged(task, jax_task)
    batch = _batch()
    jstate = JaxTrainState.create(params, optax.sgd(1.0))
    jnew, jmetrics = jax_task.make_train_step(micro_batch_size=micro)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = _to_port_names(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, jnew.params), task.model)
    recorder = _GradRecorder(task.model)
    _, metrics = task.make_train_step(micro)(TrainState(step=0, model=task.model,
                                                        optimizer=recorder),
                                             batch_to_device(batch, "cpu"))
    for name, (total, count) in jmetrics.items():
        np.testing.assert_allclose(metrics[name][0].item() / metrics[name][1].item(),
                                   float(total) / float(count), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    _assert_trees_close(recorder.grads, want, 1e-4, floor=1e-6)


def test_two_remat_window_train_steps_match_jax_params():
    opt = {"polynomial": {"initial_learning_rate": 1e-3, "decay_steps": 10},
           "warmup": {"warmup_steps": 1}}
    jax_task, task = _jax_task(2, opt, steps=2), _torch_task(2, opt, steps=2)
    params = _bridged(task, jax_task)
    jstate = JaxTrainState.create(params, jax_optimizer.create_optimizer(
        jax_task.trainer.optimizer_config, 2))
    jstep = jax_task.make_train_step(micro_batch_size=2)
    state = TrainState.create(task.model, create_optimizer(
        task.trainer.optimizer_config, 2, task.model))
    step = task.make_train_step(2)
    for i in range(2):
        batch = _batch(seed=20 + i)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(i))
        state, _ = step(state, batch_to_device(batch, "cpu"))
    want = _to_port_names(jax.tree_util.tree_map(np.asarray, jstate.params), task.model)
    got = {n: p.detach().numpy() for n, p in task.model.named_parameters()}
    _assert_trees_close(got, want, 1e-5)


def _dropout_grads(remat, impl):
    task = _torch_task(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                       attention_impl=impl)
    task.model.encoder.transformer.remat = remat
    rngs = DropoutRngs(host=torch.Generator().manual_seed(11),
                       device=torch.Generator().manual_seed(12))
    loss, _ = task.compute_loss(batch_to_device(_batch(seed=4), "cpu"), rngs)
    loss.backward()
    return {n: p.grad for n, p in task.model.named_parameters()}


@pytest.fixture
def deterministic():
    """The embedding gathers' backward (``index_put_`` with accumulation)
    sums in a run-dependent order on the CPU unless deterministic
    algorithms are on; without this two runs differ in the embedding
    tables whatever remat does."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_gives_bit_identical_grads_with_dropout(deterministic, impl):
    """A recomputed layer replays its hidden and attention dropout masks:
    the gradients with remat are those without, bit for bit."""
    with_remat, without = _dropout_grads(True, impl), _dropout_grads(False, impl)
    assert with_remat.keys() == without.keys()
    for name, g in with_remat.items():
        assert torch.equal(g, without[name]), name
    assert any(g.abs().max() > 0 for g in with_remat.values())


@pytest.mark.parametrize("remat", [True, False])
def test_remat_recomputes_each_layer_in_the_backward(monkeypatch, remat):
    calls = []
    forward = RelativeTransformerLayer.forward

    def counted(self, *args):
        calls.append(1)
        return forward(self, *args)

    # Module hooks do not run in the recompute, so the count is taken here.
    monkeypatch.setattr(RelativeTransformerLayer, "forward", counted)
    task = _torch_task(attention_probs_dropout_prob=0.1)
    task.model.encoder.transformer.remat = remat
    loss, _ = task.compute_loss(batch_to_device(_batch(), "cpu"),
                                DropoutRngs(host=torch.Generator().manual_seed(1)))
    layers = len(task.model.encoder.transformer.layers)
    assert len(calls) == layers
    loss.backward()
    assert len(calls) == (2 if remat else 1) * layers
