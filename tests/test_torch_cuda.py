"""The Hopper relative-attention kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one.  The file imports no
JAX, so that it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bounds (bf16 inputs):

* forward: 2e-2 on o and 1e-3 on lse, on real rows.  Both versions round
  p to bf16 before p.v, but the kernel rounds the unnormalised p and
  divides after the product, sums in another order and uses the fast
  exponential.
* backward: max |kernel - plain| <= 2e-2 * max |plain| for each of dq,
  dk and dv.  The kernel rounds p * keep, dS and the id histogram dSV to
  bf16 for the dv, dk and dq products (the plain version keeps them in
  fp32: 2**-9 relative per term), writes bf16 outputs (one more
  rounding) and sums in another order.  Rows past the length must be
  exactly 0 in both.
* dRel keeps dSV in fp32 up to its product, which runs in two bf16 terms
  (dSV's bf16 rounding and the remainder, ~16 bits), and differs by the
  fast exponential and the order of its sums and atomics: max |kernel -
  plain| <= 1e-4 * max |plain|, and each (id, head) row within 1e-3 of its
  own norm, so that a lost or doubled run of a rare id fails; rows that
  are 0 in the plain version (ids no pair has) must be 0.
* windowed kernels (sliding window + global prefix): the same bounds
  against the plain versions with the window term, and launches counted
  apart.  At window >= S the windowed instantiations are bit-identical to
  the dense ones in o, lse, dk and dv.  dq and dRel are held to their
  bounds there: the backward kernel sums both by fp32 reductions to
  global memory, in an order that varies from run to run.
* model gradients: relative Frobenius error <= 5e-2 per parameter tensor
  between the fused and the dense model in bf16, whose attention rounds
  p at other places and whose backward runs through autograd (the key
  bias, whose exact gradient is 0, against the query bias's norm).
"""

import numpy as np
import pytest
import torch

from mmt_tpu_torch.ops import fused_attention as fa

O_BOUND, LSE_BOUND = 2e-2, 1e-3
GRAD_REL_BOUND = 2e-2
DREL_REL_BOUND, DREL_ROW_BOUND = 1e-4, 1e-3
MODEL_GRAD_BOUND = 5e-2
FLAGSHIP = fa.RelGeometry(text_max_distance=12, num_patch_per_row=14, num_core_layers=1)

CASES = [
    (FLAGSHIP, 512, 4, 64, 49, [512, 301, 70]),
    (FLAGSHIP, 512, 2, 32, 49, [512, 257]),
    (FLAGSHIP, 200, 2, 64, 49, [200, 131]),  # S not a multiple of the tile
    (fa.RelGeometry(3, 4, 1), 128, 2, 64, 33, [128, 100]),  # part ids in vocabulary
    (fa.RelGeometry(12), 384, 2, 64, 25, [384, 200]),  # 1D ids only
    (None, 256, 2, 64, 1, [256, 65]),  # no relative bias
]
CASE_IDS = ["flagship", "head_dim_32", "ragged_s", "parts_in_vocab", "1d", "no_rel"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(dev, B, S, H, D, V, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    table = torch.from_numpy(rng.standard_normal((V, H, D), np.float32)).to(dev)
    return q, k, v, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo,S,H,D,V,lengths", CASES, ids=CASE_IDS)
def test_kernel_matches_plain(cuda, geo, S, H, D, V, lengths, rate):
    q, k, v, table, lens = _inputs(cuda, len(lengths), S, H, D, V, lengths)
    seed = 1234 if rate else None
    before = fa.relative_attention_forward.launches
    o, lse = fa.relative_attention_forward(q, k, v, table, geo, lens, "cuda", rate, seed)
    torch.cuda.synchronize()
    assert fa.relative_attention_forward.launches == before + 1
    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, geo, lens, rate, seed)
    for b, n in enumerate(lengths):
        assert (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item() < O_BOUND
        assert (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item() < LSE_BOUND
        first_pad_tile = -(-n // 64) * 64  # query tiles past the length
        assert torch.all(o[b, first_pad_tile:] == 0)
        assert torch.all(lse[b, :, first_pad_tile:] == float("-inf"))


def _assert_forward_close(o, lse, o_ref, lse_ref, lengths):
    for b, n in enumerate(lengths):
        assert (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item() < O_BOUND
        assert (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item() < LSE_BOUND


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_every_tile_class(cuda, rate):
    """One sequence of the flagship geometry at S=1024 holds every class of
    tile the kernel tells apart: the 196-slot image corner over 4 x 4
    tiles (with the tile that straddles its edge), one-id image x text and
    text x image tiles, the text band around the diagonal and far text
    tiles on both sides; the lengths cut a tile, fill it, and end inside
    the image."""
    lengths = [1024, 651, 150]
    ids = fa.relative_att_ids(FLAGSHIP, 1024)
    classes = {fa.uniform_tile_id(q0, k0, FLAGSHIP) for q0 in range(0, 1024, 64)
               for k0 in range(0, 1024, 64)}
    assert classes == {-1, FLAGSHIP.image_part_id, FLAGSHIP.text_part_id, 12, 24}, classes
    assert ids[0, 1000] == FLAGSHIP.text_part_id and ids[1000, 0] == FLAGSHIP.image_part_id
    q, k, v, table, lens = _inputs(cuda, len(lengths), 1024, 4, 64, 49, lengths, seed=21)
    seed = 55 if rate else None
    o, lse = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens, "cuda", rate, seed)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, FLAGSHIP, lens, rate, seed)
    _assert_forward_close(o, lse, o_ref, lse_ref, lengths)


def test_kernel_pretraining_micro_batch(cuda):
    """The pretraining micro-batch's shape (B=64, S=256, H=12, lengths ~
    U[204, 256]) with attention dropout 0.1: at most 4 key tiles a block."""
    lengths = np.random.default_rng(3).integers(204, 257, 64).tolist()
    q, k, v, table, lens = _inputs(cuda, 64, 256, 12, 64, 49, lengths, seed=22)
    o, lse = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens, "cuda", 0.1, 808)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, FLAGSHIP, lens, 0.1, 808)
    _assert_forward_close(o, lse, o_ref, lse_ref, lengths)


def test_rate_zero_is_the_kernel_without_dropout(cuda):
    q, k, v, table, lens = _inputs(cuda, 2, 512, 4, 64, 49, [512, 301])
    o, lse = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens)
    o0, lse0 = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens, "cuda", 0.0, 99)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    o1, lse1 = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens, "cuda", 0.1, 99)
    assert torch.equal(lse, lse1)  # l sums p before the dropout
    assert not torch.equal(o, o1)


def _backward_case(dev, geo, S, H, D, V, lengths, rate, seed=5):
    q, k, v, table, lens = _inputs(dev, len(lengths), S, H, D, V, lengths, seed=seed)
    drop_seed = -77 if rate else None
    o, lse = fa.relative_attention_forward(q, k, v, table, geo, lens, "cuda", rate, drop_seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape, np.float32)).to(dev, torch.bfloat16)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    args = (q, k, v, do, lse, delta, table if geo is not None else None, geo, lens)
    return args, rate, drop_seed


def _assert_grads_close(got, want, lengths):
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        if w is None:
            assert g is None
            continue
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        bound = DREL_REL_BOUND if name == "drel" else GRAD_REL_BOUND
        assert err <= bound * w.abs().max().item(), (name, err, w.abs().max().item())
        if name == "drel":
            row_err, row_ref = (g - w).norm(dim=-1), w.norm(dim=-1)
            zero = row_ref == 0
            assert torch.all(row_err[zero] == 0), "rows of ids no pair has"
            worst = (row_err[~zero] / row_ref[~zero]).max().item()
            assert worst <= DREL_ROW_BOUND, ("drel row", worst)
        else:
            for b, n in enumerate(lengths):
                assert torch.all(g[b, n:] == 0) and torch.all(w[b, n:] == 0), name


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo,S,H,D,V,lengths", CASES, ids=CASE_IDS)
def test_backward_kernels_match_plain(cuda, geo, S, H, D, V, lengths, rate):
    args, rate, seed = _backward_case(cuda, geo, S, H, D, V, lengths, rate)
    before = _window_counts()
    got = fa.relative_attention_backward(*args, "cuda", rate, seed)
    torch.cuda.synchronize()
    assert np.subtract(_window_counts(), before).tolist() == [0, 0, 1, 0]
    want = fa.relative_attention_backward_plain(*args, rate, seed)
    _assert_grads_close(got, want, lengths)


WINDOW_CASES = [
    (fa.RelGeometry(5, 4, 1, window=48, num_global=18), 512, 2, 64, 32, [512, 300]),
    (fa.RelGeometry(3, 4, 1, window=37, num_global=21), 256, 2, 32, 40, [256, 150]),
    (fa.RelGeometry(12, 14, 1, window=128, num_global=198), 1024, 2, 64, 49, [1024, 700, 250]),
    (fa.RelGeometry(12, window=64, num_global=16), 384, 2, 64, 25, [384, 200]),
]
WINDOW_IDS = ["2d_w48", "unaligned_w37_d32", "flagship_w128", "1d_w64"]


def _window_counts():
    return (fa.relative_attention_forward.launches, fa.relative_attention_forward.launches_window,
            fa.relative_attention_backward.launches, fa.relative_attention_backward.launches_window)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geo,S,H,D,V,lengths", WINDOW_CASES, ids=WINDOW_IDS)
def test_window_kernels_match_plain(cuda, geo, S, H, D, V, lengths, rate):
    before = _window_counts()
    args, rate, seed = _backward_case(cuda, geo, S, H, D, V, lengths, rate)
    q, k, v, do, lse, delta, table, _, lens = args
    o, _ = fa.relative_attention_forward(q, k, v, table, geo, lens, "cuda", rate, seed)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, geo, lens, rate, seed)
    for b, n in enumerate(lengths):
        assert (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item() < O_BOUND
        assert (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item() < LSE_BOUND
    got = fa.relative_attention_backward(*args, "cuda", rate, seed)
    torch.cuda.synchronize()
    # Two windowed forwards (one in _backward_case), one windowed backward.
    assert np.subtract(_window_counts(), before).tolist() == [0, 2, 0, 1]
    _assert_grads_close(got, fa.relative_attention_backward_plain(*args, rate, seed), lengths)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_window_at_least_seq_is_dense(cuda, rate):
    dense = fa.RelGeometry(12, 14, 1)
    windowed = fa.RelGeometry(12, 14, 1, window=512, num_global=198)
    args, rate, seed = _backward_case(cuda, dense, 512, 2, 64, 49, [512, 301], rate)
    q, k, v, do, lse, delta, table, _, lens = args
    o_d, lse_d = fa.relative_attention_forward(q, k, v, table, dense, lens, "cuda", rate, seed)
    o_w, lse_w = fa.relative_attention_forward(q, k, v, table, windowed, lens, "cuda", rate, seed)
    assert torch.equal(o_d, o_w) and torch.equal(lse_d, lse_w)
    grads_d = fa.relative_attention_backward(*args, "cuda", rate, seed)
    grads_w = fa.relative_attention_backward(q, k, v, do, lse, delta, table, windowed, lens,
                                             "cuda", rate, seed)
    assert torch.equal(grads_d[1], grads_w[1]) and torch.equal(grads_d[2], grads_w[2])
    for g_d, g_w, bound in ((grads_d[0], grads_w[0], GRAD_REL_BOUND),
                            (grads_d[3], grads_w[3], DREL_REL_BOUND)):
        assert (g_w - g_d).abs().max().item() <= bound * g_d.abs().max().item()


def test_function_grads_reach_every_input(cuda):
    q, k, v, table, lens = _inputs(cuda, 2, 256, 2, 64, 49, [256, 200])
    q, k, v, table = (t.detach().requires_grad_() for t in (q, k, v, table))
    o = fa.relative_attention(q, k, v, table, FLAGSHIP, lens, 0.1, 3)
    o.float().square().sum().backward()
    for t in (q, k, v, table):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, table, lens = _inputs(cuda, 1, 128, 2, 64, 49, [128])
    with pytest.raises(TypeError):
        fa.relative_attention_forward(q.float(), k.float(), v.float(), table, FLAGSHIP, lens)
    with pytest.raises(ValueError):
        fa.relative_attention_forward(q, k, v, table.repeat(2, 1, 1), FLAGSHIP, lens)
    q16 = q[..., :16].contiguous()
    with pytest.raises(ValueError):
        fa.relative_attention_forward(q16, q16, q16, table[..., :16], FLAGSHIP, lens)
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens, "cuda", 0.1)


def _model_grads(dev, impl, **enc_extra):
    """Parameter gradients of a small classification model (2 layers,
    hidden 128, S=128, P=4) on a seeded batch, in train() mode."""
    from mmt_tpu_torch.configs import (
        ClassificationModelConfig, ClsHeadConfig, EncoderConfig, MmtEncoderConfig)
    from mmt_tpu_torch.models import DropoutRngs, MmtClassificationModel

    enc = MmtEncoderConfig(**{
        "vocab_size": 100, "hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 256, "relative_vocab_size": 49, "relative_att_num_core_layers": 1,
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.1, "attention_impl": impl,
        **enc_extra})
    cfg = ClassificationModelConfig(encoder=EncoderConfig(mmt=enc), num_classes=2,
                                    cls_heads=[ClsHeadConfig(inner_dim=128, name="itm")])
    model = MmtClassificationModel(cfg, num_patch_per_row=4, patch_dim=48, device=dev,
                                   seed=0).train()
    rng = np.random.default_rng(0)
    inputs = dict(
        word_ids=torch.from_numpy(rng.integers(0, 100, (2, 128))).to(dev),
        patch_embeddings=torch.from_numpy(rng.standard_normal((2, 16, 48), np.float32)).to(dev),
        lengths=torch.tensor([128, 90], device=dev))
    rngs = DropoutRngs(host=torch.Generator().manual_seed(7),
                       device=torch.Generator(dev).manual_seed(8))
    model(**inputs, rngs=rngs)["itm_logits"].sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_fused_model_grads_match_dense(cuda):
    """The model with attention_impl="pallas" gets gradients for every
    parameter through the kernels, and they match the same model with
    dense attention (autograd through the plain version)."""
    _assert_model_grads_close(_model_grads(cuda, "pallas"), _model_grads(cuda, "xla"))


def test_windowed_remat_model_grads_match_dense(cuda):
    """The same with the sliding window (24, auto global prefix 18) and
    remat: the windowed kernels run twice forward and once backward per
    layer, and hidden dropout replays its masks in the recompute."""
    counts = _window_counts()
    extra = dict(attention_window=24, remat=True, hidden_dropout_prob=0.1)
    got = _model_grads(cuda, "pallas", **extra)
    assert np.subtract(_window_counts(), counts).tolist() == [0, 4, 0, 2]
    _assert_model_grads_close(got, _model_grads(cuda, "xla", **extra))


def _assert_model_grads_close(got, want):
    errors = {}
    for name, g in got.items():
        assert g is not None and want[name] is not None, name
        errors[name] = (g - want[name]).norm().item() / gradient_scale(want, name)
    assert max(errors.values()) <= MODEL_GRAD_BOUND, sorted(errors.items(), key=lambda kv: -kv[1])[:5]


def gradient_scale(grads, name):
    """The norm a gradient's error is measured against: its own, except
    for the key bias, whose exact gradient is 0 (softmax is invariant to
    adding q . b_k to every logit of a row), so that both sides give
    rounding noise; it is measured against the same layer's query-bias
    gradient."""
    if name.endswith("attention.key.bias"):
        name = name[: -len("key.bias")] + "query.bias"
    return max(grads[name].norm().item(), 1e-12)


# ------------------------------------------------------------------ probes
# The probe kernels (``mmt_tpu_torch.probes``) against their plain versions;
# each module's docstring states its tolerance and why.


@pytest.mark.parametrize("seq_len,lengths", [(1024, [1024, 700, 257]), (448, [448, 300])],
                         ids=["s1024", "s448"])
def test_split_probe_matches_one_pass_and_plain(cuda, seq_len, lengths):
    from mmt_tpu_torch.probes import split_probe as sp

    sp.split_pass.launches_far = sp.split_pass.launches_structured = 0
    errors = sp.check(lengths, seed=5, seq_len=seq_len, heads=2)
    for name in ("far_vs_plain", "structured_vs_plain", "combined_vs_one_pass",
                 "combined_vs_plain"):
        assert errors[name]["o"] <= sp.O_BOUND and errors[name]["lse"] <= sp.LSE_BOUND, name
    assert (sp.split_pass.launches_far, sp.split_pass.launches_structured) == (1, 1)


def test_op_cost_probe_variants_match_plain(cuda):
    from mmt_tpu_torch.probes import op_cost_probe as oc

    before = dict(oc.op_cost.launches)
    errors = oc.check()
    assert set(errors) == set(oc.VARIANTS)
    assert all(errors[name] <= oc.rel_bound(name) for name in errors)
    assert all(oc.op_cost.launches[name] == before[name] + 1 for name in oc.VARIANTS)


def test_hopper_probes_ok(cuda):
    from mmt_tpu_torch.probes import hopper_probe as hp

    for name in hp.PROBES:
        assert hp.run_probe(name) <= hp.PROBES[name][3], name
    assert all(count >= 1 for count in hp.launches.values())


# Scalars at the ends of their ranges: off in [0, 192] (36 is the TPU
# probe's, 37 not a multiple of 4); s any int32 (5 is the TPU probe's).
MOSAIC_SCALARS = {"dynamic_lane_store": [0, 1, 36, 37, 191, 192],
                  "uniform_dynamic_roll": [0, 1, 5, 255, 256, -3, -2**31, 2**31 - 1]}


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("name", ["strided_roll", "static_unaligned_store", "many_static_stores",
                                  "dynamic_lane_store", "uniform_dynamic_roll", "small_matmul"])
def test_mosaic_probe_kernels_match_plain(cuda, name, batch):
    """Each P3 kernel against its plain version: the copies exact, the
    product within the TPU probe's atol of 1e-3."""
    from mmt_tpu_torch.probes import mosaic_probe as mp

    probe = mp.PROBES[name]
    rng = np.random.default_rng(7)
    for scalar in MOSAIC_SCALARS.get(name, [None]):
        inputs = probe.seeded(rng, batch) if scalar is None else probe.seeded(rng, batch, scalar)
        inputs = tuple(t.to(cuda) for t in inputs)
        before = mp.launches[name]
        got = probe.kernel(*inputs)
        torch.cuda.synchronize()
        want = probe.plain(*inputs)
        assert mp.launches[name] == before + 1
        if probe.atol:
            assert (got - want).abs().max().item() <= probe.atol, (name, scalar)
        else:
            assert torch.equal(got, want), (name, scalar)


# The product kernel's fp32 sums round at each of 24 steps: against the
# split's one rounding (and the emulated schedule's), a few fp32 spacings
# of sums ~40.
MOSAIC_MATMUL_VS_SPLIT = 1e-4


@pytest.mark.parametrize("batch", [1, 3, 133, 1024])  # 1024: the timing batch
def test_mosaic_small_matmul_schedule(cuda, batch):
    """The product's persistent grid at batches that fill no wave (1, 3), a
    ragged one (133) and the timing batch: within the TPU probe's atol of
    the float64 product, and close to the split's product and (up to 133)
    to its schedule emulated on the card's grid."""
    from mmt_tpu_torch.probes import mosaic_probe as mp

    probe = mp.PROBES["small_matmul"]
    assert probe.timing_batch == 1024
    x, w = probe.seeded(np.random.default_rng(batch), batch)
    got = mp.small_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    got = got.cpu()
    assert (got - mp.small_matmul_plain(x, w)).abs().max() <= mp.MATMUL_ATOL
    assert (got - mp.small_matmul_split(x, w)).abs().max() <= MOSAIC_MATMUL_VS_SPLIT
    grid = mp.small_matmul_grid(batch)
    assert 1 <= grid <= batch
    if batch <= 133:
        emulated = mp.small_matmul_emulated(x, w, grid)
        assert (got - emulated).abs().max() <= MOSAIC_MATMUL_VS_SPLIT


def test_mosaic_probe_entry_point_ok(cuda):
    from mmt_tpu_torch.probes import mosaic_probe as mp

    assert set(mp.run().values()) == {"OK"}


@pytest.mark.parametrize("m,k,n", [(8192, 768, 3072), (5, 20, 13), (17, 64, 8)])
def test_int8_matmul_on_the_card_equals_plain(cuda, m, k, n):
    """``torch._int_mm`` with its padding (M > 16, K and N multiples of 8)
    against the exact float64 product, bit for bit."""
    from mmt_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda, generator=gen)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda, generator=gen)
    assert torch.equal(quant.int8_matmul(a, b), quant.int8_matmul_plain(a, b))


def test_exported_op_launches_the_kernel(cuda):
    """The forward kernel's registered op inside a ``torch.export`` program:
    the loaded program launches the kernel (counted) and equals the eager
    call."""
    import io

    q, k, v, table, lens = _inputs(cuda, 3, 200, 2, 64, 49, [200, 131, 64])

    class Attention(torch.nn.Module):
        def forward(self, q, k, v, table, lens):
            return fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens)[0]

    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(Attention(), (q, k, v, table, lens), dynamic_shapes=(
        {0: batch}, {0: batch}, {0: batch}, None, {0: batch}))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    before = fa.relative_attention_forward.launches
    got = loaded(q, k, v, table, lens)
    assert fa.relative_attention_forward.launches == before + 1
    want, _ = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens)
    for b, n in enumerate([200, 131, 64]):
        assert torch.equal(got[b, :n], want[b, :n])


def test_two_platform_artifact(cuda):
    """``export_scoring(platforms=("cpu", "cuda"))`` of a small bf16 task on
    the card (static batch 4): its cuda program scores bit for bit as the
    one-platform artifact does and launches the kernel; its CPU program,
    called with the parameters on the host, launches nothing and scores
    within 4 bf16 spacings of it; a device without a program raises."""
    from mmt_tpu_torch.configs import (
        ClassificationModelConfig,
        ClassificationTaskConfig,
        ClsHeadConfig,
        EncoderConfig,
        MmtClassificationDataConfig,
        MmtEncoderConfig,
        TrainerConfig,
    )
    from mmt_tpu_torch.eval import export
    from mmt_tpu_torch.train.tasks import ClassificationTask

    encoder = MmtEncoderConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=256,
                               relative_pos_max_distance=3, relative_vocab_size=12,
                               relative_att_num_core_layers=1, attention_impl="pallas",
                               compute_dtype="bfloat16")
    cfg = ClassificationTaskConfig(
        model=ClassificationModelConfig(
            encoder=EncoderConfig(mmt=encoder), num_classes=2,
            cls_heads=[ClsHeadConfig(inner_dim=128, num_classes=2, name="itm")]),
        train_data=MmtClassificationDataConfig(image_size=4, patch_size=2, max_seq_len=16))
    task = ClassificationTask(cfg, TrainerConfig(train_steps=2), device=cuda, seed=3)
    rng = np.random.default_rng(5)
    B, S = 4, 16
    batch = {"word_ids": rng.integers(0, 64, (B, S)).astype(np.int32),
             "segment_ids": np.where(np.arange(S)[None] < 6, 0, 1).repeat(B, 0).astype(np.int32),
             "patch_embeddings": rng.standard_normal((B, 4, 12)).astype(np.float32),
             "lengths": np.asarray([16, 11, 9, 7], np.int32)}
    params = task.model.state_dict()
    two = export.load_scoring(export.export_scoring(task, params, batch,
                                                    platforms=("cpu", "cuda"),
                                                    symbolic_batch=False))
    one = export.load_scoring(export.export_scoring(task, params, batch, symbolic_batch=False))
    assert two.platforms == ["cpu", "cuda"] and one.platforms == ["cuda"]
    before = fa.relative_attention_forward.launches
    got = two.call(params, batch)
    assert fa.relative_attention_forward.launches == before + 2 and got.device.type == "cuda"
    assert torch.equal(got, one.call(params, batch))
    host = {k: v.cpu() for k, v in params.items()}
    before = fa.relative_attention_forward.launches
    on_host = two.call(host, batch)
    assert fa.relative_attention_forward.launches == before and on_host.device.type == "cpu"
    assert (on_host.float() - got.float().cpu()).abs().max().item() <= 4 * 2.0 ** -8
    with pytest.raises(ValueError, match="programs for"):
        one.call(host, batch)
    # The parameters on the card and the batch as host tensors: refused,
    # never run by the CPU program.
    host_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for artifact in (two, one):
        with pytest.raises(ValueError, match="tensors on cpu and cuda:0"):
            artifact.call(params, host_batch)


OFFSET_FORMS = [  # (q_start, S_q, k_start, S_k): all-gather shard, ring pairs
    (256, 128, 0, 512), (256, 128, 128, 128), (0, 128, 384, 128), (384, 128, 384, 128)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("form", OFFSET_FORMS, ids=["all_gather", "below", "above", "diagonal"])
def test_offset_kernels_match_plain(cuda, form, window, rate):
    """The offset mode: a shard's rows against a chunk's keys at global
    positions, forward and backward (against the unsharded call's lse),
    with batch_start 3, on real rows that have a live key in the chunk."""
    import dataclasses

    q_start, seq_q, k_start, seq_k = form
    geo = dataclasses.replace(FLAGSHIP, window=window, num_global=198 if window else 0)
    lengths = [512, 301, 70]
    q, k, v, table, lens = _inputs(cuda, 3, 512, 4, 64, 49, lengths, seed=9)
    seed = 77 if rate else None
    o_u, lse_u = fa.relative_attention_forward(q, k, v, table, geo, lens, "cuda", rate, seed,
                                               batch_start=3)
    qs, ks = slice(q_start, q_start + seq_q), slice(k_start, k_start + seq_k)
    qc, kc, vc = (t[:, s].contiguous() for t, s in ((q, qs), (k, ks), (v, ks)))
    args = (qc, kc, vc, table, geo, lens)
    offsets = dict(q_start=q_start, k_start=k_start, batch_start=3)
    o, lse = fa.relative_attention_forward(*args, "cuda", rate, seed, **offsets)
    o_ref, lse_ref = fa.relative_attention_plain(*args, rate, seed, **offsets)
    qp = torch.arange(q_start, q_start + seq_q, device=cuda)
    kp = torch.arange(k_start, k_start + seq_k, device=cuda)
    empty = fa.empty_rows(geo, lens, qp, kp)
    live = (qp[None] < lens[:, None]) & ~empty
    assert torch.all(o[empty] == 0) and torch.all(lse.transpose(1, 2)[empty] == -float("inf"))
    if live.any():
        assert (o.float() - o_ref.float())[live].abs().max().item() <= O_BOUND
        assert (lse - lse_ref).transpose(1, 2)[live].abs().max().item() <= LSE_BOUND
    do = torch.randn_like(qc)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o_u[:, qs].float()).contiguous()
    bwd = (qc, kc, vc, do, lse_u[:, :, qs].contiguous(), delta, table, geo, lens)
    got = fa.relative_attention_backward(*bwd, "cuda", rate, seed, **offsets)
    want = fa.relative_attention_backward_plain(*bwd, rate, seed, **offsets)
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        bound = DREL_REL_BOUND if name == "drel" else GRAD_REL_BOUND
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= bound * max(scale, 1e-30), name


def test_ring_shards_assemble_the_unsharded_kernel(cuda):
    from mmt_tpu_torch.ops import sharded_attention as sa

    lengths = [512, 301, 70]
    q, k, v, table, lens = _inputs(cuda, 3, 512, 4, 64, 49, lengths, seed=10)
    o_u, lse_u = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens)
    for fn in (sa.all_gather_shards, sa.ring_shards):
        o, lse = fn(q, k, v, table, FLAGSHIP, lens, 4)
        for b, n in enumerate(lengths):
            assert (o[b, :n].float() - o_u[b, :n].float()).abs().max().item() <= O_BOUND
            assert (lse[b, :, :n] - lse_u[b, :, :n]).abs().max().item() <= LSE_BOUND


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_head_shard_kernels_match_plain_and_the_unsharded_heads(cuda, rate):
    """A tensor-parallel head shard (heads [2, 4) of 4, ``head_start`` 2):
    the kernels against the plain versions with the explicit offset (the
    launchers fold it into the seed), and o, lse, dk, dv bit-equal to the
    unsharded calls' heads; launches counted in ``.launches_head_shard``."""
    lengths = [512, 301, 70]
    q, k, v, table, lens = _inputs(cuda, 3, 512, 4, 64, 49, lengths, seed=11)
    seed = 4321 if rate else None
    heads = slice(2, 4)
    sq, sk, sv = (t[:, :, heads].contiguous() for t in (q, k, v))
    st = table[:, heads].contiguous()
    before = (fa.relative_attention_forward.launches_head_shard,
              fa.relative_attention_backward.launches_head_shard)
    o, lse = fa.relative_attention_forward(sq, sk, sv, st, FLAGSHIP, lens, "cuda", rate, seed,
                                           head_start=2)
    o_ref, lse_ref = fa.relative_attention_plain(sq, sk, sv, st, FLAGSHIP, lens, rate, seed,
                                                 head_start=2)
    _assert_forward_close(o, lse, o_ref, lse_ref, lengths)
    o_u, lse_u = fa.relative_attention_forward(q, k, v, table, FLAGSHIP, lens, "cuda", rate, seed)
    assert torch.equal(o, o_u[:, :, heads]) and torch.equal(lse, lse_u[:, heads])
    do = torch.randn_like(o_u)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o_u.float()).contiguous()
    args = (sq, sk, sv, do[:, :, heads].contiguous(), lse, delta[:, heads].contiguous(), st,
            FLAGSHIP, lens)
    got = fa.relative_attention_backward(*args, "cuda", rate, seed, head_start=2)
    _assert_grads_close(got, fa.relative_attention_backward_plain(*args, rate, seed,
                                                                  head_start=2), lengths)
    whole = fa.relative_attention_backward(q, k, v, do, lse_u, delta, table, FLAGSHIP, lens,
                                           "cuda", rate, seed)
    assert torch.equal(got[1], whole[1][:, :, heads]) and torch.equal(got[2], whole[2][:, :, heads])
    assert (fa.relative_attention_forward.launches_head_shard,
            fa.relative_attention_backward.launches_head_shard) == (before[0] + 1, before[1] + 1)
