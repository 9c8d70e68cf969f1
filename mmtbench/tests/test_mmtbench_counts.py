"""The yardstick's counts against hand counts at a small shape, and the
trace reduction on made-up records."""

import math

import pytest

from mmtbench import peaks
from mmtbench.metrics import (attn_bwd_roofline, attn_fwd_roofline, device_idle_share,
                              embed_bwd_ms, gemm_ms, h2d_ms, step_mfu)
from mmtbench.trace import Trace

SHAPE = {"seq_len": 8, "heads": 2, "head_dim": 4, "rel_vocab": 3, "hidden": 8,
         "intermediate": 16, "layers": 2, "patches": 4, "patch_dim": 6, "vocab": 10}


def test_forward_work_by_hand():
    # lengths 2 and 3: 4 + 9 = 13 real pairs, 5 real rows.
    flops, nbytes = attn_fwd_roofline.forward_work([2, 3], 8, 2, 4, 3)
    assert flops == 4 * 13 * 4 * 2 + 2 * 5 * 3 * 4 * 2
    row = 2 * 4 * 2  # bf16 bytes of one row of q, k, v or o
    assert nbytes == 3 * 5 * row + 2 * 8 * row + 2 * 2 * 8 * 4 + 3 * 2 * 4 * 4 + 2 * 4


def test_backward_work_by_hand():
    flops, nbytes = attn_bwd_roofline.backward_work([2, 3], 8, 2, 4, 3)
    assert flops == 10 * 13 * 4 * 2 + 6 * 5 * 3 * 4 * 2
    row = 2 * 4 * 2
    reads = 4 * 5 * row + 2 * 5 * 2 * 4 + 2 * 64 * 4 * 2 + 2 * 4
    assert nbytes == reads + 3 * 2 * 8 * row + 3 * 2 * 4 * 4


def test_model_flops_by_hand():
    H, I, L = 8, 16, 5
    layer = 8 * L * H * H + 4 * L * H * I + 4 * L * L * H + 2 * L * 3 * H
    per_example = 2 * layer + 2 * 4 * 6 * H + 2 * H * H + 4 * H
    mlm = 2 * H * H + 2 * H * 10
    work = {"examples": [5, 5], "mlm_targets": 3, "training": True}
    assert step_mfu.model_flops(work, SHAPE) == 3 * (2 * per_example + 3 * mlm)
    assert step_mfu.model_flops({**work, "training": False}, SHAPE) == 2 * per_example + 3 * mlm


def test_bound_ms_names_the_roof():
    assert peaks.bound_ms(peaks.BF16_FLOPS, 0) == (1e3, "operations")
    assert peaks.bound_ms(0, peaks.HBM_BYTES_PER_S) == (1e3, "bytes")


def trace(device, host=(), wall_s=1e-3, work=None, units=1):
    return Trace(list(device), list(host), 0.0, 1000.0, wall_s, units, work or {}, 1)


def test_busy_idle_and_gaps():
    t = trace([("a", 0, 100), ("b", 50, 300), ("Memcpy HtoD", 400, 500), ("c", 505, 900)],
              host=[("aten::copy_", 290, 420)])
    assert t.busy_s() == pytest.approx(795e-6)
    assert device_idle_share.read(t, SHAPE)["value"] == pytest.approx(100 * (1 - 0.795))
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps["no host operation recorded"] == pytest.approx(100e-6)
    assert gaps["launch gaps under 20 us"] == pytest.approx(5e-6)
    assert h2d_ms.read(t, SHAPE)["value"] == pytest.approx(0.1)


def test_step_mfu_over_the_window():
    t = trace([("k", 0, 10)])
    t.window = {"seconds": 2.0, "work": {"examples": [5, 5], "training": False}}
    want = step_mfu.model_flops(t.window["work"], SHAPE) / 2.0 / peaks.BF16_FLOPS * 100
    assert step_mfu.read(t, SHAPE)["value"] == pytest.approx(want)


def test_readers_return_nothing_without_records():
    t = trace([("other", 0, 10)], work={"examples": [], "attention_calls": []})
    for mod in (gemm_ms, embed_bwd_ms, h2d_ms, step_mfu, attn_fwd_roofline, attn_bwd_roofline):
        assert mod.read(t, SHAPE) is None


def test_roofline_share_from_records():
    calls = [[2, 3]] * 4
    bound = peaks.bound_ms(*attn_fwd_roofline.forward_work([2, 3], 8, 2, 4, 3))[0]
    # three of four records kept: the mean bound of a call stands for each
    t = trace([("rel_attention_fwd_kernel", i * 10, i * 10 + 2) for i in range(3)],
              work={"attention_calls": calls})
    got = attn_fwd_roofline.read(t, SHAPE)
    assert got["value"] == pytest.approx(100 * bound * 3 / 0.006)
    assert got["bound_by"] == "bytes"
    assert not math.isnan(got["value"])
