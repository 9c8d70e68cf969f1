"""The Hopper relative-attention kernel against its plain version, on the card.

These tests need an NVIDIA GPU and skip without one.  The file imports no
JAX, so that it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bounds (bf16 inputs): 2e-2 on o and 1e-3 on lse, on real rows.  Both
versions round p to bf16 before p.v, but the kernel rounds the
unnormalised p and divides after the product, sums in another order and
uses the fast exponential.
"""

import numpy as np
import pytest
import torch

from mmt_tpu_torch.ops import fused_attention as fa

O_BOUND, LSE_BOUND = 2e-2, 1e-3
FLAGSHIP = fa.RelGeometry(text_max_distance=12, num_patch_per_row=14, num_core_layers=1)


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


@pytest.mark.parametrize("geo,S,H,D,V,lengths", [
    (FLAGSHIP, 512, 4, 64, 49, [512, 301, 70]),
    (FLAGSHIP, 512, 2, 32, 49, [512, 257]),
    (FLAGSHIP, 200, 2, 64, 49, [200, 131]),  # S not a multiple of the tile
    (fa.RelGeometry(3, 4, 1), 128, 2, 64, 33, [128, 100]),  # part ids in vocabulary
    (fa.RelGeometry(12), 384, 2, 64, 25, [384, 200]),  # 1D ids only
    (None, 256, 2, 64, 1, [256, 65]),  # no relative bias
], ids=["flagship", "head_dim_32", "ragged_s", "parts_in_vocab", "1d", "no_rel"])
def test_kernel_matches_plain(cuda, geo, S, H, D, V, lengths):
    q, k, v, table, lens = _inputs(cuda, len(lengths), S, H, D, V, lengths)
    before = fa.relative_attention_forward.launches
    o, lse = fa.relative_attention_forward(q, k, v, table, geo, lens)
    torch.cuda.synchronize()
    assert fa.relative_attention_forward.launches == before + 1
    o_ref, lse_ref = fa.relative_attention_plain(q, k, v, table, geo, lens)
    for b, n in enumerate(lengths):
        assert (o[b, :n].float() - o_ref[b, :n].float()).abs().max().item() < O_BOUND
        assert (lse[b, :, :n] - lse_ref[b, :, :n]).abs().max().item() < LSE_BOUND
        first_pad_tile = -(-n // 64) * 64  # query tiles past the length
        assert torch.all(o[b, first_pad_tile:] == 0)
        assert torch.all(lse[b, :, first_pad_tile:] == float("-inf"))


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, table, lens = _inputs(cuda, 1, 128, 2, 64, 49, [128])
    with pytest.raises(TypeError):
        fa.relative_attention_forward(q.float(), k.float(), v.float(), table, FLAGSHIP, lens)
    with pytest.raises(ValueError):
        fa.relative_attention_forward(q, k, v, table.repeat(2, 1, 1), FLAGSHIP, lens)
    q16 = q[..., :16].contiguous()
    with pytest.raises(ValueError):
        fa.relative_attention_forward(q16, q16, q16, table[..., :16], FLAGSHIP, lens)
