"""The port's CUDA kernels against their plain versions on the card, at
small shapes. They have no CPU mode, so every test here skips without a
CUDA card. On a machine with one (and without JAX, which tests/conftest.py
imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from deepgemm_tpu_torch.kernels import dense, grouped
from deepgemm_tpu_torch.models import transformer as tt
from deepgemm_tpu_torch.testing import calc_diff
from deepgemm_tpu_torch.utils.math import per_block_cast_to_fp8, per_token_cast_to_fp8

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels have no CPU mode')
    return torch.Generator(device='cuda').manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)


@pytest.mark.parametrize('m,n,k', [(64, 256, 320), (130, 200, 7168), (1, 64, 128)])
def test_dense_kernel_matches_plain(gen, m, n, k):
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    bq, sfb = per_block_cast_to_fp8(_randn(gen, n, k), use_ue8m0=False)
    before = dense.launches
    d = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb)
    torch.cuda.synchronize()
    assert dense.launches == before + 1
    assert calc_diff(d, dense.dense_fp8_gemm_nt_plain(aq, bq, sfa, sfb)) < 1e-5


def test_dense_kernel_per_channel_scales(gen):
    m, n, k = 64, 192, 384
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    bq, sfb = per_token_cast_to_fp8(_randn(gen, n, k), use_ue8m0=False)   # [n, ksf]
    d = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb, gran_n=1)
    ref = dense.dense_fp8_gemm_nt_plain(aq, bq, sfa, sfb, gran_n=1)
    torch.cuda.synchronize()
    assert calc_diff(d, ref) < 1e-5


@pytest.mark.parametrize('fp8', [False, True])
def test_masked_kernel_matches_plain(gen, fp8):
    g, max_m, n, k = 3, 40, 256, 320
    a, b = _randn(gen, g, max_m, k), _randn(gen, g, n, k)
    masked_m = torch.tensor([0, 17, 40], dtype=torch.int32, device='cuda')
    kw = {}
    if fp8:
        a, sfa = per_token_cast_to_fp8(a.view(-1, k), use_ue8m0=False)
        a, sfa = a.view(g, max_m, k), sfa.view(g, max_m, -1)
        bq = [per_block_cast_to_fp8(b[i], use_ue8m0=False) for i in range(g)]
        b = torch.stack([q for q, _ in bq])
        sfb = torch.stack([s for _, s in bq])
        kw = dict(sfa=sfa, sfb=sfb)
    d = grouped.masked_gemm(a, b, masked_m, **kw)
    ref = grouped.masked_gemm_plain(a, b, masked_m, **kw)
    torch.cuda.synchronize()
    rows = torch.arange(max_m, device='cuda')[None, :] < masked_m[:, None]
    assert calc_diff(d[rows], ref[rows]) < 1e-5


def test_kernel_wrappers_reject_what_the_kernel_does_not_take(gen):
    a = _randn(gen, 16, 200)                       # k % 16 != 0
    aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
    bq, sfb = per_block_cast_to_fp8(_randn(gen, 64, 200), use_ue8m0=False)
    with pytest.raises(ValueError):
        dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb)
    with pytest.raises(TypeError):
        grouped.masked_gemm(aq[None], bq[None].to(torch.bfloat16),
                            torch.ones(1, dtype=torch.int32, device='cuda'))


@pytest.mark.parametrize('use_fp8', [False, True])
def test_one_layer_forward_kernel_matches_plain(gen, use_fp8):
    """One layer routes on identical inputs in both paths, so the logits
    must agree (with more layers an expert choice can flip at a near tie)."""
    base = dict(vocab=512, hidden=256, num_layers=1, num_heads=2, head_dim=64,
                num_experts=8, topk=2, moe_intermediate=256, capacity_factor=8.0,
                use_fp8=use_fp8)
    params = tt.init_params(tt.ModelConfig(**base), seed=0)
    tokens = torch.randint(0, 512, (2, 32), generator=gen, device='cuda')
    before = dict(grouped.launches)
    lk = tt.forward(params, tokens, tt.ModelConfig(**base, use_kernels=True))
    lp = tt.forward(params, tokens, tt.ModelConfig(**base, use_kernels=False))
    kind = 'fp8' if use_fp8 else 'bf16'
    assert grouped.launches[kind] == before[kind] + 2
    assert torch.isfinite(lk).all()
    assert calc_diff(lk, lp) < 1e-5
