"""The port's masked grouped GEMM (the kernel's plain version on the CPU),
bf16 and scaled fp8, against the JAX package's m_grouped masked ops (the
Pallas kernel in interpret mode) on the same numpy inputs, valid rows only."""

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import deepgemm_tpu as dg
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.kernels import grouped
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.kernels.common import promote_block
from deepgemm_tpu_torch.ops.sf_layout import transform_sfb
from deepgemm_tpu_torch.testing import calc_diff

G, MAX_M, N, K = 2, 32, 128, 256
MASKED_M = np.array([20, 32], np.int32)      # group 0 partial, group 1 full


def _t(x):
    return tensor_from_numpy(np.asarray(x), 'cpu')


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    a = jnp.asarray(rng.randn(G, MAX_M, K).astype(ml_dtypes.bfloat16))
    b = jnp.asarray(rng.randn(G, N, K).astype(ml_dtypes.bfloat16))
    return a, b


def _valid_rows(d):
    d = d.float().numpy() if isinstance(d, torch.Tensor) else np.asarray(d, np.float32)
    return np.concatenate([d[g, :MASKED_M[g]] for g in range(G)])


def test_masked_bf16_matches_jax():
    a, b = _inputs()
    d_jax = dg.m_grouped_bf16_gemm_nt_masked(a, b, masked_m=jnp.asarray(MASKED_M))
    grouped.launches.update(bf16=0, fp8=0)
    d_port = dgt.m_grouped_bf16_gemm_nt_masked(_t(a), _t(b), masked_m=_t(MASKED_M))
    assert grouped.launches == {'bf16': 0, 'fp8': 0}   # CPU: the plain version
    assert d_port.dtype == torch.bfloat16 and tuple(d_port.shape) == (G, MAX_M, N)
    assert calc_diff(_valid_rows(d_port), _valid_rows(d_jax)) < 1e-5


def test_masked_fp8_matches_jax():
    a, b = _inputs(seed=1)
    aq, asf = dg.per_token_cast_to_fp8(a.reshape(-1, K), use_ue8m0=False)
    aq, asf = aq.reshape(G, MAX_M, K), asf.reshape(G, MAX_M, -1)
    bq, bsf = jax.vmap(lambda w: dg.per_block_cast_to_fp8(w, use_ue8m0=False))(b)
    d_jax = dg.m_grouped_fp8_gemm_nt_masked((aq, asf), (bq, bsf),
                                            masked_m=jnp.asarray(MASKED_M))
    d_port = dgt.m_grouped_fp8_gemm_nt_masked((_t(aq), _t(asf)), (_t(bq), _t(bsf)),
                                              masked_m=_t(MASKED_M))
    assert calc_diff(_valid_rows(d_port), _valid_rows(d_jax)) < 1e-5
    ref = np.einsum('gmk,gnk->gmn', np.asarray(a, np.float64), np.asarray(b, np.float64))
    assert calc_diff(_valid_rows(d_port), _valid_rows(ref)) < 1e-3


def test_grouped_sfb_layout_is_the_block_scales():
    sfb = torch.arange(G * 2 * 3, dtype=torch.float32).reshape(G, 3, 2).transpose(1, 2)
    out = transform_sfb(sfb, 200, 300, (128, 128), num_groups=G)
    assert out.is_contiguous() and torch.equal(out, sfb)
    with pytest.raises(AssertionError):
        transform_sfb(sfb, 300, 300, (128, 128), num_groups=G)


@pytest.mark.parametrize('gran_n', [1, 128])
def test_promote_reads_one_scale_per_gran_n_rows(gran_n):
    """promote_block against the same sum with SFB expanded to one scale per
    row of B by hand, at n = 200 (a partial last block)."""
    rng = np.random.RandomState(2)
    n, k = 200, 256
    a = torch.from_numpy(rng.randn(G, 8, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(G, n, k).astype(np.float32))
    sfa = torch.from_numpy(rng.rand(G, 8, 2).astype(np.float32))
    sfb = torch.from_numpy(rng.rand(G, -(-n // gran_n), 2).astype(np.float32))
    per_row = sfb.repeat_interleave(gran_n, dim=1)[:, :n]            # [G, n, ksf]
    want = sum((a[..., s * 128:(s + 1) * 128] @ b[..., s * 128:(s + 1) * 128].transpose(1, 2)
                * per_row[None, :, :, s].transpose(0, 1)) * sfa[..., s:s + 1]
               for s in range(2))
    assert torch.equal(promote_block(a, b, sfa, sfb, gran_n), want)


def test_masked_rejects_mixed_operands():
    a, b = _inputs()
    with pytest.raises(ValueError):
        grouped.masked_gemm(_t(a), _t(b), _t(MASKED_M).to('meta'))
