"""The port's einsum family, HyperConnection prenorm GEMM and skip-head-mid
GEMM (the kernels' plain versions on the CPU) against the JAX package's
(deepgemm_tpu/ops/{einsum,hyperconnection,gemm}.py; the HC prenorm's Pallas
kernel in interpret mode) on the same seeded numpy inputs, at the JAX suite's
own tolerances (tests/test_einsum_hc.py)."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import deepgemm_tpu as dg
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.kernels import grouped, hc_prenorm
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.testing import calc_diff


def _t(x):
    return tensor_from_numpy(np.asarray(x), 'cpu')


def _bf16(rng, *shape):
    return rng.randn(*shape).astype(ml_dtypes.bfloat16)


# k = 1024 is two of the JAX kernel's 512-deep blocks (its accumulator branch)
@pytest.mark.parametrize('num_splits', [None, 4])
def test_tf32_hc_prenorm_gemm_matches_jax(num_splits):
    rng = np.random.RandomState(0)
    m, n, k = 128, 24, 1024
    a, b = _bf16(rng, m, k), rng.randn(n, k).astype(np.float32)
    d_jax, s_jax = dg.tf32_hc_prenorm_gemm(jnp.asarray(a), jnp.asarray(b), num_splits=num_splits)
    hc_prenorm.launches = 0
    d, s = dgt.tf32_hc_prenorm_gemm(_t(a), _t(b), num_splits=num_splits)
    assert hc_prenorm.launches == 0                 # CPU tensors: the plain version
    assert tuple(d.shape) == d_jax.shape and tuple(s.shape) == s_jax.shape
    assert d.dtype == s.dtype == torch.float32
    assert calc_diff(d, d_jax) < 1e-5 and calc_diff(s, s_jax) < 1e-6
    ref_d = np.asarray(a, np.float64) @ np.asarray(b, np.float64).T
    ref_s = (np.asarray(a, np.float64) ** 2).sum(-1)
    total_d, total_s = (d.sum(0), s.sum(0)) if num_splits else (d, s)
    assert calc_diff(total_d, ref_d) < 1e-5 and calc_diff(total_s, ref_s) < 1e-6


def test_hc_prenorm_split_partials_cover_their_chunks():
    """k = 200 in 3 splits: chunks of 67, 67 and 66 (a short last one), each
    partial exactly its chunk's product and square sum."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(5, 200).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(6, 200).astype(np.float32))
    d, s = dgt.tf32_hc_prenorm_gemm(a, b, num_splits=3)
    for i, (lo, hi) in enumerate(((0, 67), (67, 134), (134, 200))):
        af = a[:, lo:hi].double()
        assert calc_diff(d[i], af @ b[:, lo:hi].double().t()) < 1e-12
        assert calc_diff(s[i], (af * af).sum(-1)) < 1e-12


@pytest.mark.parametrize('num_splits', [None, 2])
def test_tf32_hc_prenorm_gemm_m_zero(num_splits):
    a, b = torch.zeros(0, 64, dtype=torch.bfloat16), torch.zeros(24, 64)
    d, s = dgt.tf32_hc_prenorm_gemm(a, b, num_splits=num_splits)
    d_jax, s_jax = dg.tf32_hc_prenorm_gemm(jnp.zeros((0, 64), jnp.bfloat16),
                                           jnp.zeros((24, 64), jnp.float32),
                                           num_splits=num_splits)
    assert tuple(d.shape) == d_jax.shape and tuple(s.shape) == s_jax.shape


def test_einsum_bmk_bnk_mn_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _bf16(rng, 4, 64, 128), _bf16(rng, 4, 96, 128)
    c = rng.randn(64, 96).astype(np.float32)
    out = dgt.einsum('bmk,bnk->mn', _t(a), _t(b), d=torch.bfloat16)
    out_jax = dg.einsum('bmk,bnk->mn', jnp.asarray(a), jnp.asarray(b),
                        d=jnp.zeros((), jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and calc_diff(out, out_jax) < 1e-5
    # f32 out accumulates into c
    out = dgt.einsum('bmk,bnk->mn', _t(a), _t(b), d=_t(c), c=_t(c))
    out_jax = dg.einsum('bmk,bnk->mn', jnp.asarray(a), jnp.asarray(b), d=jnp.asarray(c),
                        c=jnp.asarray(c))
    assert out.dtype == torch.float32 and calc_diff(out, out_jax) < 1e-6
    with pytest.raises(AssertionError):
        dgt.einsum('bmk,bnk->mn', _t(a), _t(b), d=torch.float32)
    with pytest.raises(ValueError):
        dgt.einsum('bmk,bkn->mn', _t(a), _t(b))


@pytest.mark.parametrize('expr', ['bhr,hdr->bhd', 'bhd,hdr->bhr'])
def test_einsum_head_projections_match_jax(expr):
    rng = np.random.RandomState(3)
    b_, h, r, d_dim = 8, 4, 64, 32
    a = _bf16(rng, b_, h, r) if expr == 'bhr,hdr->bhd' else _bf16(rng, b_, h, d_dim)
    w = _bf16(rng, h, d_dim, r)
    out = dgt.einsum(expr, _t(a), _t(w))
    out_jax = dg.einsum(expr, jnp.asarray(a), jnp.asarray(w))
    assert out.dtype == torch.bfloat16 and calc_diff(out, out_jax) < 1e-5
    with pytest.raises(AssertionError):
        dgt.einsum(expr, _t(a), _t(w), c=torch.zeros(1))


def _bmm_inputs(rng, batch, m, n, k):
    a, b = _bf16(rng, batch, m, k), _bf16(rng, batch, n, k)
    a_q = [dg.per_token_cast_to_fp8(jnp.asarray(a[i]), use_ue8m0=False) for i in range(batch)]
    b_q = [dg.per_block_cast_to_fp8(jnp.asarray(b[i]), use_ue8m0=False) for i in range(batch)]
    return tuple(np.stack([np.asarray(q[j]) for q in qs]) for qs in (a_q, b_q) for j in (0, 1))


@pytest.mark.parametrize('with_c', [False, True])
def test_fp8_bmm_matches_jax(with_c):
    rng = np.random.RandomState(4)
    batch, m, n, k = 3, 64, 128, 320              # a k tail: the last block is half full
    av, asf, bv, bsf = _bmm_inputs(rng, batch, m, n, k)
    c = rng.randn(batch, m, n).astype(np.float32) if with_c else None
    out_jax = dg.fp8_bmm(jnp.asarray(av), jnp.asarray(asf), jnp.asarray(bv), jnp.asarray(bsf),
                         c=None if c is None else jnp.asarray(c))
    grouped.launches['fp8_f32'] = 0
    out = dgt.fp8_bmm(_t(av), _t(asf), _t(bv), _t(bsf), c=None if c is None else _t(c))
    assert grouped.launches['fp8_f32'] == 0
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == out_jax.shape
    assert calc_diff(out, out_jax) < 1e-5


def test_fp8_bmm_per_channel_recipe_matches_jax():
    """Recipe (1, 1, 128): B scaled per row (the masked kernel's gran_n 1
    form), at a k tail and n 136, beside JAX's."""
    rng = np.random.RandomState(6)
    batch, m, n, k = 2, 40, 136, 320
    a, b = _bf16(rng, batch, m, k), _bf16(rng, batch, n, k)
    cast = lambda x: dg.per_token_cast_to_fp8(jnp.asarray(x), use_ue8m0=False)
    av, asf = (np.stack([np.asarray(cast(a[i])[j]) for i in range(batch)]) for j in (0, 1))
    bv, bsf = (np.stack([np.asarray(cast(b[i])[j]) for i in range(batch)]) for j in (0, 1))
    out_jax = dg.fp8_bmm(jnp.asarray(av), jnp.asarray(asf), jnp.asarray(bv), jnp.asarray(bsf),
                         recipe=(1, 1, 128))
    out = dgt.fp8_bmm(_t(av), _t(asf), _t(bv), _t(bsf), recipe=(1, 1, 128))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == out_jax.shape
    assert calc_diff(out, out_jax) < 1e-5


def test_fp8_bmm_f32_out_and_packed_scales_match_jax():
    """An f32 ``d`` with ``c`` (the masked kernel's f32 instance), and A's
    scales as packed UE8M0 int32, which both ops unpack."""
    rng = np.random.RandomState(5)
    batch, m, n, k = 2, 32, 128, 512              # 4 scales a row: one packed int32
    a, b = _bf16(rng, batch, m, k), _bf16(rng, batch, n, k)
    a_q = [dg.per_token_cast_to_fp8(jnp.asarray(a[i]), use_ue8m0=True, use_packed_ue8m0=True)
           for i in range(batch)]
    b_q = [dg.per_block_cast_to_fp8(jnp.asarray(b[i]), use_ue8m0=True) for i in range(batch)]
    av, asf = (np.stack([np.asarray(q[j]) for q in a_q]) for j in (0, 1))
    bv, bsf = (np.stack([np.asarray(q[j]) for q in b_q]) for j in (0, 1))
    assert asf.dtype == np.int32
    c = rng.randn(batch, m, n).astype(np.float32)
    out_jax = dg.fp8_bmm(jnp.asarray(av), jnp.asarray(asf), jnp.asarray(bv), jnp.asarray(bsf),
                         d=jnp.zeros((), jnp.float32), c=jnp.asarray(c))
    out = dgt.fp8_bmm(_t(av), _t(asf), _t(bv), _t(bsf), d=torch.float32, c=_t(c))
    assert out.dtype == torch.float32 and out_jax.dtype == jnp.float32
    assert calc_diff(out, out_jax) < 1e-6


def _einsum_operands(expr, rng):
    """Seeded bf16 operands of ``expr`` and their casts, with scales of the
    shapes JAX's fp8_einsum takes for it (per token along the contracted
    dim for a, 128 x 128 blocks for b)."""
    bt, h, d_dim, r = 256, 2, 128, 256
    cast_rows = lambda x: dg.per_token_cast_to_fp8(jnp.asarray(x), use_ue8m0=False)
    cast_blocks = lambda x: dg.per_block_cast_to_fp8(jnp.asarray(x), use_ue8m0=False)
    stack = lambda qs, axis: tuple(np.stack([np.asarray(q[j]) for q in qs], axis) for j in (0, 1))
    if expr == 'bhr,hdr->bhd':
        a, b = _bf16(rng, bt, h, r), _bf16(rng, h, d_dim, r)
        a_q = stack([cast_rows(a[:, i]) for i in range(h)], 1)      # [b, h, r], [b, h, r/128]
        b_q = stack([cast_blocks(b[i]) for i in range(h)], 0)       # [h, d, r], [h, d/128, r/128]
    elif expr == 'bhd,hdr->bhr':
        a, b = _bf16(rng, bt, h, d_dim), _bf16(rng, h, d_dim, r)
        a_q = stack([cast_rows(a[:, i]) for i in range(h)], 1)      # [b, h, d], [b, h, d/128]
        b_q = stack([cast_blocks(b[i]) for i in range(h)], 0)       # [h, d, r], [h, d/128, r/128]
    else:
        a, b = _bf16(rng, bt, h, d_dim), _bf16(rng, bt, h, r)
        aq, asf = dg.per_channel_cast_to_fp8(jnp.asarray(a.reshape(bt, h * d_dim)),
                                             use_ue8m0=False)
        a_q = (np.asarray(aq).reshape(bt, h, d_dim), np.asarray(asf).reshape(-1, h, d_dim))
        b_q = stack([cast_blocks(b[:, i]) for i in range(h)], 1)    # [b, h, r], [b/128, h, r/128]
    ref = np.einsum(expr, np.asarray(a, np.float64), np.asarray(b, np.float64))
    return a_q, b_q, ref


@pytest.mark.parametrize('expr', ['bhr,hdr->bhd', 'bhd,hdr->bhr', 'bhd,bhr->hdr'])
def test_fp8_einsum_matches_jax(expr):
    a_q, b_q, ref = _einsum_operands(expr, np.random.RandomState(6))
    out_jax = dg.fp8_einsum(expr, tuple(map(jnp.asarray, a_q)), tuple(map(jnp.asarray, b_q)))
    out = dgt.fp8_einsum(expr, tuple(map(_t, a_q)), tuple(map(_t, b_q)))
    assert tuple(out.shape) == out_jax.shape == ref.shape
    assert calc_diff(out, out_jax) < 1e-5
    assert calc_diff(out, ref) < 1e-3               # fp8 quantization error only


def test_fp8_einsum_with_c_matches_jax():
    expr = 'bhr,hdr->bhd'
    rng = np.random.RandomState(7)
    a_q, b_q, ref = _einsum_operands(expr, rng)
    c = rng.randn(*ref.shape).astype(np.float32)
    out_jax = dg.fp8_einsum(expr, tuple(map(jnp.asarray, a_q)), tuple(map(jnp.asarray, b_q)),
                            c=jnp.asarray(c))
    out = dgt.fp8_einsum(expr, tuple(map(_t, a_q)), tuple(map(_t, b_q)), c=_t(c))
    assert calc_diff(out, out_jax) < 1e-5
    with pytest.raises(ValueError):
        dgt.fp8_einsum('bhd,hrd->bhr', tuple(map(_t, a_q)), tuple(map(_t, b_q)))


def test_fp8_gemm_nt_skip_head_mid_matches_jax():
    rng = np.random.RandomState(8)
    m, k, heads, (left, mid, right) = 64, 256, 4, (32, 16, 32)
    n = heads * (left + right)
    a, b = jnp.asarray(_bf16(rng, m, k)), jnp.asarray(_bf16(rng, n, k))
    a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=False)
    b_q = dg.per_block_cast_to_fp8(b, use_ue8m0=False)
    out_jax = dg.fp8_gemm_nt_skip_head_mid(a_q, b_q, head_splits=(left, mid, right))
    out = dgt.fp8_gemm_nt_skip_head_mid(tuple(map(_t, a_q)), tuple(map(_t, b_q)),
                                        head_splits=(left, mid, right))
    assert tuple(out.shape) == out_jax.shape == (m, heads * (left + mid + right))
    heads_out = out.view(m, heads, -1)
    assert not heads_out[:, :, left:left + mid].float().any()      # mid exactly zero
    narrow = dgt.fp8_gemm_nt(tuple(map(_t, a_q)), tuple(map(_t, b_q))).view(m, heads, -1)
    assert torch.equal(heads_out[:, :, :left], narrow[:, :, :left])
    assert torch.equal(heads_out[:, :, left + mid:], narrow[:, :, left:])
    assert calc_diff(out, out_jax) < 1e-5
    with pytest.raises(AssertionError):
        dgt.fp8_gemm_nt_skip_head_mid(tuple(map(_t, a_q)), tuple(map(_t, b_q)),
                                      head_splits=(48, 16, 48))


def test_testing_helpers():
    """The JAX package's testing names: no card here, so arch 0 and no SMs;
    count_bytes over nested tensors; test_filter on DGT_TEST_FILTER."""
    from deepgemm_tpu_torch import testing
    assert testing.get_arch_major() == 0 and testing.get_device_core_count() == 0
    assert testing.count_bytes(torch.zeros(3), (None, [torch.zeros(2, dtype=torch.bfloat16)])) == 16
    seen = []
    wrapped = testing.test_filter(lambda: seen.append(1) or 'ran')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DGT_TEST_FILTER', 'no_such_name')
        assert wrapped() is None and not seen
        mp.delenv('DGT_TEST_FILTER')
        assert wrapped() == 'ran' and seen == [1]
    with pytest.raises(RuntimeError, match='none is present'):
        testing.bench_profiled(lambda: None, 'x')
