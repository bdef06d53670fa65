"""The port's k-grouped GEMM (the kernel's plain version on the CPU), bf16 and
fp8 with per-channel scales, against the JAX package's k-grouped ops (the
Pallas kernel in interpret mode) on the same numpy inputs; and the k-major
relayout that feeds the CUDA kernel, against a numpy reference."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import deepgemm_tpu as dg
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.kernels import k_grouped
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.testing import calc_diff

from generators import generate_k_grouped_contiguous

M, N = 128, 256


def _t(x):
    return tensor_from_numpy(np.asarray(x), 'cpu')


def _pair(p):
    return tuple(_t(v) for v in p)


@pytest.mark.parametrize('ks,with_c', [
    ([256, 384, 128], True),        # uneven groups, accumulate into c
    ([128, 0, 256], False),         # an empty group, no c: it comes out zero
    ([256, 256], False),            # equal groups
])
def test_k_grouped_fp8_matches_jax(ks, with_c):
    _, a, b, c, _, ks_arr = generate_k_grouped_contiguous(len(ks), M, N, ks, use_fp8=True)
    c = c if with_c else None
    d_jax = np.asarray(dg.k_grouped_fp8_gemm_tn_contiguous(a, b, ks=ks, grouped_layout=ks_arr, c=c))
    k_grouped.launches.update(bf16=0, fp8=0)
    d_port = dgt.k_grouped_fp8_gemm_tn_contiguous(
        _pair(a), _pair(b), ks=ks, grouped_layout=_t(ks_arr), c=None if c is None else _t(c))
    assert k_grouped.launches == {'bf16': 0, 'fp8': 0}     # CPU: the plain version
    assert d_port.dtype == torch.float32 and tuple(d_port.shape) == (len(ks), M, N)
    for g, kg in enumerate(ks):
        if kg == 0:
            assert not d_port[g].any() and not d_jax[g].any()
        else:
            assert calc_diff(d_port[g], d_jax[g]) < 1e-5, g
    # the bf16 output is the f32 sum rounded once
    d_bf16 = dgt.k_grouped_fp8_gemm_tn_contiguous(
        _pair(a), _pair(b), d=torch.bfloat16, ks=ks, grouped_layout=_t(ks_arr),
        c=None if c is None else _t(c))
    assert torch.equal(d_bf16, d_port.to(torch.bfloat16))


def test_k_grouped_bf16_psum_layout_matches_jax():
    """Groups of 200 and 300 rows at 128-row alignment: psum ends [200, 556],
    total_k 640. The port's gap rows hold nonzero values that no group
    reads."""
    rng = np.random.RandomState(3)
    ends, total_k = np.asarray([200, 556], np.int32), 640
    a = jnp.asarray(rng.randn(total_k, M), jnp.bfloat16)
    b = jnp.asarray(rng.randn(total_k, N), jnp.bfloat16)
    c = rng.randn(2, M, N).astype(np.float32) * 32
    gaps = np.ones((total_k, 1), bool)           # the JAX kernel needs zero gap rows
    gaps[200:256] = gaps[556:] = False
    d_jax = np.asarray(dg.k_grouped_bf16_gemm_tn_contiguous(
        jnp.where(gaps, a, 0), jnp.where(gaps, b, 0), grouped_layout=jnp.asarray(ends),
        c=jnp.asarray(c), use_psum_layout=True))
    d_port = dgt.k_grouped_bf16_gemm_tn_contiguous(
        _t(a), _t(b), grouped_layout=_t(ends), c=_t(c), use_psum_layout=True)
    for g in range(2):
        assert calc_diff(d_port[g], d_jax[g]) < 1e-5, g


def test_k_grouped_rejects_transposed_sf():
    ks = [128, 256]
    _, a, b, _, _, ks_arr = generate_k_grouped_contiguous(2, M, N, ks, use_fp8=True)
    a_t = (_t(a[0]), _t(a[1]).t().contiguous())
    with pytest.raises(AssertionError, match='k-first'):
        dgt.k_grouped_fp8_gemm_tn_contiguous(a_t, _pair(b), ks=ks, grouped_layout=_t(ks_arr))


@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_k_major_relayout(use_psum_layout):
    """The CUDA path's k-major copy: group g's rows land at a 16-aligned
    column, in order, with zeros everywhere else; rows outside every group
    are dropped."""
    sizes = [5, 0, 37, 16]
    rng = np.random.RandomState(4)
    if use_psum_layout:          # starts 0, 128, 128, 256 at the 128-row alignment
        starts, layout, total_k = [0, 128, 128, 256], [5, 128, 165, 272], 300
    else:
        starts, layout, total_k = [0, 5, 5, 42], sizes, sum(sizes)
    x = rng.randint(1, 100, (total_k, 3)).astype(np.int16)
    st, sz, sf = k_grouped.compute_k_group_metadata(torch.tensor(layout), use_psum_layout)
    assert st.tolist() == starts and sz.tolist() == sizes and sf.tolist() == [0, 1, 1, 2]
    km, pstarts, ldk = k_grouped._k_major(torch.from_numpy(x).view(torch.bfloat16), st, sz)
    assert pstarts.tolist() == [0, 16, 16, 64] and ldk == 16 * (-(-total_k // 16)) + 64
    want = np.zeros((3, ldk), np.int16)
    for g in range(4):
        want[:, pstarts[g]:pstarts[g] + sizes[g]] = x[starts[g]:starts[g] + sizes[g]].T
    assert np.array_equal(km.view(torch.int16).numpy(), want)


@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_k_major_relayout_for_the_fp8_kernel(use_psum_layout):
    """The FP8 kernel's k-major copy: group g's rows land at column 128 x
    sf_start[g] (its 128-deep blocks, counted by its scale rows, are the
    copy's width: 128 x nsf), in order, with zeros everywhere else; rows
    outside every group are dropped."""
    sizes = [5, 0, 137, 16]
    rng = np.random.RandomState(5)
    if use_psum_layout:          # starts 0, 128, 128, 384 at the 128-row alignment
        starts, layout, total_k = [0, 128, 128, 384], [5, 128, 265, 400], 420
    else:
        starts, layout, total_k = [0, 5, 5, 142], sizes, sum(sizes)
    x = torch.from_numpy(rng.randint(1, 100, (total_k, 48)).astype(np.uint8))
    x = x.view(torch.float8_e4m3fn)
    nsf = 1 + 0 + 2 + 1
    a_km, b_km, sz, sf0, ldk = k_grouped.tn_relayout(x, x, torch.tensor(layout), nsf,
                                                     use_psum_layout)
    assert ldk == 128 * nsf and sz.tolist() == sizes and sf0.tolist() == [0, 1, 1, 3]
    want = np.zeros((48, ldk), np.uint8)
    raw = x.view(torch.uint8).numpy()
    for g in range(4):
        col = 128 * sf0[g].item()
        want[:, col:col + sizes[g]] = raw[starts[g]:starts[g] + sizes[g]].T
    assert np.array_equal(a_km.view(torch.uint8).numpy(), want)
    assert torch.equal(a_km.view(torch.uint8), b_km.view(torch.uint8))
