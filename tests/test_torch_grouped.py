"""The port's masked and contiguous grouped GEMMs (the kernels' plain
versions on the CPU), bf16 and scaled fp8, against the JAX package's
m_grouped ops (the Pallas kernels in interpret mode) on the same numpy
inputs."""

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


# Contiguous layout: three uneven groups (70, 200 and 130 live rows), each
# padded to the 128-row alignment, with NONZERO padding rows, so the zero
# padding epilogue has something to blank.
C_ROWS = (70, 200, 130)
C_N, C_K = 128, 256


def _contiguous_inputs(use_psum_layout, seed=3):
    rng = np.random.RandomState(seed)
    aligned = [-(-r // 128) * 128 for r in C_ROWS]
    m = sum(aligned)
    a = rng.randn(m, C_K).astype(ml_dtypes.bfloat16)
    b = rng.randn(len(C_ROWS), C_N, C_K).astype(ml_dtypes.bfloat16)
    ids = np.full(m, -1, np.int32)
    ends, start = [], 0
    for g, (rows, span) in enumerate(zip(C_ROWS, aligned)):
        ids[start:start + rows] = g
        ends.append(start + rows)
        start += span
    layout = np.asarray(ends, np.int32) if use_psum_layout else ids
    return jnp.asarray(a), jnp.asarray(b), layout, ids >= 0


@pytest.mark.parametrize('use_fp8,use_psum_layout,ensure_zero_padding', [
    (True, False, True), (True, True, True), (False, False, False), (False, True, True)])
def test_contiguous_matches_jax(use_fp8, use_psum_layout, ensure_zero_padding):
    a, b, layout, live = _contiguous_inputs(use_psum_layout)
    kw = dict(use_psum_layout=use_psum_layout, ensure_zero_padding=ensure_zero_padding)
    if use_fp8:
        aq = dg.per_token_cast_to_fp8(a, use_ue8m0=False)
        bq = jax.vmap(lambda w: dg.per_block_cast_to_fp8(w, use_ue8m0=False))(b)
        d_jax = dg.m_grouped_fp8_gemm_nt_contiguous(aq, bq, grouped_layout=jnp.asarray(layout), **kw)
        to_t = lambda pair: tuple(_t(v) for v in pair)
        d_port = dgt.m_grouped_fp8_gemm_nt_contiguous(to_t(aq), to_t(bq),
                                                      grouped_layout=_t(layout), **kw)
    else:
        d_jax = dg.m_grouped_bf16_gemm_nt_contiguous(a, b, grouped_layout=jnp.asarray(layout), **kw)
        d_port = dgt.m_grouped_bf16_gemm_nt_contiguous(_t(a), _t(b), grouped_layout=_t(layout), **kw)
    assert grouped.contiguous_launches == {'bf16': 0, 'fp8': 0}   # CPU: the plain version
    assert d_port.dtype == torch.bfloat16 and tuple(d_port.shape) == (len(live), C_N)
    d_jax = np.asarray(d_jax, np.float32)
    rows = slice(None) if ensure_zero_padding else live
    assert calc_diff(d_port.float().numpy()[rows], d_jax[rows]) < 1e-5
    if ensure_zero_padding:
        assert not d_port[torch.from_numpy(~live)].float().any()
    ref = np.zeros_like(d_jax)
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    for g, idx in enumerate(np.split(np.flatnonzero(live), np.cumsum(C_ROWS)[:-1])):
        ref[idx] = a64[idx] @ b64[g].T
    assert calc_diff(d_port.float().numpy()[live], ref[live]) < (1e-3 if use_fp8 else 1e-5)


@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_tile_gids_follow_the_layout(use_psum_layout):
    """64-row tiles of the 128-aligned layout above: 2 tiles of group 0
    (the second all padding), 4 of group 1, 4 of group 2; each tile's end
    row is its group's last live row + 1."""
    _, _, layout, _ = _contiguous_inputs(use_psum_layout)
    gids, row_ends = grouped.compute_tile_gids(_t(layout), 3, 640, 64, use_psum_layout)
    assert gids.tolist() == [0, 0, 1, 1, 1, 1, 2, 2, 2, 2]
    assert row_ends.tolist() == [70] * 2 + [328] * 4 + [514] * 4
