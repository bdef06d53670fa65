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
from deepgemm_tpu_torch.ops import m_grouped as m_grouped_ops
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
    grouped.launches.update(bf16=0, fp8=0, fp8_f32=0)
    d_port = dgt.m_grouped_bf16_gemm_nt_masked(_t(a), _t(b), masked_m=_t(MASKED_M))
    assert grouped.launches == {'bf16': 0, 'fp8': 0, 'fp8_f32': 0}   # CPU: the plain version
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


@pytest.mark.parametrize('fp8', [False, True])
def test_masked_at_17_rows_and_a_k_tail_matches_jax(fp8):
    """max_m 17 (not a multiple of 4: the kernel's k-first scale rows pad it
    to 20) and k 320 (the last 128-deep block half full), n 136 (not a
    multiple of 128), masked_m holding 0, a partial count and max_m."""
    rng = np.random.RandomState(7)
    g, max_m, n, k = 3, 17, 136, 320
    masked_m = np.array([0, 9, 17], np.int32)
    a = jnp.asarray(rng.randn(g, max_m, k).astype(ml_dtypes.bfloat16))
    b = jnp.asarray(rng.randn(g, n, k).astype(ml_dtypes.bfloat16))
    if fp8:
        aq, asf = dg.per_token_cast_to_fp8(a.reshape(-1, k), use_ue8m0=False)
        aq, asf = aq.reshape(g, max_m, k), asf.reshape(g, max_m, -1)
        bq, bsf = jax.vmap(lambda w: dg.per_block_cast_to_fp8(w, use_ue8m0=False))(b)
        d_jax = dg.m_grouped_fp8_gemm_nt_masked((aq, asf), (bq, bsf),
                                                masked_m=jnp.asarray(masked_m))
        d_port = dgt.m_grouped_fp8_gemm_nt_masked((_t(aq), _t(asf)), (_t(bq), _t(bsf)),
                                                  masked_m=_t(masked_m))
    else:
        d_jax = dg.m_grouped_bf16_gemm_nt_masked(a, b, masked_m=jnp.asarray(masked_m))
        d_port = dgt.m_grouped_bf16_gemm_nt_masked(_t(a), _t(b), masked_m=_t(masked_m))
    assert tuple(d_port.shape) == (g, max_m, n)
    rows = lambda d: np.concatenate([np.asarray(d, np.float32)[i, :masked_m[i]]
                                     for i in range(g)])
    assert calc_diff(rows(d_port.float().numpy()), rows(d_jax)) < 1e-5


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


@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_tile_gids_at_128_rows_match_jax(use_psum_layout):
    """The kernel's 128-row tiles at the default mk alignment: each tile's
    group and end row as JAX's compute_tile_gids gives them, on a layout of
    four groups (70, 0, 200 and 130 live rows) with an empty one."""
    from deepgemm_tpu.kernels import grouped as jax_grouped
    rows = (70, 0, 200, 130)
    ids = np.full(sum(-(-r // 128) * 128 for r in rows), -1, np.int32)
    ends, start = [], 0
    for g, r in enumerate(rows):
        ids[start:start + r] = g
        ends.append(start + r)
        start += -(-r // 128) * 128
    layout = np.asarray(ends, np.int32) if use_psum_layout else ids
    gids, row_ends = grouped.compute_tile_gids(_t(layout), len(rows), len(ids), 128,
                                               use_psum_layout)
    j_gids, j_ends = jax_grouped.compute_tile_gids(jnp.asarray(layout), len(rows), len(ids),
                                                   128, use_psum_layout)
    assert gids.tolist() == np.asarray(j_gids).tolist() == [0, 2, 2, 3, 3]
    assert row_ends.tolist() == np.asarray(j_ends).tolist() == [70, 328, 328, 514, 514]


# The JAX suite's dual-B layout (tests/test_gemm_grouped.py, the dual-B test):
# groups of 128, 384 and 256 rows start at rows 0, 128 and 512, so the first
# 256-row tile straddles groups 0 and 1 at its half line.
DUAL_SIZES = (128, 384, 256)


def _dual_inputs(n, k, seed=31):
    rng = np.random.RandomState(seed)
    m = sum(DUAL_SIZES)
    ids = np.repeat(np.arange(len(DUAL_SIZES), dtype=np.int32), DUAL_SIZES)
    a = jnp.asarray(rng.randn(m, k), jnp.bfloat16)
    b = jnp.asarray(rng.randn(len(DUAL_SIZES), n, k) * 0.1, jnp.bfloat16)
    return a, b, ids


@pytest.mark.parametrize('use_fp8', [False, True])
@pytest.mark.parametrize('n,k', [(256, 384), (256, 200)])
def test_contiguous_dual_b_matches_jax_dual_b(monkeypatch, use_fp8, n, k):
    """DGT_GROUPED_DUAL_B=1 pins the dual-B form in both packages (the same
    variable); a k tail at k = 200."""
    monkeypatch.setenv('DGT_GROUPED_DUAL_B', '1')
    a, b, ids = _dual_inputs(n, k)
    if use_fp8:
        a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=False)
        b_q = jax.vmap(lambda w: dg.per_block_cast_to_fp8(w, use_ue8m0=False))(b)
        d_jax = dg.m_grouped_fp8_gemm_nt_contiguous(a_q, b_q, grouped_layout=jnp.asarray(ids))
        to_t = lambda pair: tuple(_t(v) for v in pair)
        call = lambda: dgt.m_grouped_fp8_gemm_nt_contiguous(to_t(a_q), to_t(b_q),
                                                            grouped_layout=_t(ids))
    else:
        d_jax = dg.m_grouped_bf16_gemm_nt_contiguous(a, b, grouped_layout=jnp.asarray(ids))
        call = lambda: dgt.m_grouped_bf16_gemm_nt_contiguous(_t(a), _t(b), grouped_layout=_t(ids))
    chosen = []
    monkeypatch.setattr(m_grouped_ops, 'contiguous_dual_gemm',
                        lambda *args, **kw: chosen.append(1) or grouped.contiguous_dual_gemm(
                            *args, **kw))
    d_port = call()
    assert chosen == [1] and grouped.dual_b_launches == {'bf16': 0, 'fp8': 0}
    assert calc_diff(d_port, np.asarray(d_jax, np.float32)) < 1e-5
    ref = np.concatenate([np.asarray(a, np.float64)[ids == g] @ np.asarray(b, np.float64)[g].T
                          for g in range(len(DUAL_SIZES))])
    assert calc_diff(d_port, ref) < (1e-3 if use_fp8 else 1e-5)


def test_dual_b_form_only_where_its_shapes_allow(monkeypatch):
    """Under DGT_GROUPED_DUAL_B=1 the op keeps the 64-row form for m % 256
    != 0 and for ensure_zero_padding, and without the variable; it never
    reads the layout."""
    a, b, ids = _dual_inputs(128, 128)
    chosen = []
    monkeypatch.setattr(m_grouped_ops, 'contiguous_dual_gemm',
                        lambda *args, **kw: chosen.append(1) or grouped.contiguous_dual_gemm(
                            *args, **kw))
    run = lambda a_, ids_, **kw: dgt.m_grouped_bf16_gemm_nt_contiguous(
        _t(a_), _t(b), grouped_layout=_t(ids_), **kw)
    run(a, ids)
    monkeypatch.setenv('DGT_GROUPED_DUAL_B', '1')
    run(a[:640], ids[:640])
    run(a, ids, ensure_zero_padding=True)
    assert chosen == []
    monkeypatch.setenv('DGT_GROUPED_DUAL_B', '0')
    run(a, ids)
    assert chosen == []


@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_dual_tile_gids_pair_the_halves(use_psum_layout):
    """The pairs are the groups of each 256-row tile's two 128-row halves:
    the 64-row tiles' groups, every other one, paired."""
    ends = np.cumsum(DUAL_SIZES).astype(np.int32)
    _, _, ids = _dual_inputs(128, 128)
    layout = _t(ends if use_psum_layout else ids)
    pairs = grouped.compute_dual_tile_gids(layout, 3, 768, use_psum_layout)
    assert pairs.tolist() == [[0, 1], [1, 1], [2, 2]]
    gids64, _ = grouped.compute_tile_gids(layout, 3, 768, 64, use_psum_layout)
    assert torch.equal(pairs.view(-1), gids64[::2])
    with pytest.raises(ValueError, match='m % 256'):
        grouped.compute_dual_tile_gids(layout, 3, 640, use_psum_layout)


@pytest.mark.parametrize('layout', ['masked', 'contiguous'])
@pytest.mark.parametrize('packed', ['a', 'b'])
def test_m_grouped_refuse_packed_fp4(layout, packed):
    """JAX's m-grouped ops compute on the raw e2m1 codes of an int8 operand
    (no fold), so its answer is undefined there: the port raises."""
    rng = np.random.RandomState(9)
    k = 256
    codes = lambda *shape: torch.from_numpy(rng.randint(-128, 128, (*shape, k // 2)).astype(np.int8))
    fp8 = lambda *shape: torch.from_numpy(rng.randn(*shape, k).astype(np.float32)).to(
        torch.float8_e4m3fn)
    lead = (G, MAX_M) if layout == 'masked' else (256,)
    a = (codes(*lead) if packed == 'a' else fp8(*lead), torch.ones(*lead, 2))
    b = (codes(G, N) if packed == 'b' else fp8(G, N), torch.ones(G, 1, 2))
    with pytest.raises(TypeError, match='undefined'):
        if layout == 'masked':
            dgt.m_grouped_fp8_fp4_gemm_nt_masked(a, b, masked_m=_t(MASKED_M),
                                                 recipe_a=(1, 128), recipe_b=(1, 128))
        else:
            dgt.m_grouped_fp8_fp4_gemm_nt_contiguous(
                a, b, grouped_layout=torch.zeros(256, dtype=torch.int32),
                recipe_a=(1, 128), recipe_b=(1, 128))
