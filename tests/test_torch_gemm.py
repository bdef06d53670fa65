"""The port's fp8_gemm_nt (the dense kernel's plain version on the CPU)
against the JAX package's fp8_gemm_nt (the Pallas kernel in interpret mode)
on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import deepgemm_tpu as dg
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.kernels import dense
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.testing import calc_diff


def _quantized_pair(m, n, k, seed=0):
    rng = np.random.RandomState(seed)
    a = jnp.asarray(rng.randn(m, k).astype(ml_dtypes.bfloat16))
    b = jnp.asarray(rng.randn(n, k).astype(ml_dtypes.bfloat16))
    a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=False)
    b_q = dg.per_block_cast_to_fp8(b, use_ue8m0=False)
    to_t = lambda pair: tuple(tensor_from_numpy(np.asarray(v), 'cpu') for v in pair)
    return a, b, a_q, b_q, to_t(a_q), to_t(b_q)


def test_fp8_gemm_nt_matches_jax_with_k_tail():
    m, n, k = 32, 256, 320            # k tail: the last 128-block is half full
    a, b, a_q, b_q, a_t, b_t = _quantized_pair(m, n, k)
    d_jax = np.asarray(dg.fp8_gemm_nt(a_q, b_q), np.float32)
    dense.launches = 0
    d_port = dgt.fp8_gemm_nt(a_t, b_t)
    assert dense.launches == 0                 # CPU tensors: the plain version
    assert d_port.dtype == torch.bfloat16 and tuple(d_port.shape) == (m, n)
    assert calc_diff(d_port, d_jax) < 1e-5
    ref = np.asarray(a, np.float64) @ np.asarray(b, np.float64).T
    assert calc_diff(d_port, ref) < 1e-3       # fp8 quantization error only


def test_fp8_gemm_nt_f32_out_per_channel_matches_jax():
    """The FP8 wgrad's call: per-channel B scales (recipe (1, 1, 128)) into
    an f32 output."""
    rng = np.random.RandomState(2)
    a = jnp.asarray(rng.randn(64, 160).astype(ml_dtypes.bfloat16))
    b = jnp.asarray(rng.randn(96, 160).astype(ml_dtypes.bfloat16))
    a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=False)
    b_q = dg.per_token_cast_to_fp8(b, use_ue8m0=False)
    d_jax = np.asarray(dg.fp8_gemm_nt(a_q, b_q, d=jnp.zeros((), jnp.float32), recipe=(1, 1, 128)))
    to_t = lambda pair: tuple(tensor_from_numpy(np.asarray(v), 'cpu') for v in pair)
    d_port = dgt.fp8_gemm_nt(to_t(a_q), to_t(b_q), d=torch.float32, recipe=(1, 1, 128))
    assert d_port.dtype == torch.float32 and d_jax.dtype == np.float32
    assert calc_diff(d_port, d_jax) < 1e-5


def test_fp8_gemm_nt_k_zero():
    a = (torch.zeros(8, 0, dtype=torch.float8_e4m3fn), torch.zeros(8, 0))
    b = (torch.zeros(16, 0, dtype=torch.float8_e4m3fn), torch.zeros(1, 0))
    d = dgt.fp8_gemm_nt(a, b)
    d_jax = dg.fp8_gemm_nt((jnp.zeros((8, 0), jnp.float8_e4m3fn), jnp.zeros((8, 0))),
                           (jnp.zeros((16, 0), jnp.float8_e4m3fn), jnp.zeros((1, 0))))
    assert tuple(d.shape) == d_jax.shape == (8, 16)
    assert d.dtype == torch.bfloat16 and not d.float().any()


def test_bf16_gemm_nt_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(16, 192).astype(ml_dtypes.bfloat16)
    b = rng.randn(64, 192).astype(ml_dtypes.bfloat16)
    d_jax = np.asarray(dg.bf16_gemm_nt(jnp.asarray(a), jnp.asarray(b)), np.float32)
    d_port = dgt.bf16_gemm_nt(tensor_from_numpy(a, 'cpu'), tensor_from_numpy(b, 'cpu'))
    assert calc_diff(d_port, d_jax) < 1e-5


def test_unported_variants_raise():
    """What the port still refuses, on the CPU as on the card: e4m3 scales
    at a k granularity other than the 128-deep promotion block, and an
    output type other than bf16 or f32."""
    rng = np.random.RandomState(14)
    a = torch.from_numpy(rng.randn(16, 256).astype(np.float32))
    _, _, _, _, _, b_t = _quantized_pair(16, 128, 256)
    a64 = dgt.per_token_cast_to_fp8(a, use_ue8m0=False, gran_k=64)
    assert tuple(a64[1].shape) == (16, 4)
    with pytest.raises(NotImplementedError, match='gran_k 64'):
        dgt.fp8_gemm_nt(a64, b_t, recipe_a=(1, 64), recipe_b=(128, 128))
    a128 = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
    with pytest.raises(NotImplementedError, match='output dtype'):
        dgt.fp8_gemm_nt(a128, b_t, d=torch.float16)


def _fp4_pair(n, k, seed, **cast):
    rng = np.random.RandomState(seed)
    b = jnp.asarray(rng.randn(n, k).astype(ml_dtypes.bfloat16))
    b_q = dg.per_token_cast_to_fp4(b, use_ue8m0=True, **cast)
    return b, b_q, tuple(tensor_from_numpy(np.asarray(v), 'cpu') for v in b_q)


@pytest.mark.parametrize('recipe', [dict(recipe_a=(1, 128), recipe_b=(1, 128)), {}],
                         ids=['recipe_b_1x128', 'derived_gran'])
def test_fp8_fp4_gemm_nt_folds_packed_fp4_b_as_jax(recipe):
    """A packed e2m1 B (int8) with its UE8M0 scales: JAX folds it into exact
    bf16 (its plain route here); the default recipe derives gran_k 128 from
    the SF width."""
    a, _, a_q, _, a_t, _ = _quantized_pair(16, 256, 512, seed=3)
    b, b_q, b_t = _fp4_pair(256, 512, seed=4)
    d_jax = np.asarray(dg.fp8_fp4_gemm_nt(a_q, b_q, **recipe), np.float32)
    dense.launches = 0
    d_port = dgt.fp8_fp4_gemm_nt(a_t, b_t, **recipe)
    assert dense.launches == 0
    assert d_port.dtype == torch.bfloat16 and tuple(d_port.shape) == (16, 256)
    assert calc_diff(d_port, d_jax) < 1e-5
    decoded = np.asarray(dg.cast_back_from_fp4(*b_q), np.float64)
    exact = np.asarray(a_q[0], np.float64) * np.repeat(np.asarray(a_q[1], np.float64), 128, 1)
    assert calc_diff(d_port, exact @ decoded.T) < 1e-5     # the product of what was quantized


def test_fp8_fp4_gemm_nt_packed_fp4_operands_match_jax():
    """Both operands packed FP4, B's scales as packed UE8M0 int32 (k = 1024:
    8 scales in 2 int32, an unambiguous width), and a bf16 A beside a
    packed B (JAX's bf16 dot on the folded B)."""
    _, a4, a4_t = _fp4_pair(32, 1024, seed=5)
    _, b4, b4_t = _fp4_pair(128, 1024, seed=6, use_packed_ue8m0=True)
    assert b4_t[1].dtype == torch.int32
    d_jax = np.asarray(dg.fp8_fp4_gemm_nt(a4, b4), np.float32)
    assert calc_diff(dgt.fp8_fp4_gemm_nt(a4_t, b4_t), d_jax) < 1e-5
    a = np.random.RandomState(7).randn(32, 1024).astype(ml_dtypes.bfloat16)
    d_jax = np.asarray(dg.fp8_fp4_gemm_nt(jnp.asarray(a), b4), np.float32)
    assert calc_diff(dgt.fp8_fp4_gemm_nt(tensor_from_numpy(a, 'cpu'), b4_t), d_jax) < 1e-5


def test_fp8_fp4_gemm_nt_refuses_what_jax_refuses_or_the_port_lacks():
    """A packed SF width that two granularities explain raises ValueError,
    as in JAX; a packed FP4 operand in a T layout raises AssertionError, as
    in JAX (it must be k-major)."""
    _, _, a_q, _, a_t, _ = _quantized_pair(16, 128, 256, seed=8)
    _, b_q, b_t = _fp4_pair(128, 256, seed=9, use_packed_ue8m0=True)
    with pytest.raises(ValueError, match='ambiguous'):
        dg.fp8_fp4_gemm_nt(a_q, b_q)
    with pytest.raises(ValueError, match='ambiguous'):
        dgt.fp8_fp4_gemm_nt(a_t, b_t)
    _, a32, a32_t = _fp4_pair(128, 256, seed=10, gran_k=32)
    with pytest.raises(AssertionError, match='k-major'):
        dg.fp8_fp4_gemm_tn(a32, b_q)
    with pytest.raises(AssertionError, match='k-major'):
        dgt.fp8_fp4_gemm_tn(a32_t, b_t)


# UE8M0 exponent bytes at bf16's limits: 2^-127 (an f32 subnormal), 2^-126,
# 2^-120, 2^-100, 1, 2^27, 2^100, 2^120, 2^127
_EXTREME_UE8M0 = (0, 1, 7, 27, 127, 154, 227, 247, 254)


def _extreme_a(m, k, seed):
    """e4m3 codes [m, k] (every finite code, a third of them subnormal or
    zero) with one UE8M0 exponent byte a 128-deep block, numpy seeded; the
    two that overflow bf16 (2^120 and 2^127: infinite widened values, which
    turn a row's other outputs to NaN) only in every eighth row."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 256, size=(m, k)).astype(np.uint8)
    codes[rng.rand(m, k) < 1 / 3] &= 0x87
    codes[(codes & 0x7F) == 0x7F] = 0x38                  # no NaN codes
    exps = rng.choice(_EXTREME_UE8M0[:-2], size=(m, k // 128))
    exps[::8] = rng.choice(_EXTREME_UE8M0, size=(len(exps[::8]), k // 128))
    return codes, exps.astype(np.uint8)


def _checkered_exps(rows, cols):
    """Exponent bytes of 2^100 and 2^-100 in turns along rows and columns."""
    i = np.arange(rows)[:, None] + np.arange(cols)
    return np.where(i % 2 == 0, 227, 27).astype(np.uint8)


def _subnormal(x):
    return (x != 0) & (x.abs() < 2.0 ** -126)


@pytest.mark.parametrize('form', ['dequant_1x1', 'dequant_128x128', 'mixed_dequant',
                                  'mixed_promote'])
def test_dequant_and_mixed_routes_match_jax_at_extreme_exponents(form):
    """The 'dequant' route (packed UE8M0 scales) and the mixed routes (a
    packed FP4 B at gran 32, folded to bf16, beside e4m3 A under 'dequant'
    or 'promote') at UE8M0 exponents near bf16's limits and on subnormal
    e4m3 codes, against JAX's fp8_gemm_nt / fp8_fp4_gemm_nt (its Pallas
    kernel in interpret mode). B is the identity times 2^100 and 2^-100, so
    each output is one product of A's values. Tolerance: bitwise (NaN where
    JAX is NaN) wherever no f32 subnormal meets the computation; where one
    does (a widened value, a 2^-127 scale, or the product), XLA on the CPU
    flushes it to zero, so JAX's output is zero there and the port's is not
    required to be."""
    m, n = 64, 512
    k = n
    codes, a_exp = _extreme_a(m, k, seed=21)
    a_fp8 = codes.view(ml_dtypes.float8_e4m3fn)
    sfa_f32 = np.ldexp(np.float32(1), a_exp.astype(np.int32) - 127).astype(np.float32)
    a_packed = np.ascontiguousarray(a_exp).view('<i4')            # 4 blocks a word along k
    f32 = dict(d=jnp.zeros((), jnp.float32))
    if form.startswith('dequant'):
        gran_n = 1 if form == 'dequant_1x1' else 128
        b_fp8 = np.eye(n, k, dtype=np.float32).astype(ml_dtypes.float8_e4m3fn)
        b_exp = _checkered_exps(-(-n // gran_n), k // 128)
        b_sf = np.ascontiguousarray(b_exp).view('<i4')
        recipe = (1, gran_n, 128)
        a_q, b_q = (a_fp8, a_packed), (b_fp8, b_sf)
        d_jax = dg.fp8_gemm_nt(tuple(map(jnp.asarray, a_q)), tuple(map(jnp.asarray, b_q)),
                               recipe=recipe, **f32)
        d_port = dgt.fp8_gemm_nt(tuple(tensor_from_numpy(v, 'cpu') for v in a_q),
                                 tuple(tensor_from_numpy(v, 'cpu') for v in b_q),
                                 d=torch.float32, recipe=recipe)
    else:
        eye = np.eye(n, k, dtype=np.float32) * np.ldexp(
            np.float32(1), np.where(np.arange(n) % 2 == 0, 100, -100))[:, None]
        b4 = dg.per_token_cast_to_fp4(jnp.asarray(eye.astype(ml_dtypes.bfloat16)),
                                      use_ue8m0=True, gran_k=32)
        a_q = (a_fp8, a_packed if form == 'mixed_dequant' else sfa_f32)
        kw = dict(recipe_a=(1, 128), recipe_b=(1, 32))
        d_jax = dg.fp8_fp4_gemm_nt(tuple(map(jnp.asarray, a_q)), b4, **kw, **f32)
        d_port = dgt.fp8_fp4_gemm_nt(tuple(tensor_from_numpy(v, 'cpu') for v in a_q),
                                     tuple(tensor_from_numpy(np.asarray(v), 'cpu') for v in b4),
                                     d=torch.float32, **kw)
    d_jax = torch.from_numpy(np.array(d_jax, np.float32))
    assert d_port.dtype == torch.float32 and d_port.shape == d_jax.shape == (m, n)
    # each output's own value of A, widened ('dequant') or not, and its scale
    a_val = torch.from_numpy(codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32))[:, :n]
    sfa = torch.from_numpy(np.repeat(sfa_f32, 128, axis=1))[:, :n]
    widened = (a_val.to(torch.bfloat16) * sfa.to(torch.bfloat16)).float()
    flushed = _subnormal(d_port) | (_subnormal(widened) if 'dequant' in form else _subnormal(sfa))
    nan = torch.isnan(d_port)
    assert torch.isnan(d_jax[nan]).all()
    same = ~flushed & ~nan
    assert torch.equal(d_port[same] + 0, d_jax[same] + 0)       # +0: -0 and 0 alike
    assert (d_jax[flushed & ~nan] == 0).all()
    # the edges were reached: infinities, zeros and exact finite products
    assert torch.isinf(d_port).any() and (d_port[same] == 0).any() and flushed.any()
    assert (torch.isfinite(d_port[same]) & (d_port[same] != 0)).sum() > m * n // 8
