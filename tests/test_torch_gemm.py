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
