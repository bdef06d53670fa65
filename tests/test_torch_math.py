"""The port's quantization casts (deepgemm_tpu_torch/utils/math.py) are
bitwise equal to the JAX package's on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from deepgemm_tpu.utils import math as jm
from deepgemm_tpu_torch.testing import assert_bitwise_equal
from deepgemm_tpu_torch.utils import math as tm


def _bf16_pair(shape, seed):
    """The same bf16 values as a JAX array and a CPU torch tensor."""
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(ml_dtypes.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)


def _check(j_out, t_out, label):
    for i, (a, b) in enumerate(zip(j_out, t_out)):
        assert_bitwise_equal(b, np.asarray(a), f'{label}[{i}]')


@pytest.mark.parametrize('use_ue8m0', [False, True])
@pytest.mark.parametrize('shape', [(8, 256), (5, 200)])
def test_per_token_cast_bitwise(shape, use_ue8m0):
    xj, xt = _bf16_pair(shape, seed=1)
    _check(jm.per_token_cast_to_fp8(xj, use_ue8m0=use_ue8m0),
           tm.per_token_cast_to_fp8(xt, use_ue8m0=use_ue8m0), 'per_token')


def test_per_token_cast_packed_bitwise():
    xj, xt = _bf16_pair((4, 512), seed=2)
    _check(jm.per_token_cast_to_fp8(xj, use_ue8m0=True, use_packed_ue8m0=True),
           tm.per_token_cast_to_fp8(xt, use_ue8m0=True, use_packed_ue8m0=True),
           'per_token_packed')


@pytest.mark.parametrize('use_ue8m0', [False, True])
def test_per_channel_cast_bitwise(use_ue8m0):
    xj, xt = _bf16_pair((256, 96), seed=3)
    _check(jm.per_channel_cast_to_fp8(xj, use_ue8m0=use_ue8m0),
           tm.per_channel_cast_to_fp8(xt, use_ue8m0=use_ue8m0), 'per_channel')


@pytest.mark.parametrize('use_ue8m0', [False, True])
@pytest.mark.parametrize('shape', [(256, 384), (200, 136)])
def test_per_block_cast_bitwise(shape, use_ue8m0):
    xj, xt = _bf16_pair(shape, seed=4)
    _check(jm.per_block_cast_to_fp8(xj, use_ue8m0=use_ue8m0),
           tm.per_block_cast_to_fp8(xt, use_ue8m0=use_ue8m0), 'per_block')


def test_ue8m0_round_pack_unpack_bitwise():
    rng = np.random.RandomState(5)
    x = (rng.rand(6, 16) * 10.0 ** rng.randint(-30, 30, (6, 16))).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 2.0 ** -126, 3.0e38]
    up_j = jm.ceil_to_ue8m0(jnp.asarray(x))
    up_t = tm.ceil_to_ue8m0(torch.from_numpy(x))
    assert_bitwise_equal(up_t, np.asarray(up_j), 'ceil_to_ue8m0')
    packed_j = jm.pack_ue8m0_to_int(up_j)
    packed_t = tm.pack_ue8m0_to_int(up_t)
    assert_bitwise_equal(packed_t, np.asarray(packed_j), 'pack')
    assert_bitwise_equal(tm.unpack_ue8m0_from_int(packed_t),
                         np.asarray(jm.unpack_ue8m0_from_int(packed_j)), 'unpack')


def test_cast_to_fp8_saturates():
    x = np.array([[-1e6, -448.0, -1.0, 0.0, 0.3, 447.9, 500.0, 1e9]], np.float32)
    assert_bitwise_equal(tm.cast_to_fp8(torch.from_numpy(x)),
                         np.asarray(jm.cast_to_fp8(jnp.asarray(x))), 'cast')


@pytest.mark.parametrize('transpose', [False, True])
def test_quantize_experts_bitwise(transpose, monkeypatch):
    """The batched per-expert cast, two experts per chunk, against the JAX
    package's per-expert per_block_cast_to_fp8 (of each expert's transpose
    for the dgrad)."""
    w_j, w_t = _bf16_pair((5, 200, 136), seed=7)
    per = [jm.per_block_cast_to_fp8(w_j[e].T if transpose else w_j[e], use_ue8m0=False)
           for e in range(5)]
    want = (np.stack([np.asarray(q) for q, _ in per]), np.stack([np.asarray(f) for _, f in per]))
    monkeypatch.setattr(tm, '_CHUNK_ELEMS', 2 * 200 * 136)
    got = tm.quantize_experts(w_t, transpose=transpose)
    _check(want, got, f'quantize_experts(transpose={transpose})')


@pytest.mark.parametrize('use_ue8m0', [False, True])
@pytest.mark.parametrize('shape,dims', [((96, 128), (0,)), ((6, 4, 64), (0, 1)), ((3, 32), (0, 1))])
def test_per_custom_dims_cast_bitwise(shape, dims, use_ue8m0):
    """The indexer's per-token kv cast: one scale per index of the kept dims
    (all dims kept: one scale per element)."""
    xj, xt = _bf16_pair(shape, seed=8)
    _check(jm.per_custom_dims_cast_to_fp8(xj, dims, use_ue8m0=use_ue8m0),
           tm.per_custom_dims_cast_to_fp8(xt, dims, use_ue8m0=use_ue8m0), 'per_custom_dims')


# ---- FP4 (e2m1) helpers -------------------------------------------------

@pytest.mark.parametrize('use_ue8m0,use_packed_ue8m0', [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize('shape', [(8, 256), (5, 200)])
def test_per_token_cast_to_fp4_bitwise(shape, use_ue8m0, use_packed_ue8m0):
    xj, xt = _bf16_pair(shape, seed=11)
    _check(jm.per_token_cast_to_fp4(xj, use_ue8m0=use_ue8m0, use_packed_ue8m0=use_packed_ue8m0),
           tm.per_token_cast_to_fp4(xt, use_ue8m0=use_ue8m0, use_packed_ue8m0=use_packed_ue8m0),
           'per_token_fp4')


def test_fp4_code_helpers_bitwise():
    """Quantize and dequantize every code (signed zero included, which
    decodes to +0), the planar-128 pack and its inverse, the repack from
    adjacent pairs, the transpose and the cast back."""
    rng = np.random.RandomState(12)
    vals = (rng.randn(6, 512) * 3).astype(np.float32)
    vals[0, :17] = [0.0, -0.0, 0.25, -0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 7.0, -7.0,
                    -0.1, 0.1, -5.0, 6.0, -6.0]
    codes_j = jm._quantize_to_fp4_e2m1(jnp.asarray(vals))
    codes_t = tm._quantize_to_fp4_e2m1(torch.from_numpy(vals))
    assert_bitwise_equal(codes_t, np.asarray(codes_j), 'codes')
    all_codes = np.arange(16, dtype=np.int8)
    assert_bitwise_equal(tm._dequantize_from_fp4_e2m1(torch.from_numpy(all_codes)),
                         np.asarray(jm._dequantize_from_fp4_e2m1(jnp.asarray(all_codes))), 'dequant')
    planar_j = jm.pack_fp4_planar(codes_j.astype(jnp.int32))
    planar_t = tm.pack_fp4_planar(codes_t.to(torch.int32))
    assert_bitwise_equal(planar_t, np.asarray(planar_j), 'planar')
    assert_bitwise_equal(tm.unpack_fp4_planar(planar_t), np.asarray(jm.unpack_fp4_planar(planar_j)),
                         'unplanar')
    xj, xt = _bf16_pair((6, 512), seed=13)
    pj, sj = jm.per_token_cast_to_fp4(xj, use_ue8m0=False)
    pt, st = tm.per_token_cast_to_fp4(xt, use_ue8m0=False)
    assert_bitwise_equal(tm.unpack_fp4_codes(pt), np.asarray(jm.unpack_fp4_codes(pj)), 'unpack')
    assert_bitwise_equal(tm.repack_fp4_to_planar(pt), np.asarray(jm.repack_fp4_to_planar(pj)),
                         'repack')
    assert_bitwise_equal(tm.transpose_packed_fp4(pt), np.asarray(jm.transpose_packed_fp4(pj)),
                         'transpose')
    assert_bitwise_equal(tm.cast_back_from_fp4(pt, st), np.asarray(jm.cast_back_from_fp4(pj, sj)),
                         'cast_back')
    pj8, sj8 = jm.per_token_cast_to_fp4(xj, use_ue8m0=True, use_packed_ue8m0=True)
    pt8, st8 = tm.per_token_cast_to_fp4(xt, use_ue8m0=True, use_packed_ue8m0=True)
    assert_bitwise_equal(tm.cast_back_from_fp4(pt8, st8, use_packed_ue8m0=True),
                         np.asarray(jm.cast_back_from_fp4(pj8, sj8, use_packed_ue8m0=True)),
                         'cast_back_packed')
