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
