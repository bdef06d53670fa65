"""The port's differentiable FP8 matmuls (the kernels' plain versions on the
CPU) against the JAX package's custom VJPs (Pallas in interpret mode) on the
same numpy x, w, ids and upstream gradient g, at the sizes of
tests/test_autograd.py: the forward, dx and dw."""

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from deepgemm_tpu.ops import autograd as ja
from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
from deepgemm_tpu_torch.ops import autograd as ta
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.testing import calc_diff


def _bf16(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(ml_dtypes.bfloat16)


def _jax_vjp(fn, g, *args):
    """Eager, as tests/test_autograd.py runs it: under jax.jit, XLA computes
    the casts' scales in another order (4.7e-10 apart at this size), which
    moves a few fp8 values by one step; eagerly the port matches bit for
    bit."""
    out, vjp = jax.vjp(fn, *args)
    return (out,) + vjp(g)


def _torch_vjp(fn, g, x, w, *rest):
    x = tensor_from_numpy(x, 'cpu').requires_grad_()
    w = tensor_from_numpy(w, 'cpu').requires_grad_()
    out = fn(x, w, *(tensor_from_numpy(r, 'cpu') for r in rest))
    out.backward(tensor_from_numpy(g, 'cpu'))
    return out.detach(), x.grad, w.grad


def _compare(port, want, names):
    for name, p, j in zip(names, port, want):
        j = np.asarray(j)
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == j.shape, name
        assert calc_diff(p, j.astype(np.float32)) < 1e-5, name


def test_fp8_matmul_matches_jax():
    rng = np.random.RandomState(1)
    m, n, k = 64, 128, 256
    x, w, g = _bf16(rng, m, k), _bf16(rng, n, k, scale=0.1), _bf16(rng, m, n)
    want = _jax_vjp(ja.fp8_matmul, g, x, w)
    dense.launches = 0
    port = _torch_vjp(ta.fp8_matmul, g, x, w)
    assert dense.launches == 0                  # CPU: the plain versions
    _compare(port, want, ('out', 'dx', 'dw'))
    ref = np.asarray(x, np.float64) @ np.asarray(w, np.float64).T
    assert calc_diff(port[0], ref) < 1e-3        # fp8 quantization error only


def test_fp8_dense_keeps_leading_dims():
    rng = np.random.RandomState(2)
    x = tensor_from_numpy(_bf16(rng, 2, 16, 128), 'cpu')
    w = tensor_from_numpy(_bf16(rng, 64, 128, scale=0.1), 'cpu')
    out = ta.fp8_dense(x, w)
    assert tuple(out.shape) == (2, 16, 64)
    assert torch.equal(out, ta.fp8_matmul(x.reshape(32, 128), w).reshape(2, 16, 64))


@pytest.mark.parametrize('padded', [False, True])
def test_fp8_grouped_matmul_matches_jax(padded):
    """Two groups of 128 rows; with ``padded`` the last 40 rows of group 0
    and 8 of group 1 are padding (-1) rows holding nonzero x."""
    rng = np.random.RandomState(3)
    num_groups, rows, n, k = 2, 128, 128, 256
    m = num_groups * rows
    ids = np.repeat(np.arange(num_groups, dtype=np.int32), rows)
    if padded:
        ids[88:128] = ids[248:] = -1
    x, w, g = _bf16(rng, m, k), _bf16(rng, num_groups, n, k, scale=0.1), _bf16(rng, m, n)
    want = _jax_vjp(ja.fp8_grouped_matmul, g, x, w, jnp.asarray(ids))[:3]
    grouped.contiguous_launches.update(bf16=0, fp8=0)
    k_grouped.launches.update(bf16=0, fp8=0)
    port = _torch_vjp(ta.fp8_grouped_matmul, g, x, w, ids)
    assert grouped.contiguous_launches == {'bf16': 0, 'fp8': 0}
    assert k_grouped.launches == {'bf16': 0, 'fp8': 0}
    _compare(port, want, ('out', 'dx', 'dw'))
    assert not port[0][torch.from_numpy(ids < 0)].float().any()
    assert not port[1][torch.from_numpy(ids < 0)].float().any()
