"""The port's MoE transformer forward against the JAX package's, at the size
of tests/test_model.py, on parameters carried across with params_from_jax."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepgemm_tpu.models import transformer as jt
from deepgemm_tpu_torch.kernels import grouped
from deepgemm_tpu_torch.models import transformer as tt
from deepgemm_tpu_torch.models.convert import params_from_jax
from deepgemm_tpu_torch.testing import assert_bitwise_equal, calc_diff

_SIZE = dict(vocab=128, hidden=128, num_layers=1, num_heads=2, head_dim=64,
             num_experts=4, topk=2, moe_intermediate=128, capacity_factor=8.0)


def _params_and_tokens(seed=1):
    params_np = jax.tree.map(np.asarray, jt.init_params(jt.ModelConfig(**_SIZE)))
    tokens = np.random.RandomState(seed).randint(0, _SIZE['vocab'], (2, 16)).astype(np.int32)
    return params_np, tokens


def test_params_from_jax_round_trips_exactly():
    params_np, _ = _params_and_tokens()
    params_t = params_from_jax(params_np, device='cpu')
    leaves_np = jax.tree.leaves(params_np)
    leaves_t = jax.tree.leaves(params_t)
    assert len(leaves_np) == len(leaves_t) == 2 + 7 * _SIZE['num_layers']
    for a, t in zip(leaves_np, leaves_t):
        assert t.device.type == 'cpu'
        assert_bitwise_equal(t, a)
    assert params_t['embed'].dtype == torch.bfloat16
    assert params_t['layers'][0]['router'].dtype == torch.float32


@pytest.mark.parametrize('use_fp8', [False, True])
def test_forward_matches_jax(use_fp8):
    """bf16: the JAX oracle is its XLA path (tests/test_model.py holds it to
    the Pallas path at 1e-5); fp8: the JAX Pallas path in interpret mode."""
    params_np, tokens = _params_and_tokens()
    jcfg = jt.ModelConfig(**_SIZE, use_fp8=use_fp8, use_kernels=use_fp8)
    logits_jax = np.asarray(jt.forward(jax.tree.map(jnp.asarray, params_np),
                                       jnp.asarray(tokens), jcfg))
    tcfg = tt.ModelConfig(**_SIZE, use_fp8=use_fp8, use_kernels=True)
    logits = tt.forward(params_from_jax(params_np, device='cpu'),
                        torch.from_numpy(tokens), tcfg)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 16, _SIZE['vocab'])
    assert torch.isfinite(logits).all()
    assert calc_diff(logits, logits_jax) < 1e-5


def test_kernel_and_plain_paths_agree_on_cpu():
    """On CPU tensors use_kernels=True takes the wrappers' plain versions,
    so both settings compute the same logits and launch nothing."""
    params_np, tokens = _params_and_tokens(seed=2)
    params = params_from_jax(params_np, device='cpu')
    grouped.launches.update(bf16=0, fp8=0)
    out = [tt.forward(params, torch.from_numpy(tokens),
                      tt.ModelConfig(**_SIZE, use_fp8=True, use_kernels=k))
           for k in (True, False)]
    assert torch.equal(out[0], out[1])
    assert grouped.launches == {'bf16': 0, 'fp8': 0}


def test_init_params_on_cpu_when_asked():
    params = tt.init_params(tt.ModelConfig(**_SIZE), seed=3, device='cpu')
    w1 = params['layers'][0]['w1']
    assert w1.device.type == 'cpu' and w1.dtype == torch.bfloat16
    assert tuple(w1.shape) == (4, 256, 128)
    assert abs(w1.float().std().item() - 128 ** -0.5) < 0.01
    again = tt.init_params(tt.ModelConfig(**_SIZE), seed=3, device='cpu')
    assert torch.equal(again['layers'][0]['w1'], w1)
