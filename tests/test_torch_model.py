"""The port's MoE transformer, forward and FP8 training step, against the
JAX package's at the size of tests/test_model.py, on parameters carried
across with params_from_jax. JAX runs eagerly, as tests/test_model.py runs
it: under jax.jit XLA re-fuses its casts and f32 math, which moves its own
loss by ~7e-5 relative, while the eager path and the port agree to the
last bit on every bf16 parameter update."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepgemm_tpu.models import transformer as jt
from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
from deepgemm_tpu_torch.models import transformer as tt
from deepgemm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy, tree_leaves
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


def test_fp8_without_kernels_matches_jax():
    """use_fp8 without use_kernels is the JAX package's differentiable
    path: bf16 expert weights, the einsum in f32, no quantization."""
    params_np, tokens = _params_and_tokens()
    cfg = dict(_SIZE, use_fp8=True, use_kernels=False)
    logits_jax = np.asarray(jt.forward(jax.tree.map(jnp.asarray, params_np),
                                       jnp.asarray(tokens), jt.ModelConfig(**cfg)))
    logits = tt.forward(params_from_jax(params_np, device='cpu'), torch.from_numpy(tokens),
                        tt.ModelConfig(**cfg))
    assert calc_diff(logits, logits_jax) < 1e-5


def test_kernel_and_plain_paths_agree_on_cpu():
    """bf16: on CPU tensors use_kernels=True takes the masked wrapper's
    plain version, which computes what use_kernels=False's einsum does (f32
    products of bf16 operands), so both give the same logits and launch
    nothing."""
    params_np, tokens = _params_and_tokens(seed=2)
    params = params_from_jax(params_np, device='cpu')
    grouped.launches.update(bf16=0, fp8=0, fp8_f32=0)
    out = [tt.forward(params, torch.from_numpy(tokens),
                      tt.ModelConfig(**_SIZE, use_kernels=k))
           for k in (True, False)]
    assert torch.equal(out[0], out[1])
    assert grouped.launches == {'bf16': 0, 'fp8': 0, 'fp8_f32': 0}


# capacity_factor 7.9 makes cap = align(int(16 * 7.9) + 1, 8) = 128: the
# 128-row expert blocks the FP8 grouped op's wgrad needs.
_TRAIN = dict(_SIZE, capacity_factor=7.9, use_fp8_training=True)


@pytest.mark.parametrize('use_kernels', [False, True])
def test_train_step_matches_jax(use_kernels):
    """One FP8 SGD step: the loss and every updated parameter against JAX's,
    and the parameter updates themselves (new - old, the gradients times
    lr), which carry the difference a whole parameter hides."""
    params_np, tokens = _params_and_tokens()
    targets = np.random.RandomState(5).randint(0, _SIZE['vocab'], (2, 16)).astype(np.int32)
    cfg = dict(_TRAIN, use_kernels=use_kernels)
    loss_jax, new_jax = jt.train_step(jax.tree.map(jnp.asarray, params_np), jnp.asarray(tokens),
                                      jnp.asarray(targets), jt.ModelConfig(**cfg), lr=5e-2)
    counts = (dense.launches, dict(grouped.contiguous_launches), dict(k_grouped.launches))
    loss, new = tt.train_step(params_from_jax(params_np, device='cpu'), torch.from_numpy(tokens),
                              torch.from_numpy(targets), tt.ModelConfig(**cfg), lr=5e-2)
    assert counts == (dense.launches, grouped.contiguous_launches, k_grouped.launches)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert calc_diff(loss, np.asarray(loss_jax)) < 1e-5
    old_leaves = jax.tree.leaves(params_np)
    new_leaves = jax.tree.leaves(jax.tree.map(np.asarray, new_jax))
    port_leaves = tree_leaves(new)
    assert len(port_leaves) == len(new_leaves) == 9
    for i, (p, j, o) in enumerate(zip(port_leaves, new_leaves, old_leaves)):
        assert p.dtype == tensor_from_numpy(o, 'cpu').dtype, i
        assert calc_diff(p, j.astype(np.float32)) < 1e-5, i
        o = o.astype(np.float32)
        assert calc_diff(p.float().numpy() - o, j.astype(np.float32) - o) < 1e-5, i


def test_train_step_decreases_loss():
    """tests/test_model.py's check on the port: three FP8 steps through the
    grouped op at lr 5e-2 lower the loss."""
    params_np, tokens = _params_and_tokens()
    params = params_from_jax(params_np, device='cpu')
    tok = torch.from_numpy(tokens)
    cfg = tt.ModelConfig(**_TRAIN, use_kernels=True)
    losses = [float(tt.train_step(params, tok, tok.roll(1, -1), cfg, lr=5e-2)[0])
              for _ in range(3)]
    assert losses[2] < losses[0], losses


def test_init_params_on_cpu_when_asked():
    params = tt.init_params(tt.ModelConfig(**_SIZE), seed=3, device='cpu')
    w1 = params['layers'][0]['w1']
    assert w1.device.type == 'cpu' and w1.dtype == torch.bfloat16
    assert tuple(w1.shape) == (4, 256, 128)
    assert abs(w1.float().std().item() - 128 ** -0.5) < 0.01
    again = tt.init_params(tt.ModelConfig(**_SIZE), seed=3, device='cpu')
    assert torch.equal(again['layers'][0]['w1'], w1)


_MEGA = dict(_SIZE, num_layers=2)


@pytest.mark.parametrize('comm,use_fp8', [('fused', True), ('xla', True), ('fused', False)])
def test_mega_forward_matches_jax(comm, use_fp8):
    """The 2-layer model through the mega MoE at one rank, against the JAX
    model's (its fused kernel in Pallas interpret mode on a one-device
    mesh, the default bf16 act)."""
    params_np = jax.tree.map(np.asarray, jt.init_params(jt.ModelConfig(**_MEGA)))
    tokens = np.random.RandomState(3).randint(0, _MEGA['vocab'], (2, 16)).astype(np.int32)
    cfg = dict(_MEGA, use_fp8=use_fp8, use_kernels=True, use_mega=True, mega_comm=comm)
    logits_jax = np.asarray(jt.forward(jax.tree.map(jnp.asarray, params_np), jnp.asarray(tokens),
                                       jt.ModelConfig(**cfg)))
    logits = tt.forward(params_from_jax(params_np, device='cpu'), torch.from_numpy(tokens),
                        tt.ModelConfig(**cfg))
    assert torch.isfinite(logits).all() and tuple(logits.shape) == (2, 16, _MEGA['vocab'])
    assert calc_diff(logits, logits_jax) < 1e-5
    if comm == 'xla':
        unfused = tt.forward(params_from_jax(params_np, device='cpu'), torch.from_numpy(tokens),
                             tt.ModelConfig(**dict(cfg, use_mega=False)))
        assert torch.equal(logits, unfused)
