"""The router's top-k on tied logits, the port against the JAX package.

JAX routes with ``jax.lax.top_k``, which puts the lower expert first among
equal logits; the port must pick the same experts, or a token whose logits
tie (a zero hidden row ties all of them) goes to other experts than JAX
sends it to. Both packages get the same parameters (params_from_jax) and the
same tokens; JAX runs eagerly on its XLA path, the port on its plain
versions (the CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepgemm_tpu.models import transformer as jt
from deepgemm_tpu_torch.models import transformer as tt
from deepgemm_tpu_torch.models.convert import params_from_jax
from deepgemm_tpu_torch.testing import calc_diff

_SIZE = dict(vocab=128, hidden=128, num_layers=1, num_heads=2, head_dim=64,
             num_experts=8, topk=2, moe_intermediate=128, capacity_factor=8.0)


def _tied_params(kind):
    """JAX's parameters with a router whose logits tie: 'zero' ties all
    eight on every token; 'partial' gives experts 1, 3, 5, 6 one router row
    and 0, 2, 4, 7 a zero row, so each token's top two come from a tie of
    four (the four equal positive logits, or the four zeros)."""
    params = jax.tree.map(np.asarray, jt.init_params(jt.ModelConfig(**_SIZE)))
    router = params['layers'][0]['router']
    tied = np.zeros_like(router)
    if kind == 'partial':
        tied[[1, 3, 5, 6]] = router[0]
    params['layers'][0]['router'] = tied
    return params


def _tokens(seed=3):
    return np.random.RandomState(seed).randint(0, _SIZE['vocab'], (2, 16)).astype(np.int32)


def _port_routes(monkeypatch):
    """Record the experts the port's moe_block hands its MoE forward."""
    routes, forward = [], tt.ep_moe_forward

    def record(tok, idx, *args, **kw):
        routes.append(idx.clone())
        return forward(tok, idx, *args, **kw)
    monkeypatch.setattr(tt, 'ep_moe_forward', record)
    return routes


@pytest.mark.parametrize('kind', ['zero', 'partial'])
def test_moe_block_routes_ties_as_jax(kind, monkeypatch):
    params_np = _tied_params(kind)
    layer_np = params_np['layers'][0]
    x_np = np.array(jnp.asarray(np.random.RandomState(5).randn(2, 16, _SIZE['hidden']),
                                jnp.bfloat16))
    if kind == 'zero':
        x_np[0, :4] = 0          # zero hidden rows as well: every logit exactly 0
    x_j = jnp.asarray(x_np)
    logits = np.asarray(x_j.reshape(-1, _SIZE['hidden']).astype(jnp.float32)
                        @ jnp.asarray(layer_np['router']).T)
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), _SIZE['topk'])[1])
    ties = (logits[:, :, None] == logits[:, None, :]).sum(-1).max(-1)
    assert (ties >= 4).all()                      # every token's choice is a tie
    y_jax = np.asarray(jt.moe_block(x_j, jax.tree.map(jnp.asarray, layer_np),
                                    jt.ModelConfig(**_SIZE), None).astype(jnp.float32))

    routes = _port_routes(monkeypatch)
    layer = params_from_jax(params_np, device='cpu')['layers'][0]
    x = torch.from_numpy(x_np.astype(np.float32)).to(torch.bfloat16)
    y = tt.moe_block(x, layer, tt.ModelConfig(**_SIZE, use_kernels=True))
    assert len(routes) == 1
    np.testing.assert_array_equal(routes[0].numpy(), want_idx)
    assert torch.isfinite(y.float()).all()
    assert calc_diff(y.float(), y_jax) < 1e-5


@pytest.mark.parametrize('kind', ['zero', 'partial'])
def test_forward_routes_ties_as_jax(kind, monkeypatch):
    params_np = _tied_params(kind)
    tokens = _tokens()
    logits_jax = np.asarray(jt.forward(jax.tree.map(jnp.asarray, params_np),
                                       jnp.asarray(tokens), jt.ModelConfig(**_SIZE)))
    routes = _port_routes(monkeypatch)
    logits = tt.forward(params_from_jax(params_np, device='cpu'), torch.from_numpy(tokens),
                        tt.ModelConfig(**_SIZE, use_kernels=True))
    assert len(routes) == 1
    if kind == 'zero':
        want = np.tile(np.arange(_SIZE['topk']), (tokens.size, 1))
        np.testing.assert_array_equal(routes[0].numpy(), want)
    assert torch.isfinite(logits).all()
    assert calc_diff(logits, logits_jax) < 1e-5
