"""The port's expert-parallel tier (deepgemm_tpu_torch/parallel/{dist,
collectives,moe,mega}.py, the general fused kernels of kernels/fused_moe.py,
heuristics/mega.py and the model forward over a mesh) against the JAX
package on the same numpy inputs, at small widths. The port's mesh runs its
ranks as CPU threads through the plain versions; JAX runs shard_map over a
mesh of CPU devices through its XLA paths only (the MoE alone under jax.jit,
the whole model eagerly: under jit XLA's fusions move the router's f32 sums
enough to flip a top-k choice) (``use_kernels=False``,
``jax.lax.all_to_all``), never a Pallas kernel on a mesh of more than one
device: JAX's own suite holds its 'pallas' transport bitwise its 'xla' one
and its fused kernel to the unfused path, so its XLA path is the oracle."""

import dataclasses
import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import deepgemm_tpu as dg
from deepgemm_tpu.heuristics import arch as jarch
from deepgemm_tpu.heuristics import mega as jhmega
from deepgemm_tpu.kernels import fused_moe as jfm
from deepgemm_tpu.models import transformer as jt
from deepgemm_tpu.parallel import dist as jdist
from deepgemm_tpu.parallel import moe as jmoe
from deepgemm_tpu_torch.heuristics import mega as thmega
from deepgemm_tpu_torch.heuristics.arch import H100_SXM, ArchSpec
from deepgemm_tpu_torch.kernels import fused_moe as tfm
from deepgemm_tpu_torch.models import transformer as tt
from deepgemm_tpu_torch.models.convert import params_from_jax, shard_experts, tensor_from_numpy
from deepgemm_tpu_torch.parallel import collectives, dist, mega, moe
from deepgemm_tpu_torch.testing import assert_bitwise_equal, calc_diff
from deepgemm_tpu_torch.utils.math import quantize_experts

HIDDEN, INTER, TOKENS = 256, 256, 32          # tokens a rank


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for name in ('DGT_MEGA_ACT_FP8', 'DGT_MEGA_POOL'):
        monkeypatch.delenv(name, raising=False)


def _t(a):
    return tensor_from_numpy(np.asarray(a), 'cpu')


def _cpu_mesh(d, axes=None, timeout=None):
    return dist.make_mesh(axes or [('ep', d)], ['cpu'] * d, timeout=timeout)


def _jax_mesh(d):
    return jdist.make_mesh([('ep', d)], jax.devices()[:d])


def _shards(t, d):
    return list(t.chunk(d))


def _quant(w):
    """Per-expert 128x128 block casts by the JAX package's own helper."""
    q, s = jax.vmap(lambda m: dg.per_block_cast_to_fp8(m, use_ue8m0=False))(w)
    return np.asarray(q), np.asarray(s)


@functools.lru_cache(maxsize=None)
def _moe_case(d, experts, seed=0, capacity_factor=2.0, skew=False):
    """Numpy MoE inputs for d ranks (TOKENS each): x, topk_idx, topk_w, w1,
    w2 and the fp8 casts of the weights."""
    rng = np.random.RandomState(seed)
    cfg = jmoe.MoEConfig(num_experts=experts, hidden=HIDDEN, intermediate=INTER, topk=2,
                         capacity_factor=capacity_factor, use_fp8=False, use_kernels=False)
    t = TOKENS * d
    x = np.asarray(jnp.asarray(rng.randn(t, HIDDEN), jnp.bfloat16))
    idx = np.argsort(-rng.randn(t, experts), axis=1)[:, :2].astype(np.int32)
    if skew:
        idx[:, 0] = 0
    tw = rng.uniform(0.5, 1.5, size=(t, 2)).astype(np.float32)
    w1 = jnp.asarray(rng.randn(experts, 2 * INTER, HIDDEN) * 0.05, jnp.bfloat16)
    w2 = jnp.asarray(rng.randn(experts, HIDDEN, INTER) * 0.05, jnp.bfloat16)
    return dict(cfg=cfg, x=x, idx=idx, tw=tw, w1=np.asarray(w1), w2=np.asarray(w2),
                q1=_quant(w1), q2=_quant(w2))


@functools.lru_cache(maxsize=None)
def _jax_ep_moe(d, experts, fp8, capacity_factor=2.0, skew=False):
    """JAX's unfused XLA path over an ('ep', d) mesh: (y, num_dropped)."""
    c = _moe_case(d, experts, capacity_factor=capacity_factor, skew=skew)
    w1, s1 = c['q1'] if fp8 else (c['w1'], None)
    w2, s2 = c['q2'] if fp8 else (c['w2'], None)
    args = [c['x'], c['idx'], c['tw'], w1, w2] + ([s1, s2] if fp8 else [])

    def fwd(x, idx, tw, a1, a2, *sf):
        sf1, sf2 = sf if sf else (None, None)
        return jmoe.ep_moe_forward(x, idx, tw, a1, sf1, a2, sf2, c['cfg'])

    y, dropped = jax.jit(shard_map(fwd, mesh=_jax_mesh(d), check_vma=False,
                                   in_specs=(P('ep'),) * len(args),
                                   out_specs=(P('ep'), P('ep'))))(*map(jnp.asarray, args))
    return np.asarray(y), np.asarray(dropped)


def _port_moe(d, experts, fp8, fn, capacity_factor=2.0, skew=False):
    """Run ``fn(x, idx, tw, w1, w1_sf, w2, w2_sf, cfg)`` on an ('ep', d)
    CPU mesh; returns (y [d*TOKENS, H], num_dropped per rank)."""
    c = _moe_case(d, experts, capacity_factor=capacity_factor, skew=skew)
    cfg = moe.MoEConfig(num_experts=experts, hidden=HIDDEN, intermediate=INTER, topk=2,
                        capacity_factor=capacity_factor, use_fp8=fp8, use_kernels=True)
    if fp8:
        (w1, s1), (w2, s2) = [tuple(map(_t, q)) for q in (c['q1'], c['q2'])]
    else:
        w1, s1, w2, s2 = _t(c['w1']), None, _t(c['w2']), None
    none = [None] * d
    sh = lambda t: none if t is None else _shards(t, d)
    outs = _cpu_mesh(d).map(lambda *a: fn(*a, cfg), sh(_t(c['x'])),
                            sh(torch.from_numpy(c['idx'])), sh(torch.from_numpy(c['tw'])),
                            sh(w1), sh(s1), sh(w2), sh(s2))
    return torch.cat([y for y, _ in outs]), torch.cat([n for _, n in outs])


# ---- the mesh and its collectives -------------------------------------------

@pytest.mark.parametrize('d', [2, 4])
def test_all_to_all_plain_is_jax_all_to_all(d):
    """#15's plain version (the mesh's host all-to-all) is bitwise
    jax.lax.all_to_all(x, 'ep', 0, 0, tiled=False); so are psum and
    all_gather of the mesh."""
    rng = np.random.RandomState(d)
    x = np.asarray(jnp.asarray(rng.randn(d * d, 5, 16), jnp.bfloat16))
    w = rng.randn(d * d, 5).astype(np.float32)
    want = np.asarray(shard_map(lambda v: jax.lax.all_to_all(v, 'ep', 0, 0, tiled=False),
                                mesh=_jax_mesh(d), in_specs=P('ep'), out_specs=P('ep'),
                                check_vma=False)(jnp.asarray(x)))
    want_sum = np.asarray(shard_map(lambda v: jax.lax.psum(v, 'ep'), mesh=_jax_mesh(d),
                                    in_specs=P('ep'), out_specs=P('ep'),
                                    check_vma=False)(jnp.asarray(w)))
    outs = _cpu_mesh(d).map(
        lambda v, u: (collectives.pallas_all_to_all(v, 'ep'), dist.psum(u, 'ep'),
                      dist.all_gather(u, 'ep'), dist.psum(1, 'ep'), dist.axis_index('ep')),
        _shards(_t(x), d), _shards(torch.from_numpy(w), d))
    assert_bitwise_equal(torch.cat([o[0] for o in outs]), want)
    assert_bitwise_equal(torch.cat([o[1] for o in outs]), want_sum)
    for r, o in enumerate(outs):
        assert torch.equal(o[2].reshape(d * d, 5), torch.from_numpy(w))
        assert o[3] == d and o[4] == r


def test_uneven_all_gather_and_axis_groups():
    mesh = _cpu_mesh(4, axes=[('dp', 2), ('ep', 2)])
    sizes = [1, 3]
    outs = mesh.map(lambda v: (dist.uneven_all_gather(v, 'ep', sizes), dist.axis_index('dp')),
                    [torch.full((sizes[r % 2], 2), float(r)) for r in range(4)])
    for r, (g, dp) in enumerate(outs):
        base = 2 * (r // 2)
        assert dp == r // 2
        assert torch.equal(g, torch.cat([torch.full((1, 2), float(base)),
                                         torch.full((3, 2), float(base + 1))]))


def test_a_failing_rank_raises_in_the_caller():
    """A rank that raises breaks the barrier for every rank: the caller gets
    that rank's exception, not a hang; a rank that never arrives makes the
    others raise TimeoutError within the mesh's timeout."""
    mesh = _cpu_mesh(4, timeout=2.0)

    def bad(v):
        if dist.axis_index('ep') == 2:
            raise KeyError('rank 2 fails')
        return dist.all_to_all(v, 'ep')

    t0 = time.monotonic()
    with pytest.raises(KeyError, match='rank 2 fails'):
        mesh.map(bad, [torch.zeros(4, 3)] * 4)

    def missing(v):
        if dist.axis_index('ep') == 1:
            time.sleep(3.0)
            return v
        return dist.all_to_all(v, 'ep')

    with pytest.raises(TimeoutError, match='waited more than 2.0 s'):
        mesh.map(missing, [torch.zeros(4, 3)] * 4)
    assert time.monotonic() - t0 < 10.0
    with pytest.raises(RuntimeError, match='outside Mesh.map'):
        dist.all_to_all(torch.zeros(4, 3), 'ep')
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh.map(lambda v: dist.symmetric('x', 16), [None] * 4)


def test_launch_counts_and_plain_switch_survive_many_threads():
    """The ranks bump launch counts and open plain_versions from their own
    threads: with more threads than cores and a short switch interval, no
    count is lost and the switch closes again."""
    import sys
    from deepgemm_tpu_torch.kernels import common
    counts = {'k': 0}
    mesh = _cpu_mesh(16)

    def work(_):
        for _ in range(2000):
            common.count_launch(counts, 'k')
            with common.plain_versions():
                assert common._plain_on_cuda > 0

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mesh.map(work, [None] * 16)
    finally:
        sys.setswitchinterval(before)
    assert counts['k'] == 16 * 2000
    assert common._plain_on_cuda == 0


# ---- the MoE over a mesh -------------------------------------------------------

@pytest.mark.parametrize('d', [2, 4])
@pytest.mark.parametrize('fp8', [False, True])
def test_ep_and_mega_moe_match_jax(d, fp8):
    """ep_moe_forward and mega_moe_forward 'xla', 'pallas' and 'fused' (1
    and 3 chunks) over d ranks against JAX's unfused XLA path; 'xla' and
    'pallas' bitwise the port's unfused path (JAX's contract). 'fused'
    runs its plain version a slab at a time, and the CPU's f32 products
    may sum in another order for another row count, so it is held to the
    unfused path at 1e-5 (its bits are held on the card). fp8: JAX's XLA
    path dequantizes the weights and keeps the tokens bf16, the port casts
    the tokens per token as the kernels do."""
    experts = 4 * d
    want, want_dropped = _jax_ep_moe(d, experts, fp8)
    limit = 2e-3 if fp8 else 1e-5
    unfused, dropped = _port_moe(d, experts, fp8, moe.ep_moe_forward)
    assert calc_diff(unfused, want) < limit
    assert int(dropped.sum()) == int(want_dropped.sum())
    for comm in ('xla', 'pallas', 'fused'):
        for chunks in (1, 3):
            y, dr = _port_moe(d, experts, fp8, lambda *a, c=comm, n=chunks: mega.mega_moe_forward(
                *a, comm=c, num_chunks=n))
            assert torch.equal(dr, dropped)
            assert calc_diff(y, want) < limit, (comm, chunks)
            if comm != 'fused':
                assert torch.equal(y, unfused), (comm, chunks)
            elif not fp8:
                assert calc_diff(y, unfused) < 1e-5, chunks


def test_recv_stats_match_jax():
    d, experts = 4, 16
    c = _moe_case(d, experts)
    cfg_t = moe.MoEConfig(num_experts=experts, hidden=HIDDEN, intermediate=INTER, topk=2)
    want = np.asarray(shard_map(lambda i: jmoe.local_expert_recv_stats(i, c['cfg']),
                                mesh=_jax_mesh(d), in_specs=P('ep'), out_specs=P('ep'),
                                check_vma=False)(jnp.asarray(c['idx'])))
    got = _cpu_mesh(d).map(lambda i: moe.local_expert_recv_stats(i, cfg_t),
                           _shards(torch.from_numpy(c['idx']), d))
    assert torch.equal(torch.cat(got), torch.from_numpy(want.copy()))


def test_moe_drops_under_pressure():
    """Capacity pressure (JAX's test_moe_drops_under_pressure): routing
    skewed to expert 0 at capacity factor 0.35 drops pairs; the port drops
    the same count as JAX, matches its output, 'xla' and 'pallas' are
    bitwise the unfused path and 'fused' within 1e-5 of it."""
    d, experts = 4, 8
    kw = dict(capacity_factor=0.35, skew=True)
    want, want_dropped = _jax_ep_moe(d, experts, False, **kw)
    assert int(want_dropped.sum()) > 0
    unfused, dropped = _port_moe(d, experts, False, moe.ep_moe_forward, **kw)
    assert torch.equal(dropped, torch.from_numpy(want_dropped.copy()))
    assert calc_diff(unfused, want) < 1e-5
    for comm in ('xla', 'pallas', 'fused'):
        y, dr = _port_moe(d, experts, False, lambda *a, c=comm: mega.mega_moe_forward(
            *a, comm=c), **kw)
        assert torch.equal(dr, dropped), comm
        if comm == 'fused':
            assert calc_diff(y, unfused) < 1e-5
        else:
            assert torch.equal(y, unfused), comm


@pytest.mark.parametrize('d', [2, 4])
@pytest.mark.parametrize('fp8', [False, True])
def test_fused_dispatch_gemm_matches_jax(d, fp8):
    """#12's plain version: recv bitwise JAX's all-to-all of the slots, out
    against JAX's all-to-all plus its XLA expert GEMM (the f32 product of
    the dequantized tokens and weights)."""
    _dispatch_case(d, fp8, cap=16)


@pytest.mark.parametrize('fp8', [False, True])
def test_fused_dispatch_gemm_at_cap_18_matches_jax(fp8):
    """The same at cap 18, not a multiple of 8: a slab's rows are not whole
    8-row atoms in the kernel's row tiles."""
    _dispatch_case(2, fp8, cap=18)


def _dispatch_case(d, fp8, cap):
    rng = np.random.RandomState(10 + d)
    e_local, n = 2, 256
    xm = jnp.asarray(rng.randn(d * d * e_local * cap, HIDDEN), jnp.bfloat16)
    w = jnp.asarray(rng.randn(d * e_local, n, HIDDEN) * 0.05, jnp.bfloat16)
    if fp8:
        xq, xsf = dg.per_token_cast_to_fp8(xm, use_ue8m0=False)
        send = np.asarray(xq).reshape(d * d, e_local, cap, HIDDEN)
        send_sf = np.asarray(xsf).reshape(d * d, e_local, cap, -1)
        wq, wsf = _quant(w)
        x_f32 = np.asarray(xq, np.float32) * np.repeat(np.asarray(xsf), 128, axis=1)
        w_f32 = np.asarray(wq, np.float32) * np.repeat(np.repeat(wsf, 128, 1), 128, 2)
    else:
        send, send_sf = np.asarray(xm).reshape(d * d, e_local, cap, HIDDEN), None
        wq, wsf = np.asarray(w), None
        x_f32, w_f32 = np.asarray(xm, np.float32), np.asarray(w, np.float32)
    x_f32 = x_f32.reshape(d * d, e_local, cap, HIDDEN)

    def jfwd(xs, ws):
        recv = jax.lax.all_to_all(xs, 'ep', 0, 0, tiled=False)
        a = recv.transpose(1, 0, 2, 3).reshape(e_local, d * cap, HIDDEN)
        out = jnp.einsum('erk,enk->ern', a, ws).astype(jnp.bfloat16)
        return out.reshape(e_local, d, cap, n)[None], recv

    j_out, j_recv = shard_map(jfwd, mesh=_jax_mesh(d), check_vma=False,
                              in_specs=(P('ep'), P('ep')), out_specs=(P('ep'), P('ep')))(
        jnp.asarray(x_f32), jnp.asarray(w_f32))
    want_recv = np.asarray(shard_map(
        lambda xs: jax.lax.all_to_all(xs, 'ep', 0, 0, tiled=False), mesh=_jax_mesh(d),
        in_specs=P('ep'), out_specs=P('ep'), check_vma=False)(jnp.asarray(send)))
    sh = lambda a: [None] * d if a is None else _shards(_t(a), d)
    outs = _cpu_mesh(d).map(
        lambda s, ssf, ww, wwsf: tfm.fused_dispatch_gemm(s, ww, send_sf=ssf, w_sf=wwsf),
        sh(send), sh(send_sf), sh(wq), sh(wsf))
    assert_bitwise_equal(torch.cat([r for _, r in outs]), want_recv)
    got = torch.stack([o for o, _ in outs])
    assert tuple(got.shape) == (d, e_local, d, cap, n)
    assert calc_diff(got, np.asarray(j_out)) < 1e-5


def test_general_mega_kernel_contracts():
    """#14's contracts on its plain version: force_general at D = 1 bitwise
    the one-rank block; at D = 4 each rank's combine slabs bitwise the
    one-rank block run on the rows received; pools 1, 2 and 4 bitwise each
    other; packed weights pin their pool."""
    d, e_local, cap = 4, 2, 16
    g = torch.Generator().manual_seed(0)
    xm = (torch.randn(d * d * e_local * cap, HIDDEN, generator=g)).bfloat16()
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8
    xq, xsf = per_token_cast_to_fp8(xm, use_ue8m0=False)
    send = xq.view(d * d, e_local, cap, HIDDEN)
    send_sf = xsf.view(d * d, e_local, cap, -1)
    rw = torch.rand(d * d, e_local, cap, generator=g)
    w1 = (torch.randn(d * e_local, 2 * INTER, HIDDEN, generator=g) * 0.05).bfloat16()
    w2 = (torch.randn(d * e_local, HIDDEN, INTER, generator=g) * 0.05).bfloat16()
    (q1, s1), (q2, s2) = quantize_experts(w1), quantize_experts(w2)
    sh = lambda t: _shards(t, d)

    def run(pool, force=False, mesh=None, n=d):
        mesh = mesh or _cpu_mesh(n)
        return mesh.map(lambda s, ssf, r, a1, b1, a2, b2: tfm.fused_mega_moe(
            s, r, a1, a2, send_sf=ssf, w1_sf=b1, w2_sf=b2, pool=pool, force_general=force,
            act_fp8=True), *[list(t.chunk(n)) for t in (send[:n * n], send_sf[:n * n],
                                                        rw[:n * n], q1[:n * e_local],
                                                        s1[:n * e_local], q2[:n * e_local],
                                                        s2[:n * e_local])])

    one = run(0, force=True, n=1)[0]
    local = tfm.fused_mega_moe(send[:1], rw[:1], q1[:e_local], q2[:e_local],
                               send_sf=send_sf[:1], w1_sf=s1[:e_local], w2_sf=s2[:e_local],
                               act_fp8=True)
    assert torch.equal(one, local)
    pools = {p: run(p) for p in (1, 2, 4)}
    for p in (2, 4):
        for r in range(d):
            assert torch.equal(pools[p][r], pools[1][r])
    # rank r's combine slab from rank s = the block on the rows r sent to s
    for r in range(d):
        for s in range(d):
            rows = send[r * d + s]
            block = tfm.mega_local(rows, send_sf[r * d + s], rw[s * d + (s - r) % d],
                                   q1[s * e_local:(s + 1) * e_local],
                                   s1[s * e_local:(s + 1) * e_local],
                                   q2[s * e_local:(s + 1) * e_local],
                                   s2[s * e_local:(s + 1) * e_local], act_fp8=True)
            assert torch.equal(pools[1][r][s], block), (r, s)
    pk = tfm.pack_mega_weights(q1[:e_local], q2[:e_local], s1[:e_local], s2[:e_local], cap=cap,
                               num_devices=d)
    assert pk.pool == tfm.pick_wave_pool(d, cap, HIDDEN, INTER, xb=1, wb=1, scaled=True,
                                         act_fp8=pk.act_fp8)
    with pytest.raises(ValueError, match='cap'):
        tfm.pack_mega_weights(q1[:e_local], q2[:e_local], s1[:e_local], s2[:e_local],
                              num_devices=d)


def test_mega_heuristics_match_jax(monkeypatch):
    """pick_wave_pool, pick_mega_tiles(pool) and get_mega_moe_config: JAX's
    rules at the DeepSeek-V3 shapes (H 7168, I 2048; cap 40 and 128; 8
    ranks); the config on an arch row with the JAX chip's numbers equal to
    JAX's, and on the H100's row its own."""
    h, i = 7168, 2048
    for cap in (40, 128):
        for scaled, xb in ((True, 1), (False, 2)):
            for act_fp8 in (False, True):
                kw = dict(xb=xb, wb=xb, scaled=scaled, act_fp8=act_fp8)
                assert tfm.pick_wave_pool(8, cap, h, i, **kw) == \
                    jfm.pick_wave_pool(8, cap, h, i, **kw)
                for pool in (1, 2, 4):
                    assert tfm.pick_mega_tiles(h, i, cap, pool=pool, **kw) == \
                        jfm.pick_mega_tiles(h, i, cap, pool=pool, **kw)
    monkeypatch.setenv('DGT_MEGA_POOL', '2')
    assert tfm.pick_wave_pool(8, 128, h, i, xb=1, wb=1, scaled=True) == \
        jfm.pick_wave_pool(8, 128, h, i, xb=1, wb=1, scaled=True) == 2
    v5e = jarch.get_arch('v5e')
    like = ArchSpec(name='v5e', num_sms=1, smem_per_block=0, l2_bytes=0,
                    hbm_bytes_per_s=v5e.hbm_gbps * 1e9, bf16_flops=v5e.bf16_tflops * 1e12,
                    fp8_flops=v5e.bf16_tflops * 1e12, tf32_flops=0.0, fp4_decode_tflops=0.0,
                    link_bytes_per_s=jhmega._ICI_GBPS['v5e'] * 1e9)
    for tokens, cap in ((128, 40), (4096, 1032), (16, 8)):
        for fp8 in (True, False):
            args = (tokens, h, i, 256, 8, 8, cap)
            assert dataclasses.asdict(thmega.get_mega_moe_config(*args, use_fp8=fp8, arch=like)) \
                == dataclasses.asdict(jhmega.get_mega_moe_config(*args, use_fp8=fp8, arch=v5e))
    cfg = thmega.get_mega_moe_config(128, h, i, 256, 8, 8, 40, arch=H100_SXM)
    assert 1 <= cfg.num_chunks <= 40 // 16 and cfg.chunk_rows * cfg.num_chunks >= 40


# ---- the model over a mesh ------------------------------------------------------

_MODEL = dict(vocab=128, hidden=128, num_layers=2, num_heads=2, head_dim=64, num_experts=8,
              topk=2, moe_intermediate=128, capacity_factor=8.0)


@functools.lru_cache(maxsize=None)
def _model_case():
    params_np = jax.tree.map(np.asarray, jt.init_params(jt.ModelConfig(**_MODEL)))
    tokens = np.random.RandomState(4).randint(0, _MODEL['vocab'], (4, 16)).astype(np.int32)
    mesh = jdist.make_mesh([('dp', 1), ('ep', 4)], jax.devices()[:4])
    want = np.asarray(jt.forward(jax.tree.map(jnp.asarray, params_np), jnp.asarray(tokens),
                                 jt.ModelConfig(**_MODEL, use_kernels=False), mesh))
    return params_np, tokens, want


@pytest.mark.parametrize('comm', [None, 'xla', 'pallas', 'fused'])
def test_forward_over_a_mesh_matches_jax(comm):
    """The 2-layer model over a ('dp', 1) x ('ep', 4) mesh against JAX's
    forward over the same mesh (its XLA MoE path), at the tolerance of
    tests/test_torch_model.py; 'pallas' bitwise 'xla'; the experts cut ahead
    of time (shard_experts) give the same bits as cut in the call."""
    params_np, tokens, want = _model_case()
    params = params_from_jax(params_np, device='cpu')
    mesh = dist.make_mesh([('dp', 1), ('ep', 4)], ['cpu'] * 4)
    extra = {} if comm is None else dict(use_mega=True, mega_comm=comm, mega_chunks=2)
    cfg = tt.ModelConfig(**_MODEL, use_kernels=True, **extra)
    logits = tt.forward(params, torch.from_numpy(tokens), cfg, mesh)
    assert torch.isfinite(logits).all() and tuple(logits.shape) == (4, 16, _MODEL['vocab'])
    assert calc_diff(logits, want) < 1e-5
    again = tt.forward(shard_experts(params, mesh), torch.from_numpy(tokens), cfg, mesh)
    assert torch.equal(logits, again)
    if comm == 'pallas':
        xla = tt.forward(params, torch.from_numpy(tokens),
                         tt.ModelConfig(**_MODEL, use_kernels=True, use_mega=True,
                                        mega_comm='xla', mega_chunks=2), mesh)
        assert torch.equal(logits, xla)


def test_mesh_entry_points_refuse_what_they_do_not_take():
    c = _moe_case(2, 8)
    cfg = moe.MoEConfig(num_experts=8, hidden=HIDDEN, intermediate=INTER, topk=2)
    x = _t(c['x'])[:TOKENS]
    with pytest.raises(ValueError, match='Mesh.map'):
        mega.mega_moe_forward(x, torch.from_numpy(c['idx'][:TOKENS]),
                              torch.from_numpy(c['tw'][:TOKENS]), _t(c['w1']), None,
                              _t(c['w2']), None, cfg, comm='pallas')
    with pytest.raises(ValueError, match='slabs'):
        tfm.fused_mega_moe(torch.zeros(2, 1, 8, HIDDEN, dtype=torch.bfloat16),
                           torch.zeros(2, 1, 8), _t(c['w1'])[:1], _t(c['w2'])[:1])
    assert mega.SymmBuffer(2, 8, HIDDEN, INTER, TOKENS, 2).rendezvous().symm is None
