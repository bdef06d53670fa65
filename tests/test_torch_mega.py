"""The port's mega MoE at one rank (deepgemm_tpu_torch/kernels/fused_moe.py,
parallel/mega.py) against the JAX package's on the same
numpy inputs, and its own contracts. JAX runs on one CPU device, its fused
kernel in Pallas interpret mode inside a one-device shard_map; every mesh
here has one device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import deepgemm_tpu as dg
from deepgemm_tpu.kernels import fused_moe as jfm
from deepgemm_tpu.parallel import mega as jmega
from deepgemm_tpu.parallel.dist import make_mesh
from deepgemm_tpu.utils import math as jmath
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.kernels import fused_moe as tfm
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.parallel import mega as tmega
from deepgemm_tpu_torch.parallel.moe import (MoEConfig, ep_dispatch_indices, ep_moe_forward,
                                              local_expert_recv_stats, moe_capacity,
                                              swiglu_apply_weight_to_fp8)
from deepgemm_tpu_torch.testing import assert_bitwise_equal, calc_diff
from deepgemm_tpu_torch.utils.math import quantize_experts

# (scaled, w_fp4, act_fp8) of the kernel's five instances
MODES = {'bf16': (False, False, False), 'fp8': (True, False, False),
         'fp8_act_fp8': (True, False, True), 'fp4': (True, True, False),
         'fp4_act_fp8': (True, True, True)}


@pytest.fixture(autouse=True)
def _no_mega_env(monkeypatch):
    monkeypatch.delenv('DGT_MEGA_ACT_FP8', raising=False)


def _t(a):
    """numpy (or JAX) array -> CPU torch tensor, bytes unchanged."""
    return tensor_from_numpy(np.asarray(a), 'cpu')


def _quant_fp4(w):
    """Per-128x128-block e2m1 codes of w [E, n, k] in the planar-128 int8
    layout, with their f32 scales, by the JAX package's own helpers."""
    e, n, k = w.shape
    wf = np.asarray(w, np.float32).reshape(e, n // 128, 128, k // 128, 128)
    sf = np.clip(np.abs(wf).max(axis=(2, 4)), 1e-4, None) / 6.0
    codes = jmath._quantize_to_fp4_e2m1(jnp.asarray((wf / sf[:, :, None, :, None]).reshape(e, n, k)))
    return np.asarray(jmath.pack_fp4_planar(codes.astype(jnp.int32))), sf.astype(np.float32)


def _block_inputs(seed, e_local, cap, hidden, inter, mode):
    """Numpy inputs of one fused call in ``mode``: (x, xsf, rw, w1, w1_sf,
    w2, w2_sf); x is bf16 (unscaled) or e4m3 with per-token scales."""
    scaled, w_fp4, _ = MODES[mode]
    rng = np.random.RandomState(seed)
    xm = jnp.asarray(rng.randn(e_local * cap, hidden) * 0.5, jnp.bfloat16)
    rw = rng.rand(e_local, cap).astype(np.float32)
    w1 = jnp.asarray(rng.randn(e_local, 2 * inter, hidden) * 0.05, jnp.bfloat16)
    w2 = jnp.asarray(rng.randn(e_local, hidden, inter) * 0.05, jnp.bfloat16)
    if not scaled:
        return np.asarray(xm).reshape(e_local, cap, hidden), None, rw, np.asarray(w1), None, \
            np.asarray(w2), None
    xq, xsf = dg.per_token_cast_to_fp8(xm, use_ue8m0=False)
    x = np.asarray(xq).reshape(e_local, cap, hidden)
    xsf = np.asarray(xsf).reshape(e_local, cap, -1)
    if w_fp4:
        (w1q, w1sf), (w2q, w2sf) = _quant_fp4(w1), _quant_fp4(w2)
    else:
        (w1q, w1sf), (w2q, w2sf) = (
            tuple(np.asarray(v) for v in jax.vmap(lambda m: dg.per_block_cast_to_fp8(
                m, use_ue8m0=False))(w)) for w in (w1, w2))
    return x, xsf, rw, w1q, w1sf, w2q, w2sf


def _jax_fused(inputs, mode, cap, block):
    x, xsf, rw, w1, w1sf, w2, w2sf = (None if a is None else jnp.asarray(a) for a in inputs)
    scaled, w_fp4, act_fp8 = MODES[mode]
    mesh = make_mesh([('ep', 1)], jax.devices()[:1])
    kw = dict(block_n=block, block_h=block)
    if w_fp4:
        pk = jfm.pack_mega_weights(w1, w2, w1sf, w2sf, cap=cap, x_dtype=jnp.float8_e4m3fn,
                                   w_packed_fp4=True, act_fp8=act_fp8, **kw)
        fn = lambda s, ss, r: jfm.fused_mega_moe(s, r, None, None, 'ep', send_sf=ss, packed=pk)
    elif scaled:
        fn = lambda s, ss, r: jfm.fused_mega_moe(s, r, w1, w2, 'ep', send_sf=ss, w1_sf=w1sf,
                                                 w2_sf=w2sf, act_fp8=act_fp8, **kw)
    else:
        fn = lambda s, ss, r: jfm.fused_mega_moe(s, r, w1, w2, 'ep', **kw)
    xsf = xsf[None] if scaled else jnp.zeros((1,), jnp.float32)
    return np.asarray(shard_map(fn, mesh=mesh, check_vma=False, in_specs=(P(),) * 3,
                                out_specs=P())(x[None], xsf, rw[None]))


def _port_fused(inputs, mode, cap):
    x, xsf, rw, w1, w1sf, w2, w2sf = (None if a is None else _t(a) for a in inputs)
    scaled, w_fp4, act_fp8 = MODES[mode]
    if w_fp4:
        pk = tfm.pack_mega_weights(w1, w2, w1sf, w2sf, w_packed_fp4=True, act_fp8=act_fp8)
        return tfm.fused_mega_moe(x[None], rw[None], send_sf=xsf[None], packed=pk)
    return tfm.fused_mega_moe(x[None], rw[None], w1, w2, send_sf=None if xsf is None else xsf[None],
                              w1_sf=w1sf, w2_sf=w2sf, act_fp8=act_fp8)


def _jax_eager_act_fp8(inputs, mode):
    """The act-fp8 block composed eagerly from the JAX package's own pieces:
    ``_promote_dot`` for L1 and L2 (FP4 chunks through
    ``_decode_fp4_chunk``), then ``swiglu_apply_weight_to_fp8`` on the bf16
    gate|up, the unfused dataflow the kernel's act-fp8 epilogue mirrors."""
    from deepgemm_tpu.parallel.moe import swiglu_apply_weight_to_fp8 as jswiglu8
    x, xsf, rw, w1, w1sf, w2, w2sf = (jnp.asarray(a) for a in inputs)
    w_fp4 = MODES[mode][1]
    rows = lambda sf, n: jnp.repeat(sf, 128, axis=0)[:n].T       # [n/128, k/128] -> [ksf, n]
    out = []
    for e in range(x.shape[0]):
        gu = jfm._promote_dot(x[e], w1[e], lambda c: xsf[e][:, c:c + 1],
                              rows(w1sf[e], w1.shape[1]), 128, w_fp4=w_fp4)
        q, qsf = jswiglu8(gu.astype(jnp.bfloat16), rw[e])
        y = jfm._promote_dot(q, w2[e], lambda c: qsf[:, c:c + 1], rows(w2sf[e], w2.shape[1]),
                             128, w_fp4=w_fp4)
        out.append(y.astype(jnp.bfloat16))
    return np.asarray(jnp.stack(out))[None]


# cap 16 at JAX's own tiles; cap 32 with JAX's 128-wide tiles, nt1 = nt2 = 2
# (the port's tiles are 128 wide, so nt1 = nt2 = 2 in both)
@pytest.mark.parametrize('cap,block', [(16, 0), (32, 128)])
@pytest.mark.parametrize('mode', list(MODES))
def test_fused_block_matches_jax(mode, cap, block):
    """Against JAX's D=1 fused kernel at 1e-5. In the act-fp8 modes JAX's
    interpret-mode kernel is itself ~3e-5 from the same arithmetic composed
    eagerly from its own functions (a bf16 or fp8 quantum of act flips, an
    amplified last-bit difference), so there the port is held at 1e-5 to
    that eager composition and to the kernel at JAX's fused-vs-unfused
    act-fp8 limit, 1e-4 (tests/test_mega_moe.py:252-257)."""
    inputs = _block_inputs(3, 2, cap, 256, 256, mode)
    want = _jax_fused(inputs, mode, cap, block)
    launched = dict(tfm.launches)
    got = _port_fused(inputs, mode, cap)
    assert tfm.launches == launched            # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 2, cap, 256)
    if MODES[mode][2]:
        assert calc_diff(got, _jax_eager_act_fp8(inputs, mode)) < 1e-5
        assert calc_diff(got, want) < 1e-4
    else:
        assert calc_diff(got, want) < 1e-5


@pytest.mark.parametrize('act_fp8', [False, True])
def test_fp4_is_bitwise_the_predecoded_fp8(act_fp8):
    """e2m1 values are e4m3 values and 0x8 decodes to +0, so the FP4
    instance is the fp8 one fed the decoded weights, bit for bit."""
    x, xsf, rw, w1, w1sf, w2, w2sf = (None if a is None else _t(a) for a in
                                      _block_inputs(4, 2, 24, 256, 256, 'fp4'))
    kw = dict(act_fp8=act_fp8, silu_tanh=not act_fp8)
    y4 = tfm.mega_local(x, xsf, rw, w1, w1sf, w2, w2sf, w_fp4=True, **kw)
    y8 = tfm.mega_local(x, xsf, rw, tfm.decode_fp4_planar(w1), w1sf,
                        tfm.decode_fp4_planar(w2), w2sf, **kw)
    assert_bitwise_equal(y4, y8)
    assert torch.equal(tfm.decode_fp4_planar(w1).float(),
                       _t(jmath._dequantize_from_fp4_e2m1(
                           jmath.unpack_fp4_planar(jnp.asarray(np.asarray(w1))))))


@pytest.mark.parametrize('mode', ['bf16', 'fp8', 'fp8_act_fp8'])
def test_packed_is_bitwise_the_raw_call(mode):
    x, xsf, rw, w1, w1sf, w2, w2sf = (None if a is None else _t(a) for a in
                                      _block_inputs(5, 2, 16, 256, 128, mode))
    act_fp8 = MODES[mode][2]
    raw = tfm.fused_mega_moe(x[None], rw[None], w1, w2, send_sf=None if xsf is None else xsf[None],
                             w1_sf=w1sf, w2_sf=w2sf, act_fp8=act_fp8)
    pk = tfm.pack_mega_weights(w1, w2, w1sf, w2sf, act_fp8=act_fp8)
    packed = tfm.fused_mega_moe(x[None], rw[None], send_sf=None if xsf is None else xsf[None],
                                packed=pk)
    assert_bitwise_equal(packed, raw)


@pytest.mark.parametrize('hidden,inter,scaled', [
    (7168, 640, True), (7168, 1152, True), (7168, 2048, True), (6144, 1920, False),
    (7168, 640, False), (4096, 768, False), (6144, 32768, False), (7168, 64640, True)])
def test_tile_chooser_divisor_contract(hidden, inter, scaled):
    """tests/test_mega_moe.py's divisor contract, on the H100's shared
    memory: the widths the kernel takes are those its one 128-wide tile
    divides (bn1 = bh2 = 128, a multiple of gran_k 128 when scaled)."""
    tfm.check_shape(hidden, inter)
    assert inter % tfm.TILE == 0 and hidden % tfm.TILE == 0
    if scaled:
        assert tfm.TILE % tfm.GRAN_K == 0
    assert tfm.smem_bytes(inter) <= 232448


def test_tile_chooser_refusals():
    with pytest.raises(ValueError, match='multiples of 128'):
        tfm.check_shape(7168, 1000)
    with pytest.raises(ValueError, match='multiples of 256'):
        tfm.check_shape(7168, 384, w_fp4=True)
    with pytest.raises(ValueError, match='shared memory'):
        tfm.check_shape(7168, 64768)
    tfm.check_shape(7168, 4096)
    tfm.check_shape(7168, 2048, w_fp4=True)
    x = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    w1 = torch.zeros(2, 2 * 1000, 128, dtype=torch.bfloat16)
    w2 = torch.zeros(2, 128, 1000, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='multiples of 128'):
        tfm.fused_mega_moe(x, torch.zeros(1, 2, 8), w1, w2)


@pytest.mark.parametrize('d,cap', [(1, 40), (1, 100), (8, 40), (4, 37), (2, 61)])
def test_kernel_items_cover_each_live_row_once(d, cap):
    """The kernels' items: the one-rank kernel's tiles of ROWS slot rows,
    and the general kernel's (tfm.live_rows, read by csrc/mega_ep.cu's
    EpRows) tiles of ROWS of each local expert's received rows of nonzero
    weight in step order (row q: step q // cap, slot q % cap), which cover
    each such (step, slot) once and no other; JAX's wave pool for the shape
    is the port's, and the pool moves no item."""
    e_local = 3
    rng = np.random.RandomState(d * 100 + cap)
    rw = rng.rand(d, e_local, cap).astype(np.float32)
    rw[rng.rand(d, e_local, cap) < 0.6] = 0
    order, counts, prefix = tfm.live_rows(torch.from_numpy(rw))
    assert tfm.items(e_local, cap) == e_local * -(-cap // tfm.ROWS)
    assert prefix[0] == 0 and prefix[-1] == sum(-(-int(c) // tfm.ROWS) for c in counts)
    for e in range(e_local):
        live = [divmod(int(q), cap) for q in order[e, :counts[e]]]
        assert live == sorted(live) == [(s, j) for s in range(d) for j in range(cap)
                                        if rw[s, e, j] != 0]
        assert sorted(order[e].tolist()) == list(range(d * cap))
        tiles = int(prefix[e + 1] - prefix[e])
        assert tiles == -(-int(counts[e]) // tfm.ROWS)
    kw = dict(xb=1, wb=1, scaled=True, act_fp8=False)
    assert tfm.pick_wave_pool(d, cap, 7168, 2048, **kw) == \
        jfm.pick_wave_pool(d, cap, 7168, 2048, **kw)


@pytest.mark.parametrize('num_chunks', [0, -1])
def test_bad_num_chunks_raise(num_chunks):
    cfg = MoEConfig(num_experts=4, hidden=128, intermediate=128, topk=2)
    x, idx, w, w1, w2 = _moe_inputs(1, 16, cfg)
    for comm in ('xla', 'fused'):
        with pytest.raises(ValueError, match='num_chunks'):
            tmega.mega_moe_forward(x, idx, w, w1, None, w2, None, cfg, comm=comm,
                                   num_chunks=num_chunks)


def test_symm_buffer_and_sizing_match_jax():
    args = dict(num_ranks=8, num_experts=64, hidden=1024, intermediate=512,
                num_max_tokens_per_rank=512, topk=4)
    for use_fp8 in (True, False):
        assert tmega.get_symm_buffer_size_for_mega_moe(**args, use_fp8=use_fp8) == \
            jmega.get_symm_buffer_size_for_mega_moe(**args, use_fp8=use_fp8)
    buf = dgt.get_symm_buffer_for_mega_moe(**args)
    assert buf.rendezvous() is buf and buf.size == jmega.SymmBuffer(**args).size
    assert dgt.get_token_alignment_for_mega_moe() == jmega.get_token_alignment_for_mega_moe()
    assert dgt.get_ring_limit_for_mega_moe(8, 128) == jmega.get_ring_limit_for_mega_moe(8, 128)


@pytest.mark.parametrize('g,with_sf', [(8, False), (128, True), (None, True)])
def test_transform_weights_matches_jax(g, with_sf):
    rng = np.random.RandomState(3)
    w1 = np.asarray(jnp.asarray(rng.randn(2, 512, 64), jnp.bfloat16))
    sf = rng.rand(2, 4, 1).astype(np.float32) if with_sf else None
    jw, jsf = jmega.transform_weights_for_mega_moe(
        jnp.asarray(w1), None if sf is None else jnp.asarray(sf), gate_up_interleave=g)
    tw, tsf = dgt.transform_weights_for_mega_moe(_t(w1), None if sf is None else _t(sf),
                                                 gate_up_interleave=g)
    assert_bitwise_equal(tw, np.asarray(jw))
    if with_sf:
        assert_bitwise_equal(tsf, np.asarray(jsf))


def _moe_inputs(seed, t_total, cfg, skew=False):
    """tests/test_moe_parallel.py:make_moe_inputs, as torch CPU tensors."""
    rng = np.random.RandomState(seed)
    h, e = cfg.hidden, cfg.num_experts
    x = np.asarray(jnp.asarray(rng.randn(t_total, h), jnp.bfloat16))
    idx = np.argsort(-rng.randn(t_total, e), axis=1)[:, :cfg.topk].astype(np.int32)
    if skew:
        idx[:, 0] = 0
    w = rng.uniform(0.5, 1.5, size=(t_total, cfg.topk)).astype(np.float32)
    w1 = np.asarray(jnp.asarray(rng.randn(e, 2 * cfg.intermediate, h) * 0.05, jnp.bfloat16))
    w2 = np.asarray(jnp.asarray(rng.randn(e, h, cfg.intermediate) * 0.05, jnp.bfloat16))
    return tuple(_t(a) for a in (x, idx, w, w1, w2))


def _weights(w1, w2, use_fp8):
    if not use_fp8:
        return w1, None, w2, None
    return (*quantize_experts(w1), *quantize_experts(w2))


@pytest.mark.parametrize('use_fp8', [False, True])
@pytest.mark.parametrize('num_chunks', [1, 2, 3])
def test_xla_comm_is_bitwise_unfused(use_fp8, num_chunks):
    cfg = MoEConfig(num_experts=8, hidden=128, intermediate=128, topk=2,
                    capacity_factor=8.0, use_fp8=use_fp8, use_kernels=True)
    x, idx, w, w1, w2 = _moe_inputs(2, 64, cfg)
    ws = _weights(w1, w2, use_fp8)
    y_ref, d_ref = ep_moe_forward(x, idx, w, *ws, cfg)
    y, d = tmega.mega_moe_forward(x, idx, w, *ws, cfg, num_chunks=num_chunks)
    assert_bitwise_equal(y, y_ref)
    assert_bitwise_equal(d, d_ref)


@pytest.mark.parametrize('use_fp8', [False, True])
def test_drops_under_pressure(use_fp8):
    """tests/test_mega_moe.py:363-414 at one rank: with routing skewed to
    expert 0 and capacity factor 0.35 pairs drop; 'xla' stays bitwise the
    unfused path, 'fused' drops the same pairs (bitwise in bf16, within the
    act quantization the fused path skips in fp8), and the dropped pairs
    contribute nothing."""
    cfg = MoEConfig(num_experts=8, hidden=128, intermediate=128, topk=2,
                    capacity_factor=0.35, use_fp8=use_fp8, use_kernels=True)
    x, idx, w, w1, w2 = _moe_inputs(21, 64, cfg, skew=True)
    ws = _weights(w1, w2, use_fp8)
    y_ref, d_ref = ep_moe_forward(x, idx, w, *ws, cfg)
    assert int(d_ref) > 0, 'the fixture must drop pairs'
    y_xla, d_xla = dgt.fp8_fp4_mega_moe(x, idx, w, *ws, cfg) if use_fp8 else \
        dgt.bf16_mega_moe(x, idx, w, ws[0], ws[2], cfg)
    assert_bitwise_equal(y_xla, y_ref)
    assert_bitwise_equal(d_xla, d_ref)
    y_f, d_f = tmega.mega_moe_forward(x, idx, w, *ws, cfg, comm='fused')
    assert_bitwise_equal(d_f, d_ref)
    if use_fp8:
        assert calc_diff(y_f, y_ref) < 1e-3
    else:
        assert_bitwise_equal(y_f, y_ref)
    # the dropped pairs' tokens: the unfused block on the kept pairs alone
    cap = moe_capacity(64, 2, 8, 0.35)
    _, _, _, kept, _ = ep_dispatch_indices(idx, 8, 8, cap)
    w_kept = torch.where(kept.view(64, 2), w, torch.zeros_like(w))
    y_kept, _ = ep_moe_forward(x, idx, w_kept, *ws, cfg)
    assert_bitwise_equal(y_ref, y_kept)


def test_fused_fp8_against_unfused_within_jax_limits(monkeypatch):
    """tests/test_mega_moe.py:252-257: fused against unfused within 1e-4
    with fp8 act and 1e-3 with bf16 act."""
    cfg = MoEConfig(num_experts=8, hidden=128, intermediate=128, topk=2,
                    capacity_factor=8.0, use_fp8=True, use_kernels=True)
    x, idx, w, w1, w2 = _moe_inputs(7, 64, cfg)
    ws = _weights(w1, w2, True)
    y_ref, _ = ep_moe_forward(x, idx, w, *ws, cfg)
    for env, limit in (('1', 1e-4), ('0', 1e-3)):
        monkeypatch.setenv('DGT_MEGA_ACT_FP8', env)
        y, _ = tmega.mega_moe_forward(x, idx, w, *ws, cfg, comm='fused')
        assert calc_diff(y, y_ref) < limit, env


def test_moe_helpers():
    cfg = MoEConfig(num_experts=8, hidden=128, intermediate=128, topk=2)
    _, idx, w, _, _ = _moe_inputs(1, 32, cfg)
    counts = local_expert_recv_stats(idx, cfg)
    assert counts.dtype == torch.int32 and int(counts.sum()) == idx.numel()
    assert torch.equal(counts, torch.bincount(idx.reshape(-1).long(), minlength=8).int())
    rank, local, *_ = ep_dispatch_indices(idx, 8, 8, 16)
    assert not rank.any() and torch.equal(local, idx.reshape(-1).long())
    gate_up = torch.randn(3, 4, 256).to(torch.bfloat16)
    rw = torch.rand(3, 4)
    q, sf = swiglu_apply_weight_to_fp8(gate_up, rw)
    jq, jsf = dg.parallel.moe.swiglu_apply_weight_to_fp8(
        jnp.asarray(gate_up.float().numpy()).astype(jnp.bfloat16), jnp.asarray(rw.numpy()))
    assert_bitwise_equal(q, np.asarray(jq))
    assert_bitwise_equal(sf, np.asarray(jsf))


def test_multi_gpu_paths_raise():
    """The several-rank paths, called outside a mesh, raise for what they
    lack: 'pallas' a mesh, a send of two slabs its ranks, a pool that does
    not divide the ranks, a pack for two ranks its slot capacity. (Inside a
    mesh they run: tests/test_torch_parallel.py.) force_general at one rank
    runs the general kernel's plain version, the one-rank block's bits."""
    cfg = MoEConfig(num_experts=4, hidden=128, intermediate=128, topk=2)
    x, idx, w, w1, w2 = _moe_inputs(1, 16, cfg)
    with pytest.raises(ValueError, match='Mesh.map'):
        tmega.mega_moe_forward(x, idx, w, w1, None, w2, None, cfg, comm='pallas')
    g = torch.Generator().manual_seed(0)
    send = torch.randn((2, 4, 8, 128), generator=g).bfloat16()
    rw = torch.rand((2, 4, 8), generator=g)
    with pytest.raises(ValueError, match='2 slabs for 1 ranks'):
        tfm.fused_mega_moe(send, rw, w1, w2)
    with pytest.raises(ValueError, match='divisor'):
        tfm.fused_mega_moe(send[:1], rw[:1], w1, w2, pool=2)
    with pytest.raises(ValueError, match='cap'):
        tfm.pack_mega_weights(w1, w2, num_devices=2)
    assert torch.equal(tfm.fused_mega_moe(send[:1], rw[:1], w1, w2, force_general=True),
                       tfm.fused_mega_moe(send[:1], rw[:1], w1, w2))


@pytest.mark.parametrize('mode', list(MODES))
def test_silu_and_act_policy(mode, monkeypatch):
    """The act type: ``DGT_MEGA_ACT_FP8`` wins over the argument, bf16 by
    default. silu's form is the instance's, as in JAX's ``_l1_epilogue``:
    tanh with bf16 act (the scaled act-bf16 instances), exp otherwise."""
    assert tfm.resolve_act_fp8() is False and tfm.resolve_act_fp8(True) is True
    monkeypatch.setenv('DGT_MEGA_ACT_FP8', '1')
    assert tfm.resolve_act_fp8(False) is True
    monkeypatch.delenv('DGT_MEGA_ACT_FP8')
    scaled, w_fp4, act_fp8 = MODES[mode]
    x, xsf, rw, w1, w1sf, w2, w2sf = (None if a is None else _t(a) for a in
                                      _block_inputs(6, 2, 16, 256, 256, mode))
    pk = tfm.pack_mega_weights(w1, w2, w1sf, w2sf, w_packed_fp4=w_fp4, act_fp8=act_fp8)
    got = tfm.fused_mega_moe(x[None], rw[None], send_sf=None if xsf is None else xsf[None],
                             packed=pk)[0]
    tanh = scaled and not act_fp8
    kw = dict(w_fp4=w_fp4, act_fp8=act_fp8)
    assert_bitwise_equal(got, tfm.mega_local(x, xsf, rw, w1, w1sf, w2, w2sf, silu_tanh=tanh, **kw))
