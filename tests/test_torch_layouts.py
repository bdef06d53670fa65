"""The rest of the port's one-card GEMM surface against the JAX package on the
same numpy inputs: the dense NN/TN/TT layouts, C accumulation, packed-UE8M0
scales ('dequant', and 'promote' when pinned), the planar FP4 B routes, FP4
at scale granularities of 32 and 64, the NN contiguous grouped GEMM, the
flattened NT k-grouped GEMM, the scale transforms, the runtime knobs and the
FP4 in-kernel policy. The port runs its kernels' plain versions (CPU
tensors); JAX runs its Pallas kernels in interpret mode, eagerly. Limits:
calc_diff < 1e-5 against JAX (the two sum in other orders), bitwise within
the port where its routes compute the same function."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import deepgemm_tpu as dg
import deepgemm_tpu_torch as dgt
from deepgemm_tpu.runtime.config import runtime as jax_runtime
from deepgemm_tpu.utils.math import pack_ue8m0_to_int as jax_pack_ue8m0
from deepgemm_tpu_torch.heuristics.arch import H100_SXM, detect_arch, fp4_inkernel_profitable
from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.ops import sf_layout
from deepgemm_tpu_torch.runtime.config import runtime as port_runtime
from deepgemm_tpu_torch.testing import calc_diff

from generators import generate_k_grouped_contiguous, generate_m_grouped_contiguous

M, N, K = 128, 256, 384           # JAX's dense test shape (tests/test_gemm_dense.py)


def _t(x):
    return tensor_from_numpy(np.asarray(x), 'cpu')


def _pair(p):
    return tuple(_t(v) for v in p)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bf16(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return jnp.asarray((rng.randn(*shape) * scale).astype(ml_dtypes.bfloat16))


def _fp8_nt(seed=0, m=M, n=N, k=K, b_per_token=False, **cast):
    a, b = _bf16((m, k), seed), _bf16((n, k), seed + 1)
    a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=False, **cast)
    b_q = (dg.per_token_cast_to_fp8 if b_per_token else dg.per_block_cast_to_fp8)(
        b, use_ue8m0=False, **cast)
    return a_q, b_q


def _layout_args(name, a_q, b_q):
    """JAX's layout plumbing (tests/test_gemm_dense.py:52-66): each operand
    and its scales transposed where the layout says."""
    tr = lambda p: (p[0].T, p[1].T)
    return {'nt': (a_q, b_q), 'nn': (a_q, tr(b_q)), 'tn': (tr(a_q), tr(b_q)),
            'tt': (tr(a_q), b_q)}[name]


@pytest.mark.parametrize('layout', ['nn', 'tn', 'tt'])
def test_fp8_layouts_match_jax_and_nt(layout):
    """Each layout against JAX's, and against the port's NT call on the same
    operands transposed back (the kernels are bitwise so on the card)."""
    a_q, b_q = _fp8_nt()
    a_l, b_l = _layout_args(layout, a_q, b_q)
    d_jax = getattr(dg, f'fp8_gemm_{layout}')(a_l, b_l, disable_ue8m0_cast=True)
    dense.launches = 0
    d_port = getattr(dgt, f'fp8_gemm_{layout}')(_pair(a_l), _pair(b_l))
    assert dense.launches == 0 and d_port.dtype == torch.bfloat16
    assert calc_diff(d_port, _f32(d_jax)) < 1e-5
    assert torch.equal(d_port, dgt.fp8_gemm_nt(_pair(a_q), _pair(b_q)))


@pytest.mark.parametrize('layout', ['nt', 'nn', 'tn', 'tt'])
def test_bf16_layouts_match_jax(layout):
    a, b = _bf16((M, K), 2), _bf16((N, K), 3)
    args = {'nt': (a, b), 'nn': (a, b.T), 'tn': (a.T, b.T), 'tt': (a.T, b)}[layout]
    d_jax = getattr(dg, f'bf16_gemm_{layout}')(*args)
    d_port = getattr(dgt, f'bf16_gemm_{layout}')(*map(_t, args))
    assert calc_diff(d_port, _f32(d_jax)) < 1e-5
    lt = getattr(dgt, f'cublaslt_gemm_{layout}')(*map(_t, args))
    assert calc_diff(lt, _f32(getattr(dg, f'cublaslt_gemm_{layout}')(*args))) < 1e-5


@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
def test_c_accumulation_matches_jax(out_dtype):
    """c added once to the finished f32 sum (JAX's dense epilogue), into a
    bf16 or an f32 output; the same with bf16 operands (XLA's dot)."""
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32
    a_q, b_q = _fp8_nt(4)
    c = jnp.asarray(np.random.RandomState(5).randn(M, N).astype(np.float32) * 32).astype(jdt)
    d_jax = dg.fp8_gemm_nt(a_q, b_q, d=jnp.zeros((), jdt), c=c)
    d_port = dgt.fp8_gemm_nt(_pair(a_q), _pair(b_q), d=out_dtype, c=_t(c))
    assert d_port.dtype == out_dtype and calc_diff(d_port, _f32(d_jax)) < 1e-5
    a, b = _bf16((M, K), 6), _bf16((N, K), 7)
    d_jax = dg.bf16_gemm_nt(a, b, d=jnp.zeros((), jdt), c=c)
    d_port = dgt.bf16_gemm_nt(_t(a), _t(b), d=out_dtype, c=_t(c))
    assert d_port.dtype == out_dtype and calc_diff(d_port, _f32(d_jax)) < 1e-5


def test_wgrad_recipe_with_c_matches_jax():
    """Per-token scales on both operands (recipe (1, 1, 128)) with d = c = an
    f32 accumulator (tests/test_gemm_dense.py:73-83)."""
    a_q, b_q = _fp8_nt(8, b_per_token=True)
    c = np.random.RandomState(9).randn(M, N).astype(np.float32) * 32
    d_jax = dg.fp8_gemm_nt(a_q, b_q, d=jnp.asarray(c), c=jnp.asarray(c), recipe=(1, 1, 128))
    c_t = _t(c)
    d_port = dgt.fp8_gemm_nt(_pair(a_q), _pair(b_q), d=c_t, c=c_t, recipe=(1, 1, 128))
    assert d_port.dtype == torch.float32 and calc_diff(d_port, _f32(d_jax)) < 1e-5


def _packed(recipe, layout='nt', seed=10):
    """Power-of-two cast operands (UE8M0) with their scales packed 4 a word
    along k, in ``layout``: MN-major scales packed along their leading dim."""
    m, n, k = 128, 256, 512
    a, b = _bf16((m, k), seed), _bf16((n, k), seed + 1)
    a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=True, use_packed_ue8m0=True)
    if recipe[1] == 1:
        b_q = dg.per_token_cast_to_fp8(b, use_ue8m0=True, use_packed_ue8m0=True)
    else:
        bq, bsf = dg.per_block_cast_to_fp8(b, use_ue8m0=True)
        b_q = (bq, jax_pack_ue8m0(bsf))
    assert a_q[1].dtype == b_q[1].dtype == jnp.int32
    return _layout_args(layout, a_q, b_q)


@pytest.mark.parametrize('recipe,layout', [((1, 1, 128), 'nt'), ((1, 128, 128), 'nt'),
                                           ((1, 128, 128), 'tn')])
def test_packed_ue8m0_dequant_matches_jax(recipe, layout):
    """Packed scales select 'dequant' in both packages; an MN-major operand's
    packed scales unpack along their leading dim."""
    a_l, b_l = _packed(recipe, layout)
    d_jax = getattr(dg, f'fp8_gemm_{layout}')(a_l, b_l, recipe=recipe)
    dense.launches = 0
    d_port = getattr(dgt, f'fp8_gemm_{layout}')(_pair(a_l), _pair(b_l), recipe=recipe)
    assert calc_diff(d_port, _f32(d_jax)) < 1e-5
    a_k, b_k = (_packed(recipe, 'nt'))
    ref = dense.dense_gemm_plain(*_dequant_operands(a_k, b_k, recipe), strategy='dequant')
    assert torch.equal(d_port, ref)


def _dequant_operands(a_q, b_q, recipe):
    """The NT kernel operands of packed pairs: e4m3 values and f32 scales."""
    ksf = K_PACKED // 128
    sfa = sf_layout.transform_sfa(_t(a_q[1]), a_q[0].shape[0], K_PACKED, 128)
    sfb = sf_layout.transform_sfb(_t(b_q[1]), b_q[0].shape[0], K_PACKED, recipe[1:])
    assert sfa.shape[1] == sfb.shape[1] == ksf
    return _t(a_q[0]), _t(b_q[0]), sfa, sfb, None, recipe[1]


K_PACKED = 512


def test_packed_ue8m0_promote_when_pinned(monkeypatch):
    """``force_scale_strategy='promote'`` (``DGT_SCALE_STRATEGY``) in both
    packages: the promotion on the unpacked scales, bitwise the port's f32
    call on the same scales."""
    recipe = (1, 128, 128)
    a_q, b_q = _packed(recipe, seed=12)
    monkeypatch.setattr(jax_runtime(), 'force_scale_strategy', 'promote')
    monkeypatch.setattr(port_runtime(), 'force_scale_strategy', 'promote')
    d_jax = dg.fp8_gemm_nt(a_q, b_q, recipe=recipe)
    d_port = dgt.fp8_gemm_nt(_pair(a_q), _pair(b_q), recipe=recipe)
    assert calc_diff(d_port, _f32(d_jax)) < 1e-5
    a, b, sfa, sfb, _, gran_n = _dequant_operands(a_q, b_q, recipe)
    assert torch.equal(d_port, dgt.fp8_gemm_nt((a, sfa), (b, sfb), recipe=recipe))
    monkeypatch.undo()
    d_dequant = dgt.fp8_gemm_nt(_pair(a_q), _pair(b_q), recipe=recipe)
    assert calc_diff(d_dequant, d_port) < 1e-5


def test_planar_fp4_routes_are_bitwise_and_match_jax():
    """Planar FP4 B at (1, 128) power-of-two scales: decoded in the kernel,
    folded first, or handed over interleaved give the same bits in the
    port, and JAX's in-kernel route within 1e-5."""
    m, n, k = 64, 128, 512
    a_q, _ = _fp8_nt(13, m=m, n=n, k=k)
    b = _bf16((n, k), 14)
    bq, bsf = dg.per_token_cast_to_fp4(b, use_ue8m0=True, gran_k=128)
    planar = dg.repack_fp4_to_planar(bq)
    kw = dict(recipe_a=(1, 128), recipe_b=(1, 128))
    d_jax = dg.fp8_fp4_gemm_nt(a_q, (planar, bsf), fp4_layout='planar_in_kernel', **kw)
    a_t, planar_t = _pair(a_q), (_t(planar), _t(bsf))
    outs = {layout: dgt.fp8_fp4_gemm_nt(a_t, planar_t, fp4_layout=layout, **kw)
            for layout in ('planar_in_kernel', 'planar_fold', 'planar')}
    outs['interleaved'] = dgt.fp8_fp4_gemm_nt(a_t, (_t(bq), _t(bsf)), **kw)
    assert calc_diff(outs['planar_in_kernel'], _f32(d_jax)) < 1e-5
    for layout, d in outs.items():
        assert torch.equal(d, outs['planar_in_kernel']), layout
    codes = dense._decode_planar(_t(planar))
    assert torch.equal(codes.float(), dgt.cast_back_from_fp4(_t(bq), torch.ones(n, k // 128)))


@pytest.mark.parametrize('gran', [32, 64])
def test_fp4_fine_granularity_matches_jax(gran):
    """A packed FP4 B at a scale granularity finer than the promotion block
    (JAX's bf16 fold; the port's mixed e4m3 x bf16 forms), with f32 A scales
    ('promote') and with packed A scales ('dequant'), at k = 512."""
    m, n, k = 64, 128, 512
    a = _bf16((m, k), 15)
    b4 = dg.per_token_cast_to_fp4(_bf16((n, k), 16), use_ue8m0=True, gran_k=gran)
    for packed in (False, True):
        a_q = dg.per_token_cast_to_fp8(a, use_ue8m0=True, use_packed_ue8m0=packed)
        d_jax = dg.fp8_fp4_gemm_nt(a_q, b4, recipe_a=(1, 128), recipe_b=(1, gran))
        d_port = dgt.fp8_fp4_gemm_nt(_pair(a_q), _pair(b4), recipe_a=(1, 128),
                                     recipe_b=(1, gran))
        assert calc_diff(d_port, _f32(d_jax)) < 1e-5, packed
        a_deq = _f32(a_q[0]) * np.repeat(_f32(dgt.transform_sf_into_required_layout(
            _t(a_q[1]))), 128, axis=1)[:, :k]
        b_deq = _f32(dg.cast_back_from_fp4(*b4, gran_k=gran))
        assert calc_diff(d_port, a_deq @ b_deq.T) < 1e-5


@pytest.mark.parametrize('use_fp8', [True, False])
@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_m_grouped_nn_contiguous_matches_jax(use_fp8, use_psum_layout):
    """B MN-major [G, k, n] with [G, ksf, nsf] scales, against JAX's NN op
    and bitwise the port's NT op on B transposed back."""
    n, k = 256, 384
    m, a, b, layout, _ = generate_m_grouped_contiguous(3, 128, n, k, use_fp8=use_fp8,
                                                       use_psum_layout=use_psum_layout)
    if use_fp8:
        b_nn = (jnp.swapaxes(b[0], 1, 2), jnp.swapaxes(b[1], 1, 2))
        jax_op, port_op, nt_op = (dg.m_grouped_fp8_gemm_nn_contiguous,
                                  dgt.m_grouped_fp8_gemm_nn_contiguous,
                                  dgt.m_grouped_fp8_gemm_nt_contiguous)
        nn, nt, a_p = _pair(b_nn), _pair(b), _pair(a)
    else:
        b_nn = jnp.swapaxes(b, 1, 2)
        jax_op, port_op, nt_op = (dg.m_grouped_bf16_gemm_nn_contiguous,
                                  dgt.m_grouped_bf16_gemm_nn_contiguous,
                                  dgt.m_grouped_bf16_gemm_nt_contiguous)
        nn, nt, a_p = _t(b_nn), _t(b), _t(a)
    kw = dict(grouped_layout=layout, use_psum_layout=use_psum_layout, ensure_zero_padding=True)
    d_jax = jax_op(a, b_nn, **kw)
    kw['grouped_layout'] = _t(layout)
    grouped.contiguous_nn_launches.update(bf16=0, fp8=0)
    d_port = port_op(a_p, nn, **kw)
    assert grouped.contiguous_nn_launches == {'bf16': 0, 'fp8': 0}
    assert calc_diff(d_port, _f32(d_jax)) < 1e-5
    assert torch.equal(d_port, nt_op(a_p, nt, **kw))


def test_m_grouped_packed_scales_both_majors():
    """Packed UE8M0 scales through the contiguous ops, k-major B (packed
    along the last dim) and MN-major B (packed along the leading SF dim),
    bitwise the f32-scale call, as JAX's own test holds its ops
    (tests/test_gemm_grouped.py:463-507)."""
    groups, rows, n, k = 2, 128, 256, 640
    a = _bf16((groups * rows, k), 17)
    b = _bf16((groups, n, k), 18, 0.1)
    ids = _t(np.repeat(np.arange(groups, dtype=np.int32), rows))
    aq, asf = dgt.per_token_cast_to_fp8(_t(a), use_ue8m0=True)
    bq, bsf = dgt.per_block_cast_to_fp8(_t(b), use_ue8m0=True)
    d_f32 = dgt.m_grouped_fp8_gemm_nt_contiguous((aq, asf), (bq, bsf), grouped_layout=ids)
    pack = sf_layout.get_mn_major_tma_aligned_packed_ue8m0_tensor
    d_k = dgt.m_grouped_fp8_gemm_nt_contiguous((aq, pack(asf)), (bq, pack(bsf)),
                                               grouped_layout=ids)
    b_nn = bq.view(torch.uint8).transpose(1, 2).contiguous().view(bq.dtype)
    d_mn = dgt.m_grouped_fp8_gemm_nn_contiguous(
        (aq, pack(asf)), (b_nn, pack(bsf).transpose(1, 2).contiguous()), grouped_layout=ids)
    assert torch.equal(d_k, d_f32) and torch.equal(d_mn, d_f32)


def _flatten(x, ks):
    """TN operand [sum(ks), dim] -> each group's segment k-major, flattened."""
    x = np.asarray(x)
    segs, off = [], 0
    for kg in ks:
        segs.append(np.ascontiguousarray(x[off:off + kg].T).reshape(-1))
        off += kg
    return np.concatenate(segs)


@pytest.mark.parametrize('ks', [[128, 256], [256, 0, 128]], ids=['two', 'empty_group'])
def test_k_grouped_nt_flattened_matches_jax_and_tn(ks):
    """The flattened k-major form against JAX's, and bitwise the port's TN
    call on the same data (tests/test_gemm_k_grouped.py:76-101); an empty
    group returns its c."""
    m, n = 64, 128
    _, a, b, c, _, ks_arr = generate_k_grouped_contiguous(len(ks), m, n, ks, use_fp8=True)
    (a_v, a_sf), (b_v, b_sf) = a, b
    a_flat, b_flat = jnp.asarray(_flatten(a_v, ks)), jnp.asarray(_flatten(b_v, ks))
    d_jax = dg.k_grouped_fp8_gemm_nt_contiguous((a_flat, a_sf.T), (b_flat, b_sf.T), ks=ks,
                                                grouped_layout=ks_arr, c=c)
    k_grouped.flat_launches = 0
    d_port = dgt.k_grouped_fp8_gemm_nt_contiguous(
        (_t(a_flat), _t(a_sf.T)), (_t(b_flat), _t(b_sf.T)), ks=ks, grouped_layout=_t(ks_arr),
        c=_t(c))
    assert k_grouped.flat_launches == 0
    for g in range(len(ks)):
        assert calc_diff(d_port[g], _f32(d_jax[g])) < 1e-5, g
    d_tn = dgt.k_grouped_fp8_gemm_tn_contiguous(_pair(a), _pair(b), ks=ks,
                                                grouped_layout=_t(ks_arr), c=_t(c))
    assert torch.equal(d_port, d_tn)
    if 0 in ks:
        assert torch.equal(d_port[ks.index(0)], _t(c)[ks.index(0)])


def test_sf_transforms_match_jax():
    """The public transforms and the packed / MN-major / k-grouped helpers
    against JAX's on the same scales."""
    rng = np.random.RandomState(19)
    sf = (2.0 ** rng.randint(-8, 8, (96, 5))).astype(np.float32)
    packed_jax = dg.ops.sf_layout.get_mn_major_tma_aligned_packed_ue8m0_tensor(jnp.asarray(sf))
    packed = sf_layout.get_mn_major_tma_aligned_packed_ue8m0_tensor(_t(sf))
    assert packed.dtype == torch.int32 and np.array_equal(packed.numpy(), np.asarray(packed_jax))
    for cast in (True, False):
        want = dg.transform_sf_into_required_layout(packed_jax, disable_ue8m0_cast=cast)
        got = dgt.transform_sf_into_required_layout(packed, disable_ue8m0_cast=cast)
        assert np.array_equal(got.numpy(), np.asarray(want))
    odd = (rng.rand(96, 5) * 3).astype(np.float32)
    assert np.array_equal(dgt.transform_sf_into_required_layout(_t(odd), disable_ue8m0_cast=False)
                          .numpy(), np.asarray(dg.transform_sf_into_required_layout(
                              jnp.asarray(odd), disable_ue8m0_cast=False)))
    assert torch.equal(sf_layout.get_mn_major_tma_aligned_tensor(_t(sf)), _t(sf).t())
    ks = [256, 0, 384, 100]
    ksf = sum(-(-kg // 128) for kg in ks)
    sf_k = (2.0 ** rng.randint(-4, 4, (32, ksf))).astype(np.float32)
    want = dg.ops.sf_layout.get_k_grouped_mn_major_tma_aligned_packed_ue8m0_tensor(
        jnp.asarray(sf_k), ks)
    got = sf_layout.get_k_grouped_mn_major_tma_aligned_packed_ue8m0_tensor(_t(sf_k), ks)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert sf_layout.check_k_grouped_packed_ue8m0_tensor(got, ks)
    # the MN-major packed SFB of the dense op: unpacked along its leading dim
    unpacked = sf_layout.transform_sfb(packed.t().contiguous(), 96, 5 * 128, (1, 128),
                                       b_kmajor=False)
    assert torch.equal(unpacked, _t(sf))
    pair = dgt.ops.sf_layout.transform_sf_pair_into_required_layout(
        packed, packed, 96, 96, 640, recipe=(1, 1, 128))
    assert pair[2:] == (128, 128) and torch.equal(pair[0][:, :5], _t(sf))


def test_runtime_knobs_store_and_read(monkeypatch):
    """The knobs keep what they are set to; the mk alignment moves the psum
    layout's group starts, as JAX's does."""
    rt = port_runtime()
    for name in ('tc_util', 'pdl', 'ignore_compile_dims', 'block_m_multiple_of',
                 'block_n_multiple_of', 'mk_alignment'):
        monkeypatch.setattr(rt, name, getattr(rt, name))
    dgt.set_tc_util(75)
    dgt.set_pdl(True)
    dgt.set_ignore_compile_dims(True)
    dgt.set_block_size_multiple_of(64, 32)
    assert (dgt.get_tc_util(), dgt.get_pdl(), rt.ignore_compile_dims,
            rt.block_m_multiple_of, rt.block_n_multiple_of) == (75, True, True, 64, 32)
    assert dgt.get_mk_alignment_for_contiguous_layout() == 128
    ends = torch.tensor([70, 300, 300, 450])
    from deepgemm_tpu_torch.kernels.common import psum_group_starts
    assert psum_group_starts(ends).tolist() == [0, 128, 384, 384]
    dgt.set_mk_alignment_for_contiguous_layout(64)
    assert psum_group_starts(ends).tolist() == [0, 128, 320, 320]
    dgt.set_mk_alignment_for_contiguous_layout(32)
    with pytest.raises(ValueError, match='mk alignment'):
        grouped.compute_tile_gids(ends.int(), 4, 512, 64, True)


@pytest.mark.parametrize('m,want', [(16, True), (16384, True), (65536, False)])
def test_fp4_inkernel_policy_on_the_h100_row(m, want):
    """In-kernel FP4 decode wins where B's bytes set the time (small m),
    the fold where the operations do (large m); the H100 is the row every
    device resolves to. The crossover (n 7168, k 2048) is at m ~18800 since
    both routes run the wgmma kernel (~7700 on the mma.sync one)."""
    assert detect_arch() is H100_SXM
    assert fp4_inkernel_profitable(H100_SXM, m, 7168, 2048) is want
