"""The port's CUDA kernels against their plain versions on the card, at
small shapes. They have no CPU mode, so every test here skips without a
CUDA card. On a machine with one (and without JAX, which tests/conftest.py
imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from deepgemm_tpu_torch.kernels import (dense, grouped, k_grouped, mqa_logits, paged_mqa,
                                        sparse_attn)
from deepgemm_tpu_torch.kernels import common
from deepgemm_tpu_torch.kernels.common import plain_versions
from deepgemm_tpu_torch.models import transformer as tt
from deepgemm_tpu_torch.models.convert import tree_leaves, tree_map
from deepgemm_tpu_torch.serving import ContinuousBatcher
from deepgemm_tpu_torch.testing import calc_diff
from deepgemm_tpu_torch.utils.math import (align, per_block_cast_to_fp8,
                                           per_channel_cast_to_fp8, per_token_cast_to_fp8,
                                           quantize_experts)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels have no CPU mode')
    return torch.Generator(device='cuda').manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)


@pytest.mark.parametrize('m,n,k', [(64, 256, 320), (130, 200, 7168), (1, 64, 128)])
def test_dense_kernel_matches_plain(gen, m, n, k):
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    bq, sfb = per_block_cast_to_fp8(_randn(gen, n, k), use_ue8m0=False)
    before = dense.launches
    d = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb)
    torch.cuda.synchronize()
    assert dense.launches == before + 1
    assert calc_diff(d, dense.dense_fp8_gemm_nt_plain(aq, bq, sfa, sfb)) < 1e-5


def test_dense_kernel_per_channel_scales(gen):
    m, n, k = 64, 192, 384
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    bq, sfb = per_token_cast_to_fp8(_randn(gen, n, k), use_ue8m0=False)   # [n, ksf]
    d = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb, gran_n=1)
    ref = dense.dense_fp8_gemm_nt_plain(aq, bq, sfa, sfb, gran_n=1)
    torch.cuda.synchronize()
    assert calc_diff(d, ref) < 1e-5


@pytest.mark.parametrize('fp8', [False, True])
def test_masked_kernel_matches_plain(gen, fp8):
    g, max_m, n, k = 3, 40, 256, 320
    a, b = _randn(gen, g, max_m, k), _randn(gen, g, n, k)
    masked_m = torch.tensor([0, 17, 40], dtype=torch.int32, device='cuda')
    kw = {}
    if fp8:
        a, sfa = per_token_cast_to_fp8(a.view(-1, k), use_ue8m0=False)
        a, sfa = a.view(g, max_m, k), sfa.view(g, max_m, -1)
        bq = [per_block_cast_to_fp8(b[i], use_ue8m0=False) for i in range(g)]
        b = torch.stack([q for q, _ in bq])
        sfb = torch.stack([s for _, s in bq])
        kw = dict(sfa=sfa, sfb=sfb)
    d = grouped.masked_gemm(a, b, masked_m, **kw)
    ref = grouped.masked_gemm_plain(a, b, masked_m, **kw)
    torch.cuda.synchronize()
    rows = torch.arange(max_m, device='cuda')[None, :] < masked_m[:, None]
    assert calc_diff(d[rows], ref[rows]) < 1e-5


def _masked_case(gen, g, max_m, n, k, fp8, gran_n=128):
    """Seeded operands of the masked kernel: bf16, or e4m3 with per-token A
    scales and B scaled per 128 x 128 block (gran_n 128) or per row (1)."""
    a, b = _randn(gen, g, max_m, k), _randn(gen, g, n, k)
    if not fp8:
        return a, b, {}
    aq, sfa = per_token_cast_to_fp8(a.view(-1, k), use_ue8m0=False)
    cast = per_block_cast_to_fp8 if gran_n == 128 else per_token_cast_to_fp8
    bq = [cast(b[i], use_ue8m0=False) for i in range(g)]
    return (aq.view(g, max_m, k), torch.stack([q for q, _ in bq]),
            dict(sfa=sfa.view(g, max_m, -1), sfb=torch.stack([sf for _, sf in bq]),
                 gran_n=gran_n))


@pytest.mark.parametrize('max_m,n,k,form', [
    (17, 256, 320, 'fp8'),         # 64-row tiles past max_m; a k tail (the last block half full)
    (40, 200, 512, 'fp8'),         # n not a multiple of 128: the last column tile clipped
    (40, 202, 256, 'fp8'),         # n not a multiple of 8: rows not whole 16-byte chunks
    (200, 256, 320, 'fp8'),        # 128-row tiles, the last one past max_m
    (40, 136, 320, 'fp8_rows'),    # B scaled per row (fp8_bmm under recipe (1, 1, 128))
    (200, 200, 512, 'fp8_rows'),
    (40, 256, 320, 'fp8_f32'),     # the f32 instance
    (200, 202, 256, 'fp8_f32'),
    (17, 200, 320, 'bf16'),
    (200, 202, 336, 'bf16'),
])
def test_masked_kernel_edges(gen, max_m, n, k, form):
    """The masked kernel against its plain version on the live rows, with
    masked_m holding 0, a partial count and max_m (full)."""
    g = 3
    a, b, kw = _masked_case(gen, g, max_m, n, k, form != 'bf16',
                            gran_n=1 if form == 'fp8_rows' else 128)
    if form == 'fp8_f32':
        kw['out_dtype'] = torch.float32
    masked_m = torch.tensor([0, max_m // 2 + 1, max_m], dtype=torch.int32, device='cuda')
    key = {'fp8_f32': 'fp8_f32', 'bf16': 'bf16'}.get(form, 'fp8')
    before = grouped.launches[key]
    d = grouped.masked_gemm(a, b, masked_m, **kw)
    ref = grouped.masked_gemm_plain(a, b, masked_m, **kw)
    torch.cuda.synchronize()
    assert grouped.launches[key] == before + 1
    assert d.dtype == (torch.float32 if form == 'fp8_f32' else torch.bfloat16)
    rows = torch.arange(max_m, device='cuda')[None, :] < masked_m[:, None]
    assert calc_diff(d[rows], ref[rows]) < 1e-5


@pytest.mark.parametrize('form', ['bf16', 'fp8', 'fp8_rows', 'fp8_f32'])
def test_masked_launches_repeat_bitwise(gen, form):
    """Five launches on the same inputs give the same bits, every row live:
    a hazard between the wgmma and its registers or stages would show as a
    rare difference."""
    a, b, kw = _masked_case(gen, 4, 200, 264, 576, form != 'bf16',
                            gran_n=1 if form == 'fp8_rows' else 128)
    if form == 'fp8_f32':
        kw['out_dtype'] = torch.float32
    full = torch.full((4,), 200, dtype=torch.int32, device='cuda')
    outs = [grouped.masked_gemm(a, b, full, **kw) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], d) for d in outs[1:])


@pytest.mark.parametrize('form', ['bf16', 'fp8', 'fp8_rows'])
def test_masked_64_row_tiles_are_bitwise_the_128_row_tiles(gen, form):
    """max_m 64 runs 64-row tiles, max_m 96 128-row ones: the same 64 rows
    (the rest zero) give the same bits in both."""
    a, b, kw = _masked_case(gen, 3, 64, 200, 320, form != 'bf16',
                            gran_n=1 if form == 'fp8_rows' else 128)
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :32])], dim=1)
    a96 = pad(a.view(torch.uint8)).view(a.dtype) if form != 'bf16' else pad(a)
    kw96 = dict(kw, sfa=pad(kw['sfa'])) if form != 'bf16' else kw
    m64 = torch.full((3,), 64, dtype=torch.int32, device='cuda')
    d64 = grouped.masked_gemm(a, b, m64, **kw)
    d96 = grouped.masked_gemm(a96, b, m64, **kw96)
    torch.cuda.synchronize()
    from deepgemm_tpu_torch.heuristics.configs import get_sm90_config
    assert get_sm90_config(64, 200, 3, masked=True, elem=a.element_size()).block_m == 64
    assert get_sm90_config(96, 200, 3, masked=True, elem=a.element_size()).block_m == 128
    assert torch.equal(d64, d96[:, :64])


def test_dense_kernel_f32_output(gen):
    """The wgrad's shape class: per-channel B scales, f32 out; the bf16
    output is the same sum rounded once."""
    m, n, k = 192, 256, 384
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    bq, sfb = per_token_cast_to_fp8(_randn(gen, n, k), use_ue8m0=False)
    d32 = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb, gran_n=1, out_dtype=torch.float32)
    d16 = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb, gran_n=1)
    ref = dense.dense_fp8_gemm_nt_plain(aq, bq, sfa, sfb, gran_n=1, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert d32.dtype == torch.float32 and calc_diff(d32, ref) < 1e-5
    assert torch.equal(d16, d32.to(torch.bfloat16))


def _contiguous_case(gen, rows, n, k, fp8, use_psum_layout):
    """Groups of ``rows`` live rows, each padded to 128 with NONZERO rows."""
    aligned = [align(r, 128) for r in rows]
    m = sum(aligned)
    a, b = _randn(gen, m, k), _randn(gen, len(rows), n, k)
    ids = torch.full((m,), -1, dtype=torch.int32)
    ends, start = [], 0
    for g, (r, span) in enumerate(zip(rows, aligned)):
        ids[start:start + r] = g
        ends.append(start + r)
        start += span
    layout = torch.tensor(ends, dtype=torch.int32) if use_psum_layout else ids
    kw = {}
    if fp8:
        a, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
        b, sfb = quantize_experts(b)
        kw = dict(sfa=sfa, sfb=sfb)
    return a, b, layout.cuda(), kw, (ids >= 0).cuda()


@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('use_psum_layout,ensure_zero_padding',
                         [(False, True), (True, False), (True, True)])
def test_contiguous_kernel_matches_plain(gen, fp8, use_psum_layout, ensure_zero_padding):
    a, b, layout, kw, live = _contiguous_case(gen, (70, 0, 200, 130), 200, 320, fp8,
                                              use_psum_layout)
    kw.update(use_psum_layout=use_psum_layout, ensure_zero_padding=ensure_zero_padding)
    before = dict(grouped.contiguous_launches)
    d = grouped.contiguous_gemm(a, b, layout, **kw)
    ref = grouped.contiguous_gemm_plain(a, b, layout, **kw)
    torch.cuda.synchronize()
    kind = 'fp8' if fp8 else 'bf16'
    assert grouped.contiguous_launches[kind] == before[kind] + 1
    rows = slice(None) if ensure_zero_padding else live
    assert calc_diff(d[rows], ref[rows]) < 1e-5
    if ensure_zero_padding:
        assert not d[~live].float().any()


@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('b_mn', [False, True])
def test_contiguous_64_row_tiles_are_bitwise_the_128_row_tiles(gen, fp8, b_mn):
    """An mk alignment of 64 runs the contiguous kernel on 64-row tiles;
    each row's sum is the 128-row tiles' (NT and NN, zero padding on)."""
    import deepgemm_tpu_torch as dgt
    a, b, layout, kw, live = _contiguous_case(gen, (70, 0, 200, 130), 208, 320, fp8, False)
    if b_mn:
        b = (b.view(torch.uint8) if fp8 else b).transpose(1, 2).contiguous().view(b.dtype)
    kw.update(ensure_zero_padding=True, b_mn=b_mn)
    layout_name, kind = 'nn' if b_mn else 'nt', 'fp8' if fp8 else 'bf16'
    grouped.contiguous_form_launches.clear()
    d128 = grouped.contiguous_gemm(a, b, layout, **kw)
    before = dgt.get_mk_alignment_for_contiguous_layout()
    dgt.set_mk_alignment_for_contiguous_layout(64)
    try:
        d64 = grouped.contiguous_gemm(a, b, layout, **kw)
    finally:
        dgt.set_mk_alignment_for_contiguous_layout(before)
    ref = grouped.contiguous_gemm_plain(a, b, layout, **kw)
    torch.cuda.synchronize()
    assert grouped.contiguous_form_launches == {
        grouped.contiguous_form(kind, layout_name, 128): 1,
        grouped.contiguous_form(kind, layout_name, 64): 1}
    assert torch.equal(d64, d128)
    assert calc_diff(d64, ref) < 1e-5 and not d64[~live].float().any()


@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('form', ['nt', 'nn', 'dual'])
def test_contiguous_launches_repeat_bitwise(gen, fp8, form):
    """Five launches of each contiguous form on the same inputs give the
    same bits: a hazard between the mainloop's wgmma and its registers or
    stages would show as a rare difference."""
    a, b, layout, kw = _dual_case(gen, (128, 384, 0, 256, 256), 192, 336, fp8, False)
    if form == 'nn':
        b = (b.view(torch.uint8) if fp8 else b).transpose(1, 2).contiguous().view(b.dtype)
        kw.update(b_mn=True)
    call = grouped.contiguous_dual_gemm if form == 'dual' else grouped.contiguous_gemm
    outs = [call(a, b, layout, **kw) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], d) for d in outs[1:])


@pytest.mark.parametrize('form', ['nt', 'nn', 'dual'])
def test_contiguous_per_channel_scales(gen, form):
    """B scaled per row (gran_n 1, the wgrad recipe's scales): each form
    against the plain version, the NN and dual-B forms bitwise NT."""
    a, b, layout, _ = _dual_case(gen, (128, 384, 0, 256, 256), 192, 336, False, False)
    aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
    casts = [per_token_cast_to_fp8(b[g], use_ue8m0=False) for g in range(b.shape[0])]
    bq = torch.stack([q for q, _ in casts])
    kw = dict(sfa=sfa, sfb=torch.stack([sf for _, sf in casts]), gran_n=1)
    d_nt = grouped.contiguous_gemm(aq, bq, layout, **kw)
    if form == 'nn':
        bq_mn = bq.view(torch.uint8).transpose(1, 2).contiguous().view(bq.dtype)
        d = grouped.contiguous_gemm(aq, bq_mn, layout, b_mn=True, **kw)
    elif form == 'dual':
        d = grouped.contiguous_dual_gemm(aq, bq, layout, **kw)
    else:
        d = d_nt
    ref = grouped.contiguous_gemm_plain(aq, bq, layout, **kw)
    torch.cuda.synchronize()
    assert calc_diff(d, ref) < 1e-5
    assert torch.equal(d, d_nt)


@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('dual', [False, True])
def test_contiguous_rows_of_ragged_16_byte_chunks(gen, fp8, dual):
    """n = 202: an output row of 404 bytes is not whole 16-byte chunks, so
    the kernel stores its tiles itself (no TMA store); against the plain
    version, the dual-B form bitwise the contiguous one."""
    a, b, layout, kw = _dual_case(gen, (128, 384, 256), 202, 256, fp8, False)
    d = grouped.contiguous_gemm(a, b, layout, **kw)
    ref = grouped.contiguous_gemm_plain(a, b, layout, **kw)
    if dual:
        d_dual = grouped.contiguous_dual_gemm(a, b, layout, **kw)
    torch.cuda.synchronize()
    assert calc_diff(d, ref) < 1e-5
    if dual:
        assert torch.equal(d_dual, d)


def _k_grouped_case(gen, sizes, m, n, fp8, use_psum_layout):
    """TN operands over groups of ``sizes`` rows (16-row-unaligned among
    them), gap rows nonzero; fp8 with each group cast on its own, its
    scales compacted k-first."""
    starts, ends, start = [], [], 0
    for sz in sizes:
        starts.append(start)
        ends.append(start + sz)
        start = align(start + sz, 128) if use_psum_layout else start + sz
    total_k = align(ends[-1], 128) + (64 if use_psum_layout else 0)
    a, b = _randn(gen, total_k, m), _randn(gen, total_k, n)
    layout = torch.tensor(ends if use_psum_layout else sizes, dtype=torch.int32, device='cuda')
    if not fp8:
        return a, b, layout, {}
    ops = []
    for x in (a, b):
        q = x.to(torch.float8_e4m3fn)
        sfs = []
        for st, sz in zip(starts, sizes):
            if sz:
                xg = torch.zeros((align(sz, 128), x.shape[1]), dtype=x.dtype, device='cuda')
                xg[:sz] = x[st:st + sz]
                qg, sg = per_channel_cast_to_fp8(xg, use_ue8m0=False)
                q[st:st + sz] = qg[:sz]
                sfs.append(sg)
        ops.append((q, torch.cat(sfs)))
    (aq, sfa), (bq, sfb) = ops
    return aq, bq, layout, dict(sfa=sfa, sfb=sfb)


@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('use_psum_layout,with_c', [(False, False), (True, True)])
def test_k_grouped_kernel_matches_plain(gen, fp8, use_psum_layout, with_c):
    g_sizes, m, n = (200, 0, 37, 256), 96, 200
    a, b, layout, kw = _k_grouped_case(gen, g_sizes, m, n, fp8, use_psum_layout)
    c = torch.randn((len(g_sizes), m, n), generator=gen, device='cuda') if with_c else None
    kw.update(c=c, use_psum_layout=use_psum_layout)
    before = dict(k_grouped.launches)
    d = k_grouped.k_grouped_gemm(a, b, layout, **kw)
    d16 = k_grouped.k_grouped_gemm(a, b, layout, out_dtype=torch.bfloat16, **kw)
    ref = k_grouped.k_grouped_gemm_plain(a, b, layout, **kw)
    torch.cuda.synchronize()
    kind = 'fp8' if fp8 else 'bf16'
    assert k_grouped.launches[kind] == before[kind] + 2
    assert d.dtype == torch.float32 and calc_diff(d, ref) < 1e-5
    assert torch.equal(d[1], c[1] if with_c else torch.zeros_like(d[1]))     # the empty group
    assert torch.equal(d16, d.to(torch.bfloat16))      # bf16 epilogue: f32 rounded once


def test_kernel_wrappers_reject_what_the_kernel_does_not_take(gen):
    a = _randn(gen, 16, 200)                       # k % 16 != 0
    aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
    bq, sfb = per_block_cast_to_fp8(_randn(gen, 64, 200), use_ue8m0=False)
    with pytest.raises(ValueError):
        dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb)
    with pytest.raises(TypeError):
        grouped.masked_gemm(aq[None], bq[None].to(torch.bfloat16),
                            torch.ones(1, dtype=torch.int32, device='cuda'))


@pytest.mark.parametrize('use_fp8', [False, True])
def test_one_layer_forward_kernel_matches_plain(gen, use_fp8):
    """One layer routes on identical inputs in both paths, so the logits
    must agree (with more layers an expert choice can flip at a near tie)."""
    base = dict(vocab=512, hidden=256, num_layers=1, num_heads=2, head_dim=64,
                num_experts=8, topk=2, moe_intermediate=256, capacity_factor=8.0,
                use_fp8=use_fp8, use_kernels=True)
    params = tt.init_params(tt.ModelConfig(**base), seed=0)
    tokens = torch.randint(0, 512, (2, 32), generator=gen, device='cuda')
    before = dict(grouped.launches)
    lk = tt.forward(params, tokens, tt.ModelConfig(**base))
    with plain_versions():
        lp = tt.forward(params, tokens, tt.ModelConfig(**base))
    kind = 'fp8' if use_fp8 else 'bf16'
    assert grouped.launches[kind] == before[kind] + 2
    assert torch.isfinite(lk).all()
    assert calc_diff(lk, lp) < 1e-5


class StepDecisions:
    """The discrete choices of an FP8 training step, recorded on one step
    and replayed on another: each e4m3 cast of the FP8 ops (codes and
    scales), the router's top-k experts, and each bf16 gradient as SGD
    takes it. Two steps whose products differ in their last bits (the
    wgmma kernels against their plain versions) otherwise part ways at
    these choices: an element near an e4m3 or bf16 rounding edge, or a
    near-tie route, flips, and the bf16 updates of about one bf16 step
    then differ far beyond 1e-5. Replayed, a cast whose input is within
    calc_diff 1e-5 of the recorded one takes the recorded codes and
    scales, the router takes the recorded experts (with its own weights at
    them), and a bf16 gradient within 1e-5 takes the recorded value where
    the two are one bf16 step apart or equal. Anything further apart keeps
    its own result, so a fault still shows in what follows."""

    CASTS = ('per_token_cast_to_fp8', 'per_block_cast_to_fp8', 'per_channel_cast_to_fp8',
             'quantize_experts')

    def __init__(self, monkeypatch, cfg):
        from deepgemm_tpu_torch.ops import autograd
        self.monkeypatch, self.cfg, self.log, self.replaying = monkeypatch, cfg, [], False
        self.taken = {'recorded': 0, 'own': 0}
        for name in self.CASTS:
            fn = getattr(autograd, name)
            monkeypatch.setattr(autograd, name, lambda x, *a, _fn=fn, _name=name, **kw:
                                self._choose(_name, x, lambda: _fn(x, *a, **kw)))
        topk, sgd = tt.topk_stable, tt._sgd_
        monkeypatch.setattr(tt, 'topk_stable', lambda x, k: self._route(x, k, topk))
        monkeypatch.setattr(tt, '_sgd_', lambda p, g, lr: sgd(p, self._grad(g), lr))

    def replay(self):
        self.replaying, self.pos = True, 0

    def _next(self, kind, x):
        rec_kind, rec_x, rec_out = self.log[self.pos]
        self.pos += 1
        assert rec_kind == kind and rec_x.shape == x.shape, (rec_kind, kind)
        return rec_x, rec_out

    def _choose(self, kind, x, compute):
        if not self.replaying:
            out = compute()
            self.log.append((kind, x.detach().clone(), out))
            return out
        rec_x, rec_out = self._next(kind, x)
        if torch.equal(rec_x, x) or calc_diff(x.float(), rec_x.float()) >= 1e-5:
            self.taken['own'] += not torch.equal(rec_x, x)
            return compute()
        self.taken['recorded'] += 1
        return rec_out

    def _route(self, x, k, topk):
        idx = self._choose('topk', x, lambda: topk(x, k))[1]
        return x.gather(-1, idx), idx

    def _grad(self, g):
        if g.dtype != torch.bfloat16:
            return g
        if not self.replaying:
            self.log.append(('grad', g.clone(), None))
            return g
        rec_g, _ = self._next('grad', g)
        if torch.equal(rec_g, g) or calc_diff(g.float(), rec_g.float()) >= 1e-5:
            self.taken['own'] += not torch.equal(rec_g, g)
            return g
        self.taken['recorded'] += 1
        apart = (g.view(torch.int16).int() - rec_g.view(torch.int16).int()).abs()
        return torch.where(apart <= 1, rec_g, g)


def test_train_step_kernel_matches_plain(gen, monkeypatch):
    """A whole FP8 training step at a tiny size: through the kernels (dense
    6, contiguous 4, k-grouped 2 launches) and through their plain versions
    from the same parameters: the loss, every updated parameter and every
    update (new - old) agree, the plain step run on the kernel step's
    casts, routes and bf16 gradient roundings where its own are within
    last-bit noise of them (:class:`StepDecisions`); and each of the step's
    twelve kernel calls agrees with its plain version on the step's own
    inputs."""
    from deepgemm_tpu_torch.ops import gemm, k_grouped as kg_ops, m_grouped
    base = dict(vocab=512, hidden=256, num_layers=1, num_heads=2, head_dim=64,
                num_experts=8, topk=2, moe_intermediate=256, capacity_factor=7.9,
                use_fp8_training=True, use_kernels=True)
    cfg = tt.ModelConfig(**base)           # 64 tokens, top-2 of 8: cap 128
    params = tt.init_params(cfg, seed=0)
    old = tree_leaves(tree_map(torch.clone, params))
    tokens, targets = (torch.randint(0, 512, (2, 32), generator=gen, device='cuda')
                       for _ in range(2))
    calls, entries = [], ((gemm, 'dense_gemm'), (m_grouped, 'contiguous_gemm'),
                          (kg_ops, 'k_grouped_gemm'))
    kernels = {name: getattr(module, name) for module, name in entries}

    def held_to_plain(name):
        def call(*args, **kw):
            out = kernels[name](*args, **kw)
            with plain_versions():
                ref = kernels[name](*args, **kw)
            calls.append((name, calc_diff(out, ref)))
            return out
        return call

    for module, name in entries:
        monkeypatch.setattr(module, name, held_to_plain(name))
    decisions = StepDecisions(monkeypatch, cfg)
    dense.launches = 0
    grouped.contiguous_launches.update(bf16=0, fp8=0)
    k_grouped.launches.update(bf16=0, fp8=0)
    loss_k, new_k = tt.train_step(tree_map(torch.clone, params), tokens, targets, cfg, lr=5e-2)
    torch.cuda.synchronize()
    assert (dense.launches, grouped.contiguous_launches['fp8'], k_grouped.launches['fp8']) == (6, 4, 2)
    assert sorted(name for name, _ in calls) == (['contiguous_gemm'] * 4 + ['dense_gemm'] * 6
                                                 + ['k_grouped_gemm'] * 2)
    assert all(diff < 1e-5 for _, diff in calls), calls
    for module, name in entries:
        monkeypatch.setattr(module, name, kernels[name])
    decisions.replay()
    with plain_versions():
        loss_p, new_p = tt.train_step(tree_map(torch.clone, params), tokens, targets, cfg,
                                      lr=5e-2)
    assert (dense.launches, grouped.contiguous_launches['fp8'], k_grouped.launches['fp8']) == (6, 4, 2)
    assert decisions.pos == len(decisions.log) and decisions.taken['own'] == 0, decisions.taken
    assert torch.isfinite(loss_k) and calc_diff(loss_k, loss_p) < 1e-5
    gaps = _update_gaps(new_k, new_p, old)
    print(f'update gaps per leaf {[f"{g:.3e}" for g in gaps]}; choices {decisions.taken}')
    for i, (k, p) in enumerate(zip(tree_leaves(new_k), tree_leaves(new_p))):
        assert calc_diff(k, p) < 1e-5, i
        assert gaps[i] < 1e-5, i


def _update_gaps(new_a, new_b, old):
    """calc_diff of the updates (new - old) of two steps, leaf by leaf."""
    return [calc_diff(a.float() - o.float(), b.float() - o.float())
            for a, b, o in zip(tree_leaves(new_a), tree_leaves(new_b), old)]


@pytest.mark.parametrize('fault', ['wgrad_times_1.01', 'qkv_row_times_1.5', 'qkv_dgrad_k_block'])
def test_train_step_replay_keeps_a_fault_visible(gen, monkeypatch, fault):
    """The replay of :class:`StepDecisions` hides no fault of a kernel's
    size: with one planted in the kernel step's dense calls (every wgrad
    output 1% large; one row of the qkv forward 1.5x; the qkv dgrad's last
    128-deep k block dropped), some update differs from the replayed plain
    step's by more than 1e-3, a hundred times the limit."""
    from deepgemm_tpu_torch.ops import gemm
    base = dict(vocab=512, hidden=256, num_layers=1, num_heads=2, head_dim=64,
                num_experts=8, topk=2, moe_intermediate=256, capacity_factor=7.9,
                use_fp8_training=True, use_kernels=True)
    cfg = tt.ModelConfig(**base)
    params = tt.init_params(cfg, seed=0)
    old = tree_leaves(tree_map(torch.clone, params))
    tokens, targets = (torch.randint(0, 512, (2, 32), generator=gen, device='cuda')
                       for _ in range(2))
    dense_gemm = gemm.dense_gemm

    def faulty(a, *args, **kw):
        if fault == 'qkv_dgrad_k_block' and a.shape[1] == 3 * cfg.qkv_dim:
            a = a.clone()
            a.view(torch.uint8)[:, -128:] = 0
        out = dense_gemm(a, *args, **kw)
        if fault == 'wgrad_times_1.01' and kw.get('gran_n') == 1:
            out = out * 1.01
        if fault == 'qkv_row_times_1.5' and out.shape[1] == 3 * cfg.qkv_dim:
            out = out.clone()
            out[5] *= 1.5
        return out

    decisions = StepDecisions(monkeypatch, cfg)
    monkeypatch.setattr(gemm, 'dense_gemm', faulty)
    _, new_k = tt.train_step(tree_map(torch.clone, params), tokens, targets, cfg, lr=5e-2)
    monkeypatch.setattr(gemm, 'dense_gemm', dense_gemm)
    decisions.replay()
    with plain_versions():
        _, new_p = tt.train_step(tree_map(torch.clone, params), tokens, targets, cfg, lr=5e-2)
    gaps = _update_gaps(new_k, new_p, old)
    print(f'{fault}: update gaps per leaf {[f"{g:.3e}" for g in gaps]}; choices '
          f'{decisions.taken}')
    assert max(gaps) > 1e-3


# ---- the indexer kernels and the serving engine -------------------------------------

def _fp8(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device='cuda') * scale).clamp(-448, 448).to(
        torch.float8_e4m3fn)


def _same_logits(got, want):
    """-inf at the same places, calc_diff < 1e-5 over the rest."""
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = ~torch.isneginf(want)
    assert calc_diff(got[fin], want[fin]) < 1e-5


@pytest.mark.parametrize('sq,skv,h,d,layout', [(37, 300, 64, 128, 'full'),
                                               (40, 520, 8, 64, 'full'),
                                               (33, 256, 16, 128, 'compressed'),
                                               (20, 200, 4, 32, 'ragged')])
def test_mqa_logits_kernel_matches_plain(gen, sq, skv, h, d, layout):
    q, kv = _fp8(gen, sq, h, d), _fp8(gen, skv, d)
    sf = torch.rand(skv, generator=gen, device='cuda') + 0.5
    w = torch.randn(sq, h, generator=gen, device='cuda')
    ks = torch.randint(0, skv // 2, (sq,), generator=gen, device='cuda', dtype=torch.int32)
    ke = ks + torch.randint(1, skv // 2, (sq,), generator=gen, device='cuda', dtype=torch.int32)
    if layout != 'ragged':
        ks.zero_()
    maxk = int((ke - ks).max()) if layout != 'full' else 0
    before = mqa_logits.launches
    got = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf, max_seqlen_k=maxk)
    with plain_versions():
        want = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf, max_seqlen_k=maxk)
    torch.cuda.synchronize()
    assert mqa_logits.launches == before + 1
    if layout == 'full':
        _same_logits(got, want)
    else:
        assert calc_diff(got, want) < 1e-5
        assert not got[torch.arange(maxk, device='cuda')[None, :] >= (ke - ks)[:, None]].any()


_ALL_PAIRS = [(torch.float8_e4m3fn, torch.float8_e4m3fn), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float8_e4m3fn), (torch.float8_e4m3fn, torch.bfloat16)]


@pytest.mark.parametrize('q_dtype,kv_dtype', _ALL_PAIRS)
@pytest.mark.parametrize('h,d', [(h, d) for h in (8, 16, 32, 64) for d in (64, 128, 256)]
                         + [(4, 32), (160, 64)])
def test_mqa_logits_wgmma_kernel(gen, h, d, q_dtype, kv_dtype):
    """The wgmma kernel (csrc/mqa_sm90.cuh) on 37 query rows (not whole
    tiles) against 700 kv rows, ragged windows that leave the first and the
    last two kv tiles outside every row (and one row with an empty window):
    the full layout within 1e-5 of the plain version with -inf at the same
    places; a second launch bitwise the first; each row alone bitwise its
    row in the batch; the compressed layout on tile-constant ks within 1e-5
    and bitwise the full layout's window. kv carries scales where it is
    e4m3 (the bf16 kv of the FP4 path has none)."""
    sq, skv = 37, 700
    q, kv = _operand(gen, q_dtype, sq, h, d), _operand(gen, kv_dtype, skv, d)
    sf = (torch.rand(skv, generator=gen, device='cuda') + 0.5
          if kv_dtype == torch.float8_e4m3fn else None)
    w = torch.randn(sq, h, generator=gen, device='cuda')
    ks = torch.randint(70, 300, (sq,), generator=gen, device='cuda', dtype=torch.int32)
    ke = ks + torch.randint(1, 250, (sq,), generator=gen, device='cuda', dtype=torch.int32)
    ke[5] = ks[5]
    before = mqa_logits.launches
    got = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf)
    again = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf)
    with plain_versions():
        want = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf)
    torch.cuda.synchronize()
    assert mqa_logits.launches == before + 2
    _same_logits(got, want)
    assert torch.isneginf(got[:, :64]).all() and torch.isneginf(got[:, 576:]).all()
    assert torch.isneginf(got[5]).all()
    assert torch.equal(got, again)
    for i in (0, 1, sq - 1):
        alone = mqa_logits.mqa_logits(q[i:i + 1], kv, w[i:i + 1], ks[i:i + 1], ke[i:i + 1],
                                      kv_sf=sf)
        assert torch.equal(alone[0], got[i]), i
    # the compressed layout in the kernel: ks constant over each tile of rows
    bq = mqa_logits.rows_per_tile(h)
    ks_t = ks[torch.arange(sq, device='cuda') // bq * bq]
    ke_t = ks_t + (ke - ks)
    maxk = int((ke_t - ks_t).max())
    before = mqa_logits.launches
    comp = mqa_logits.mqa_logits(q, kv, w, ks_t, ke_t, kv_sf=sf, max_seqlen_k=maxk)
    full = mqa_logits.mqa_logits(q, kv, w, ks_t, ke_t, kv_sf=sf)
    with plain_versions():
        comp_plain = mqa_logits.mqa_logits(q, kv, w, ks_t, ke_t, kv_sf=sf, max_seqlen_k=maxk)
    torch.cuda.synchronize()
    assert mqa_logits.launches == before + 2
    assert calc_diff(comp, comp_plain) < 1e-5
    for i in range(sq):
        n = int(ke_t[i] - ks_t[i])
        assert torch.equal(comp[i, :n], full[i, int(ks_t[i]):int(ke_t[i])]), i
        assert not comp[i, n:].any(), i


@pytest.mark.parametrize('next_n,ctx_2d', [(1, False), (2, False), (2, True)])
def test_paged_mqa_kernels_match_plain_and_each_other(gen, next_n, ctx_2d):
    """The gather entry against the plain version; the zero-copy entry
    bitwise equal to the gather entry."""
    b, h, d, bkv, mb, nb = 5, 64, 128, 64, 6, 40
    q = _fp8(gen, b, next_n, h, d)
    w = torch.rand(b * next_n, h, generator=gen, device='cuda')
    kv, sf = _fp8(gen, nb, bkv, d), torch.rand(nb, bkv, generator=gen, device='cuda')
    bt = torch.randperm(nb, generator=gen, device='cuda')[:b * mb].view(b, mb).int()
    shape = (b, next_n) if ctx_2d else (b,)
    ctx = torch.randint(next_n + 1, bkv * mb, shape, generator=gen, device='cuda',
                        dtype=torch.int32)
    ctx.view(-1)[0] = 0                                     # a free slot
    args = (q, kv, sf, w, ctx, bt, bkv * mb)
    before = dict(paged_mqa.launches)
    got = {s: paged_mqa.paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
    with plain_versions():
        want = paged_mqa.paged_mqa_logits(*args)
    torch.cuda.synchronize()
    assert paged_mqa.launches == {s: before[s] + 1 for s in before}
    _same_logits(got['gather'], want)
    assert torch.equal(got['paged'], got['gather'])


@pytest.mark.parametrize('d', [64, 128, 256])
def test_sparse_attention_kernel_matches_plain(gen, d):
    rows, t, h = 6, 300, 12
    q = _randn(gen, rows, h, d)
    k, v = _randn(gen, rows, t, h, d), _randn(gen, rows, t, h, d)
    valid = torch.rand(rows, t, generator=gen, device='cuda') > 0.3
    valid[2] = False                                        # no valid position: 0
    k[1][~valid[1]] = float('nan')                          # unselected: never read
    v[3][~valid[3]] = float('inf')
    before = sparse_attn.launches
    got = sparse_attn.gathered_attention(q, k, v, valid, d ** -0.5)
    with plain_versions():
        want = sparse_attn.gathered_attention(q, k, v, valid, d ** -0.5)
    torch.cuda.synchronize()
    assert sparse_attn.launches == before + 1
    assert torch.isfinite(got).all() and not got[2].any()
    assert calc_diff(got, want) < 1e-5


@pytest.mark.parametrize('d', [64, 128, 256])
def test_sparse_attention_paged_kernel_matches_plain_and_gather(gen, d):
    """The gather-fused entry against its plain version, and bitwise equal
    to index_select + the gathered entry on the same rows; unselected cache
    rows hold NaN/Inf and invalid tok entries point out of range."""
    rows, t, h, n = 6, 300, 12, 900
    q = _randn(gen, rows, h, d)
    k_rows, v_rows = _randn(gen, n, h, d), _randn(gen, n, h, d)
    tok = torch.randint(0, n, (rows, t), generator=gen, device='cuda', dtype=torch.int32)
    valid = torch.rand(rows, t, generator=gen, device='cuda') > 0.3
    valid[2] = False                                        # no valid position: 0
    tok[4][~valid[4]] = 10 * n                              # out of range, never read
    tok[5][~valid[5]] = -7
    unused = torch.ones(n, dtype=torch.bool, device='cuda')
    unused[tok[valid].long()] = False
    k_rows[unused] = float('nan')
    v_rows[unused] = float('inf')
    before = (sparse_attn.paged_launches, sparse_attn.launches)
    got = sparse_attn.sparse_attention_paged(q, k_rows, v_rows, tok, valid, d ** -0.5)
    with plain_versions():
        want = sparse_attn.sparse_attention_paged(q, k_rows, v_rows, tok, valid, d ** -0.5)
    flat = tok.long().clamp(0, n - 1).view(-1)
    gathered = sparse_attn.gathered_attention(
        q, k_rows.index_select(0, flat).view(rows, t, h, d),
        v_rows.index_select(0, flat).view(rows, t, h, d), valid, d ** -0.5)
    torch.cuda.synchronize()
    assert (sparse_attn.paged_launches, sparse_attn.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all() and not got[2].any()
    assert calc_diff(got, want) < 1e-5
    assert torch.equal(got, gathered)


def test_sparse_attention_paged_refuses_what_it_does_not_take(gen):
    q = _randn(gen, 2, 4, 96)
    rows = _randn(gen, 10, 4, 96)
    tok = torch.zeros(2, 8, dtype=torch.int32, device='cuda')
    valid = torch.ones(2, 8, dtype=torch.bool, device='cuda')
    with pytest.raises(ValueError, match='head_dim'):
        sparse_attn.sparse_attention_paged(q, rows, rows, tok, valid, 0.1)
    q, pages = _randn(gen, 2, 4, 64), _randn(gen, 3, 16, 8, 64)
    strided = pages[:, :, :4].reshape(-1, 4, 64)            # a copy: no view
    view = pages[:, :, :4].flatten(0, 1)                    # non-contiguous
    with pytest.raises(ValueError, match='contiguous'):
        sparse_attn.sparse_attention_paged(q, view, strided, tok, valid, 0.1)


_OPERANDS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float8_e4m3fn),
             (torch.float8_e4m3fn, torch.bfloat16)]


def _operand(gen, dtype, *shape):
    x = torch.randn(shape, generator=gen, device='cuda')
    return x.to(torch.bfloat16) if dtype == torch.bfloat16 else x.to(torch.float8_e4m3fn)


@pytest.mark.parametrize('q_dtype,kv_dtype', _OPERANDS)
def test_mqa_logits_bf16_instances_match_plain(gen, q_dtype, kv_dtype):
    sq, skv, h, d = 37, 300, 64, 128
    q, kv = _operand(gen, q_dtype, sq, h, d), _operand(gen, kv_dtype, skv, d)
    sf = torch.rand(skv, generator=gen, device='cuda') + 0.5
    w = torch.randn(sq, h, generator=gen, device='cuda')
    ks = torch.zeros(sq, dtype=torch.int32, device='cuda')
    ke = torch.randint(1, skv, (sq,), generator=gen, device='cuda', dtype=torch.int32)
    before = mqa_logits.launches
    got = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf)
    with plain_versions():
        want = mqa_logits.mqa_logits(q, kv, w, ks, ke, kv_sf=sf)
    torch.cuda.synchronize()
    assert mqa_logits.launches == before + 1
    _same_logits(got, want)


@pytest.mark.parametrize('q_dtype,kv_dtype', _OPERANDS)
def test_paged_mqa_bf16_instances_match_plain_and_each_other(gen, q_dtype, kv_dtype):
    b, nn, h, d, bkv, mb, nb = 5, 2, 64, 128, 64, 6, 40
    q = _operand(gen, q_dtype, b, nn, h, d)
    w = torch.rand(b * nn, h, generator=gen, device='cuda')
    kv, sf = _operand(gen, kv_dtype, nb, bkv, d), torch.rand(nb, bkv, generator=gen, device='cuda')
    bt = torch.randperm(nb, generator=gen, device='cuda')[:b * mb].view(b, mb).int()
    ctx = torch.randint(nn + 1, bkv * mb, (b,), generator=gen, device='cuda', dtype=torch.int32)
    args = (q, kv, sf, w, ctx, bt, bkv * mb)
    before = dict(paged_mqa.launches)
    got = {s: paged_mqa.paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
    with plain_versions():
        want = paged_mqa.paged_mqa_logits(*args)
    torch.cuda.synchronize()
    assert paged_mqa.launches == {s: before[s] + 1 for s in before}
    _same_logits(got['gather'], want)
    assert torch.equal(got['paged'], got['gather'])


@pytest.mark.parametrize('next_n,ctx_2d', [(6, False), (6, True), (5, False)])
def test_paged_mqa_any_next_n(gen, next_n, ctx_2d):
    """next_n x heads above N's 128 columns: a batch row's tokens run as
    several query groups over the same pages (3 groups of 2 of 6, 2 + 2 + 1
    of 5), against the plain version, the strategies bitwise equal."""
    b, h, d, bkv, mb, nb = 3, 64, 128, 64, 4, 16
    assert next_n * mqa_logits.query_columns(h) > 128
    q = _fp8(gen, b, next_n, h, d)
    w = torch.rand(b * next_n, h, generator=gen, device='cuda')
    kv, sf = _fp8(gen, nb, bkv, d), torch.rand(nb, bkv, generator=gen, device='cuda')
    bt = torch.randperm(nb, generator=gen, device='cuda')[:b * mb].view(b, mb).int()
    shape = (b, next_n) if ctx_2d else (b,)
    ctx = torch.randint(next_n + 1, bkv * mb, shape, generator=gen, device='cuda',
                        dtype=torch.int32)
    args = (q, kv, sf, w, ctx, bt, bkv * mb)
    got = {s: paged_mqa.paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
    with plain_versions():
        want = paged_mqa.paged_mqa_logits(*args)
    torch.cuda.synchronize()
    _same_logits(got['gather'], want)
    assert torch.equal(got['paged'], got['gather'])


def _paged_case(gen, q_dtype, kv_dtype, b=5, nn=2, h=64, d=128, bkv=64, mb=6):
    """Seeded operands of the paged entries: a shuffled block table over more
    pages than it names, ragged contexts below the cache, a free slot (row
    1: context 0), and row 0's context past the cache (mb * block_kv) in a
    window 40 columns wider."""
    nb = b * mb + 3
    q = _operand(gen, q_dtype, b, nn, h, d)
    w = torch.randn(b * nn, h, generator=gen, device='cuda')
    kv = _operand(gen, kv_dtype, nb, bkv, d)
    sf = torch.rand(nb, bkv, generator=gen, device='cuda') + 0.5
    bt = torch.randperm(nb, generator=gen, device='cuda')[:b * mb].view(b, mb).int()
    max_len = bkv * mb + 40
    ctx = torch.randint(nn + 1, bkv * mb, (b,), generator=gen, device='cuda', dtype=torch.int32)
    ctx[0], ctx[1] = max_len, 0
    return (q, kv, sf, w, ctx, bt, max_len)


def _check_paged(args, cache_cols):
    """Both entries against the plain version, bitwise each other and
    themselves on a second call; the last batch row alone bitwise its rows
    in the batch; row 0's columns past the cache (cache_cols on) exactly
    zero, as zero rows give."""
    q, kv, sf, w, ctx, bt, max_len = args
    b, nn = q.shape[:2]
    before = dict(paged_mqa.launches)
    got = {s: paged_mqa.paged_mqa_logits(*args, strategy=s) for s in paged_mqa.STRATEGIES}
    again = {s: paged_mqa.paged_mqa_logits(*args, strategy=s) for s in paged_mqa.STRATEGIES}
    i = b - 1
    alone = {s: paged_mqa.paged_mqa_logits(q[i:], kv, sf, w[i * nn:], ctx[i:], bt[i:], max_len,
                                           strategy=s) for s in paged_mqa.STRATEGIES}
    with plain_versions():
        want = paged_mqa.paged_mqa_logits(*args)
    torch.cuda.synchronize()
    assert paged_mqa.launches == {s: before[s] + 3 for s in before}
    assert paged_mqa.last_instance == (int(q.dtype == torch.bfloat16),
                                       int(kv.dtype == torch.bfloat16),
                                       mqa_logits.query_columns(q.shape[2]))
    _same_logits(got['gather'], want)
    for s in paged_mqa.STRATEGIES:
        assert torch.equal(got[s], got['gather']), s
        assert torch.equal(again[s], got[s]), s
        assert torch.equal(alone[s], got[s][i * nn:]), s
    hi = paged_mqa.row_bounds(ctx, nn)
    past = got['gather'][0, cache_cols:int(hi[0])]
    assert past.numel() > 0 and not past.any()
    assert torch.isneginf(got['gather'][nn:2 * nn]).all()          # the free slot


@pytest.mark.parametrize('q_dtype,kv_dtype', [_ALL_PAIRS[0], _ALL_PAIRS[1]])
@pytest.mark.parametrize('bkv', [16, 48, 128, 20])
def test_paged_mqa_block_kv(gen, bkv, q_dtype, kv_dtype):
    """Pages of 16, 48 and 128 tokens (TMA boxes of 16, 16 and 128 rows)
    and of 20 (not whole 8-row swizzle atoms: the zero-copy entry's
    producer warp copies the rows, while the gather entry's linearised
    cache, 120 rows a batch row, still takes boxes of 8): both entries
    against the plain version and bitwise each other, run to run, and
    batch row by batch row; columns past the cache read zero rows."""
    mb = 6
    _check_paged(_paged_case(gen, q_dtype, kv_dtype, bkv=bkv, mb=mb), bkv * mb)


@pytest.mark.parametrize('q_dtype,kv_dtype', _ALL_PAIRS)
@pytest.mark.parametrize('h', [8, 128, 256])
def test_paged_mqa_heads(gen, h, q_dtype, kv_dtype):
    """8 heads (16 queries a group: the two tokens of a row in one), 128
    (one query's N) and 256 (two n128 halves, 64-row stages) through both
    entries, as test_paged_mqa_block_kv checks them."""
    bkv, mb = 64, 6
    _check_paged(_paged_case(gen, q_dtype, kv_dtype, h=h, bkv=bkv, mb=mb), bkv * mb)


@pytest.mark.parametrize('q_dtype,kv_dtype', _ALL_PAIRS)
def test_paged_mqa_widest_operands(gen, q_dtype, kv_dtype):
    """256 heads of head_dim 256, the widest shape the entries take (a bf16
    q tile of 128 KiB: one q buffer and two stages), through both entries,
    as test_paged_mqa_block_kv checks them."""
    bkv, mb = 64, 4
    _check_paged(_paged_case(gen, q_dtype, kv_dtype, b=3, h=256, d=256, bkv=bkv, mb=mb),
                 bkv * mb)


def test_fp4_operands_and_varlen_on_the_card(gen):
    """The op layer on CUDA tensors: FP4 q with an FP4 fused byte cache runs
    the bf16 instance, against the plain versions; varlen pairing in the
    host and the device form, bitwise equal to each other and to the
    padded 2-D call; the metadata table equal to the one from the CPU."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp4
    b, h, d, bkv, mb, nb = 4, 64, 128, 64, 4, 16
    packed, psf = per_token_cast_to_fp4(_randn(gen, nb * bkv, d), use_ue8m0=True, gran_k=32,
                                        use_packed_ue8m0=True)
    fused = torch.cat([packed.view(torch.uint8).view(nb, -1),
                       psf.view(torch.uint8).view(nb, -1)], dim=1).view(nb, bkv, 1, d // 2 + 4)
    q4, q4sf = per_token_cast_to_fp4(_randn(gen, b * h, d), use_ue8m0=True, gran_k=32,
                                     use_packed_ue8m0=True)
    q4, q4sf = q4.view(b, 1, h, d // 2), q4sf.view(b, 1, h)
    w = torch.rand(b, h, generator=gen, device='cuda')
    bt = torch.randperm(nb, generator=gen, device='cuda').view(b, mb).int()
    ctx = torch.randint(2, bkv * mb, (b,), generator=gen, device='cuda', dtype=torch.int32)
    args = ((q4, q4sf), fused, w, ctx, bt, None, bkv * mb)
    before = dict(paged_mqa.launches)
    got = dgt.fp8_fp4_paged_mqa_logits(*args)
    with plain_versions():
        want = dgt.fp8_fp4_paged_mqa_logits(*args)
    torch.cuda.synchronize()
    assert paged_mqa.launches['gather'] == before['gather'] + 1
    _same_logits(got, want)

    # varlen: 4 sequences with 1-6 tokens each (6 x 64 heads: three query groups a row)
    counts = torch.tensor([6, 1, 3, 2])
    idx = torch.repeat_interleave(torch.arange(4), counts).cuda()
    rows = idx.numel()
    q8 = _fp8(gen, rows, 1, h, d)
    wv = torch.rand(rows, h, generator=gen, device='cuda')
    pos = torch.cat([torch.arange(c) for c in counts.tolist()]).cuda()
    ctxv = (ctx[idx] + pos).int()                         # each token one more than the last
    kv8, sf8 = _fp8(gen, nb, bkv, d), torch.rand(nb, bkv, generator=gen, device='cuda')
    call = lambda **kw: dgt.fp8_fp4_paged_mqa_logits(
        (q8, None), (kv8, sf8), wv, ctxv[:, None], bt[idx], None, bkv * mb, indices=idx, **kw)
    host, device = call(), call(max_batch=4, max_tokens_per_seq=6)
    q_pad = torch.zeros(4, 6, h, d, dtype=torch.uint8, device='cuda')
    q_pad[idx, pos] = q8[:, 0].view(torch.uint8)
    w_pad = torch.zeros(4 * 6, h, device='cuda')
    w_pad[idx * 6 + pos] = wv
    ctx_pad = torch.zeros(4, 6, dtype=torch.int32, device='cuda')
    ctx_pad[idx, pos] = ctxv
    padded = dgt.fp8_fp4_paged_mqa_logits(
        (q_pad.view(torch.float8_e4m3fn), None), (kv8, sf8), w_pad, ctx_pad, bt, None, bkv * mb)
    torch.cuda.synchronize()
    assert torch.equal(host, device)
    assert torch.equal(host, padded[idx * 6 + pos])
    meta = dgt.get_paged_mqa_logits_metadata(ctx, bkv, 132)
    assert meta.is_cuda and meta.shape == (133, 2)
    assert torch.equal(meta.cpu(), dgt.get_paged_mqa_logits_metadata(ctx.cpu(), bkv, 132))


def test_decode_pallas_launches_the_gather_fused_kernel(gen, monkeypatch):
    """DGT_SPARSE_GATHER=pallas: the decode launches the gather-fused kernel
    once and the gathered one never, bitwise equal to 'flat'; a head_dim
    outside the kernel's contract raises, never drops to 'flat'."""
    from deepgemm_tpu_torch.models.indexer import indexer_sparse_decode

    def case(d):
        b, h, hi, di, bkv, mb, nb = 4, 8, 8, 128, 64, 4, 16
        q = _randn(gen, b, 1, h, d)
        pages = (_randn(gen, nb, bkv, h, d), _randn(gen, nb, bkv, h, d))
        index = (_fp8(gen, nb, bkv, di), torch.rand(nb, bkv, generator=gen, device='cuda'))
        bt = torch.randperm(nb, generator=gen, device='cuda').view(b, mb).int()
        ctx = torch.randint(40, bkv * mb, (b,), generator=gen, device='cuda', dtype=torch.int32)
        return (q, pages, index, _randn(gen, b, 1, hi, di),
                torch.rand(b, hi, generator=gen, device='cuda'), ctx, bt, bkv * mb, 64)

    args = case(128)
    flat = indexer_sparse_decode(*args)
    monkeypatch.setenv('DGT_SPARSE_GATHER', 'pallas')
    before = (sparse_attn.paged_launches, sparse_attn.launches)
    fused = indexer_sparse_decode(*args)
    torch.cuda.synchronize()
    assert (sparse_attn.paged_launches, sparse_attn.launches) == (before[0] + 1, before[1])
    assert torch.equal(fused, flat)
    with pytest.raises(ValueError, match='head_dim'):
        indexer_sparse_decode(*case(96))


ENGINE = dict(max_slots=4, max_pages_per_seq=6, num_blocks=32, block_kv=64, num_heads=4,
              head_dim=128, index_heads=8, index_dim=128, topk=32)


def _token_streams(tokens):
    """Each slot's decode streams from a generator seeded by its token."""
    h, d, hi, di = (ENGINE[k] for k in ('num_heads', 'head_dim', 'index_heads', 'index_dim'))
    sizes = (h * d, hi * di, hi, h * d, h * d, di, 1)
    out = []
    for tok in tokens.tolist():
        g = torch.Generator(device='cuda').manual_seed(7919 + tok)
        out.append(torch.randn(sum(sizes), generator=g, device='cuda'))
    q, iq, iw, k, v, ik, isf = torch.split(torch.stack(out), sizes, dim=1)
    s = tokens.shape[0]
    return (q.reshape(s, h, d).bfloat16(), iq.reshape(s, hi, di).bfloat16(), iw.abs(),
            k.reshape(s, h, d).bfloat16(), v.reshape(s, h, d).bfloat16(),
            ik.clamp(-448, 448).to(torch.float8_e4m3fn), isf[:, 0].abs() + 0.5)


def _prompt(seed, t):
    h, d, di = ENGINE['num_heads'], ENGINE['head_dim'], ENGINE['index_dim']
    g = torch.Generator(device='cuda').manual_seed(seed)
    k, v = (torch.randn(t, h, d, generator=g, device='cuda').bfloat16() for _ in range(2))
    ik = torch.randn(t, di, generator=g, device='cuda').to(torch.float8_e4m3fn)
    return k, v, ik, torch.rand(t, generator=g, device='cuda') + 0.5


def _run(seqs, steps=5):
    """A fresh engine through ``steps`` decode steps; seqs: (label, seed,
    prompt length, the step it joins at). Returns the outputs by (label, step)."""
    eng = ContinuousBatcher(**ENGINE, embed_fn=_token_streams, device='cuda')
    outs, ids = {}, {}
    for step in range(steps):
        for label, seed, t, first in seqs:
            if step == first:
                ids[label] = eng.admit(t)
                eng.prefill(ids[label], *_prompt(seed, t))
        seeds = {label: seed for label, seed, _, _ in seqs}
        res = eng.step({sid: 1000 * seeds[label] + step for label, sid in ids.items()})
        for label, sid in ids.items():
            outs[label, step] = res[sid]
    return outs


def test_tiny_engine_kernels_match_plain_and_are_batch_invariant(gen):
    """A tiny engine through the kernels (paged MQA 1, sparse attention 1
    launch a step) and through their plain versions: outputs within 1e-5;
    each of two sequences alone in a fresh engine gives the same bits."""
    seqs = [('a', 1, 200, 0), ('b', 2, 90, 0), ('c', 3, 300, 2)]
    before = (paged_mqa.launches['gather'], sparse_attn.launches, mqa_logits.launches)
    outs = _run(seqs)
    torch.cuda.synchronize()
    assert (paged_mqa.launches['gather'], sparse_attn.launches, mqa_logits.launches) == (
        before[0] + 5, before[1] + 5, before[2])
    with plain_versions():
        plain = _run(seqs)
    for key, out in outs.items():
        assert torch.isfinite(out.float()).all()
        assert calc_diff(out, plain[key]) < 1e-5, key
    for alone in (seqs[0], seqs[2]):
        for key, out in _run([alone]).items():
            assert torch.equal(out, outs[key]), key


def test_tiny_engine_under_pallas_is_bitwise_flat(gen, monkeypatch):
    """The engine under DGT_SPARSE_GATHER=pallas: the gather-fused kernel once
    a step, the gathered one never, every output bitwise the 'flat' run's."""
    seqs = [('a', 1, 200, 0), ('b', 2, 90, 0), ('c', 3, 300, 2)]
    flat = _run(seqs)
    monkeypatch.setenv('DGT_SPARSE_GATHER', 'pallas')
    before = (sparse_attn.paged_launches, sparse_attn.launches)
    fused = _run(seqs)
    torch.cuda.synchronize()
    assert (sparse_attn.paged_launches, sparse_attn.launches) == (before[0] + 5, before[1])
    assert fused.keys() == flat.keys()
    for key, out in fused.items():
        assert torch.equal(out, flat[key]), key


# ---- the fused mega expert block ----------------------------------------------------

_MEGA_MODES = {'bf16': (False, False, False), 'fp8': (True, False, False),
               'fp8_act_fp8': (True, False, True), 'fp4': (True, True, False),
               'fp4_act_fp8': (True, True, True)}


def _fp4_blocks(w):
    """Per-128x128-block e2m1 codes of w [E, n, k] (planar-128 int8) and
    their f32 scales."""
    from deepgemm_tpu_torch.utils.math import _quantize_to_fp4_e2m1, pack_fp4_planar
    e, n, k = w.shape
    wf = w.float().view(e, n // 128, 128, k // 128, 128)
    sf = wf.abs().amax(dim=(2, 4)).clamp(min=1e-4) / 6.0
    codes = _quantize_to_fp4_e2m1((wf / sf[:, :, None, :, None]).view(e, n, k))
    return pack_fp4_planar(codes), sf


def _mega_case(gen, mode, e=3, cap=40, hidden=256, inter=512):
    scaled, w_fp4, act_fp8 = _MEGA_MODES[mode]
    x = _randn(gen, e, cap, hidden)
    x[:, cap - 5:] = 0                                    # empty slots
    rw = torch.rand((e, cap), generator=gen, device='cuda')
    w1 = _randn(gen, e, 2 * inter, hidden) * 0.05
    w2 = _randn(gen, e, hidden, inter) * 0.05
    if not scaled:
        return (x, None, rw, w1, None, w2, None), {}
    xq, xsf = per_token_cast_to_fp8(x.view(-1, hidden), use_ue8m0=False)
    xq, xsf = xq.view(e, cap, hidden), xsf.view(e, cap, -1)
    if w_fp4:
        (w1q, w1sf), (w2q, w2sf) = _fp4_blocks(w1), _fp4_blocks(w2)
    else:
        (w1q, w1sf), (w2q, w2sf) = quantize_experts(w1), quantize_experts(w2)
    return (xq, xsf, rw, w1q, w1sf, w2q, w2sf), dict(w_fp4=w_fp4, act_fp8=act_fp8)


@pytest.mark.parametrize('cap', [40, 100])           # one row block of 48; three, the last of 4
@pytest.mark.parametrize('mode', list(_MEGA_MODES))
def test_mega_kernel_matches_plain(gen, mode, cap):
    """Each instance against its plain version, both silu forms; the same
    call twice gives the same bits."""
    from deepgemm_tpu_torch.kernels import fused_moe
    args, kw = _mega_case(gen, mode, cap=cap)
    for silu_tanh in (False, True):
        before = fused_moe.launches[mode]
        y = fused_moe.mega_local(*args, silu_tanh=silu_tanh, **kw)
        again = fused_moe.mega_local(*args, silu_tanh=silu_tanh, **kw)
        ref = fused_moe.mega_local_plain(*args, silu_tanh=silu_tanh, **kw)
        torch.cuda.synchronize()
        assert fused_moe.launches[mode] == before + 2
        assert torch.isfinite(y.float()).all()
        assert torch.equal(y, again)
        assert calc_diff(y, ref) < 1e-5, silu_tanh


@pytest.mark.parametrize('act_fp8', [False, True])
def test_mega_kernel_fp4_is_bitwise_the_predecoded_fp8(gen, act_fp8):
    from deepgemm_tpu_torch.kernels import fused_moe
    (x, xsf, rw, w1, w1sf, w2, w2sf), _ = _mega_case(gen, 'fp4', cap=72)
    y4 = fused_moe.mega_local(x, xsf, rw, w1, w1sf, w2, w2sf, w_fp4=True, act_fp8=act_fp8)
    y8 = fused_moe.mega_local(x, xsf, rw, fused_moe.decode_fp4_planar(w1), w1sf,
                              fused_moe.decode_fp4_planar(w2), w2sf, act_fp8=act_fp8)
    torch.cuda.synchronize()
    assert torch.equal(y4, y8)


def test_mega_kernel_refusals_raise(gen):
    """A launch the card refuses (more shared memory than a block may use)
    raises from the C entry's error code; the wrapper refuses it first."""
    from deepgemm_tpu_torch.kernels import fused_moe
    from deepgemm_tpu_torch.runtime import build
    inter = 40960                     # the act scales of 48 rows overflow shared memory
    (x, _, rw, w1, _, w2, _), _ = _mega_case(gen, 'bf16', hidden=128, inter=inter)
    with pytest.raises(ValueError, match='shared memory'):
        fused_moe.mega_local(x, None, rw, w1, None, w2, None)
    y = torch.empty_like(x)
    act = torch.empty(3 * 40 * inter * 2, dtype=torch.uint8, device='cuda')
    code = fused_moe._entry()(x.data_ptr(), None, rw.data_ptr(), w1.data_ptr(), None,
                              w2.data_ptr(), None, act.data_ptr(), y.data_ptr(), 3, 40, 128,
                              inter, 0, 0, 0, 256.0, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match='CUDA error'):
        build.check(build.load('mega_local'), code, 'mega_local')


@pytest.mark.parametrize('comm', ['fused', 'xla'])
def test_one_layer_mega_forward(gen, comm):
    """The fp8 model through the mega MoE: 'fused' launches the mega kernel
    once a layer and the masked kernel never, within JAX's fused-vs-unfused
    limit of the unfused forward; 'xla' is bitwise the unfused forward."""
    from deepgemm_tpu_torch.kernels import fused_moe
    base = dict(vocab=512, hidden=256, num_layers=1, num_heads=2, head_dim=64,
                num_experts=8, topk=2, moe_intermediate=256, capacity_factor=8.0,
                use_fp8=True, use_kernels=True)
    params = tt.init_params(tt.ModelConfig(**base), seed=0)
    tokens = torch.randint(0, 512, (2, 32), generator=gen, device='cuda')
    unfused = tt.forward(params, tokens, tt.ModelConfig(**base))
    before = (dict(fused_moe.launches), dict(grouped.launches))
    mega = tt.forward(params, tokens, tt.ModelConfig(**base, use_mega=True, mega_comm=comm))
    torch.cuda.synchronize()
    if comm == 'fused':
        assert fused_moe.launches['fp8'] == before[0]['fp8'] + 1
        assert grouped.launches == before[1]
        assert calc_diff(mega, unfused) < 1e-3
    else:
        assert fused_moe.launches == before[0]
        assert torch.equal(mega, unfused)


# k = 264 in 5 splits: chunks of 53, so four splits start off a 16-byte
# boundary; n = 40 takes two n-tiles; k = 1048 is a stage tail (1048 % 128).
@pytest.mark.parametrize('m,n,k,splits', [(100, 24, 1048, None), (64, 40, 1792, 4),
                                          (33, 24, 264, 5)])
def test_hc_prenorm_kernel_matches_plain(gen, m, n, k, splits):
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import hc_prenorm
    a = _randn(gen, m, k)
    b = torch.randn((n, k), generator=gen, device='cuda')
    before = hc_prenorm.launches
    d, s = dgt.tf32_hc_prenorm_gemm(a, b, num_splits=splits)
    with plain_versions():
        d_ref, s_ref = dgt.tf32_hc_prenorm_gemm(a, b, num_splits=splits)
    whole_d, whole_s = dgt.tf32_hc_prenorm_gemm(a, b)
    torch.cuda.synchronize()
    assert hc_prenorm.launches == before + 2
    assert calc_diff(d, d_ref) < 1e-5 and calc_diff(s, s_ref) < 1e-6
    if splits:
        assert tuple(d.shape) == (splits, m, n)
        assert calc_diff(d.sum(0), whole_d) < 1e-5 and calc_diff(s.sum(0), whole_s) < 1e-6


def test_masked_kernel_f32_output(gen):
    """The f32 instance (fp8_bmm with c): the same promoted sum as the bf16
    instance, unrounded."""
    g, max_m, n, k = 3, 64, 256, 320
    a, sfa = per_token_cast_to_fp8(_randn(gen, g * max_m, k), use_ue8m0=False)
    a, sfa = a.view(g, max_m, k), sfa.view(g, max_m, -1)
    b, sfb = quantize_experts(_randn(gen, g, n, k))
    full = torch.full((g,), max_m, dtype=torch.int32, device='cuda')
    before = grouped.launches['fp8_f32']
    d32 = grouped.masked_gemm(a, b, full, sfa=sfa, sfb=sfb, out_dtype=torch.float32)
    d16 = grouped.masked_gemm(a, b, full, sfa=sfa, sfb=sfb)
    ref = grouped.masked_gemm_plain(a, b, full, sfa=sfa, sfb=sfb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert grouped.launches['fp8_f32'] == before + 1
    assert d32.dtype == torch.float32 and calc_diff(d32, ref) < 1e-5
    assert torch.equal(d16, d32.to(torch.bfloat16))


@pytest.mark.parametrize('expr', ['bhr,hdr->bhd', 'bhd,hdr->bhr', 'bhd,bhr->hdr'])
def test_fp8_einsum_kernel_matches_plain(gen, expr):
    import deepgemm_tpu_torch as dgt
    bt, h, d_dim, r = 256, 2, 128, 256
    if expr == 'bhd,bhr->hdr':
        a, b = _randn(gen, bt, h, d_dim), _randn(gen, bt, h, r)
        aq, asf = per_channel_cast_to_fp8(a.view(bt, -1), use_ue8m0=False)
        a_q = (aq.view(bt, h, d_dim), asf.view(-1, h, d_dim))
        b_q = per_block_cast_to_fp8(b.transpose(0, 1), use_ue8m0=False)
        b_q = (b_q[0].transpose(0, 1), b_q[1].transpose(0, 1))
    else:
        a = _randn(gen, bt, h, r if expr == 'bhr,hdr->bhd' else d_dim)
        aq, asf = per_token_cast_to_fp8(a.view(bt * h, -1), use_ue8m0=False)
        a_q = (aq.view(bt, h, -1), asf.view(bt, h, -1))
        b_q = per_block_cast_to_fp8(_randn(gen, h, d_dim, r), use_ue8m0=False)
    before = dict(grouped.launches)
    out = dgt.fp8_einsum(expr, a_q, b_q)
    with plain_versions():
        ref = dgt.fp8_einsum(expr, a_q, b_q)
    torch.cuda.synchronize()
    assert grouped.launches['fp8'] == before['fp8'] + 1
    assert calc_diff(out, ref) < 1e-5


def _dual_case(gen, sizes, n, k, fp8, use_psum_layout):
    """Groups of ``sizes`` rows (multiples of 128, some starting on 128 mod
    256), no padding rows."""
    m = sum(sizes)
    a, b = _randn(gen, m, k), _randn(gen, len(sizes), n, k)
    ids = torch.repeat_interleave(torch.arange(len(sizes), dtype=torch.int32),
                                  torch.tensor(sizes))
    ends = torch.tensor(sizes).cumsum(0).to(torch.int32)
    kw = {}
    if fp8:
        a, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
        b, sfb = quantize_experts(b)
        kw = dict(sfa=sfa, sfb=sfb)
    return a, b, (ends if use_psum_layout else ids).cuda(), kw


# (128, 384, 256, 256): the first 256-row tile straddles groups 0 and 1 at its
# half line; an empty group (0 rows) between two others; k = 336 a stage tail
@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_dual_b_kernel_is_bitwise_the_contiguous_kernel(gen, fp8, use_psum_layout):
    a, b, layout, kw = _dual_case(gen, (128, 384, 0, 256, 256), 192, 336, fp8, use_psum_layout)
    kw.update(use_psum_layout=use_psum_layout)
    kind = 'fp8' if fp8 else 'bf16'
    before = (dict(grouped.dual_b_launches), dict(grouped.contiguous_launches))
    d = grouped.contiguous_dual_gemm(a, b, layout, **kw)
    d3 = grouped.contiguous_gemm(a, b, layout, **kw)
    ref = grouped.contiguous_dual_gemm_plain(a, b, layout, **kw)
    torch.cuda.synchronize()
    assert grouped.dual_b_launches[kind] == before[0][kind] + 1
    assert grouped.contiguous_launches[kind] == before[1][kind] + 1
    assert torch.equal(d, d3)
    assert calc_diff(d, ref) < 1e-5


def test_dual_b_op_is_pinned_by_its_variable(gen, monkeypatch):
    import deepgemm_tpu_torch as dgt
    a, b, layout, kw = _dual_case(gen, (128, 384, 256), 128, 256, True, False)
    before = dict(grouped.dual_b_launches)
    d3 = dgt.m_grouped_fp8_gemm_nt_contiguous((a, kw['sfa']), (b, kw['sfb']),
                                              grouped_layout=layout)
    monkeypatch.setenv('DGT_GROUPED_DUAL_B', '1')
    d = dgt.m_grouped_fp8_gemm_nt_contiguous((a, kw['sfa']), (b, kw['sfb']),
                                             grouped_layout=layout)
    torch.cuda.synchronize()
    assert grouped.dual_b_launches['fp8'] == before['fp8'] + 1
    assert torch.equal(d, d3)


def test_fp4_fold_on_the_card(gen):
    """A packed FP4 B at the library's default granularity (128) runs the
    e4m3 dense kernel on the decoded codes with per-row scales: within 1e-5
    of the op's plain route (JAX's bf16 fold) and bitwise that kernel call."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.utils.math import decode_fp4_rows, per_token_cast_to_fp4
    m, n, k = 64, 256, 640
    a_q = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    b4, sf4 = per_token_cast_to_fp4(_randn(gen, n, k), use_ue8m0=True)
    before = dense.launches
    d = dgt.fp8_fp4_gemm_nt(a_q, (b4, sf4))
    with plain_versions():
        ref = dgt.fp8_fp4_gemm_nt(a_q, (b4, sf4))
    codes = decode_fp4_rows(b4, None, 128).to(torch.float8_e4m3fn)
    d_e4m3 = dense.dense_fp8_gemm_nt(a_q[0], codes, a_q[1], sf4, gran_n=1)
    torch.cuda.synchronize()
    assert dense.launches == before + 2
    assert calc_diff(d, ref) < 1e-5
    assert torch.equal(d, d_e4m3)


def test_new_ops_do_not_fall_back(gen):
    """A CPU operand beside a CUDA one raises; what the kernels do not take
    (an MN-major operand whose rows are not whole 16-byte chunks, a flat
    k-group depth off 16, an e4m3 scale granularity of 64) and what JAX
    leaves undefined (packed FP4 in the m-grouped ops) raise on the card as
    on the CPU, where they would not be silently right; an FP4 granularity
    of 32 runs the mixed kernel form."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp4
    a_q = per_token_cast_to_fp8(_randn(gen, 16, 256), use_ue8m0=False)
    b4 = per_token_cast_to_fp4(_randn(gen, 128, 256), use_ue8m0=True)
    with pytest.raises(ValueError, match='several devices'):
        dgt.fp8_fp4_gemm_nt(a_q, tuple(t.cpu() for t in b4))
    with pytest.raises(ValueError, match='several devices'):
        dgt.tf32_hc_prenorm_gemm(_randn(gen, 16, 256), torch.randn(24, 256))
    b32 = per_token_cast_to_fp4(_randn(gen, 128, 256), use_ue8m0=True, gran_k=32)
    dense.form_launches.clear()
    dgt.fp8_fp4_gemm_nt(a_q, b32)
    assert dense.form_launches == {'promote_nt_mixed': 1}
    with pytest.raises(TypeError, match='undefined'):
        dgt.m_grouped_fp8_fp4_gemm_nt_masked(
            (a_q[0][None], a_q[1][None]), (b4[0][None], b4[1][None]),
            masked_m=torch.ones(1, dtype=torch.int32, device='cuda'),
            recipe_a=(1, 128), recipe_b=(1, 128))
    b_q = per_block_cast_to_fp8(_randn(gen, 40, 256), use_ue8m0=False)
    with pytest.raises(ValueError, match='16-byte'):          # n = 40 e4m3: 40-byte rows
        dgt.fp8_gemm_nn(a_q, (b_q[0].t().contiguous(), b_q[1].t().contiguous()))
    a64 = per_token_cast_to_fp8(_randn(gen, 16, 256), use_ue8m0=False, gran_k=64)
    with pytest.raises(NotImplementedError, match='gran_k 64'):
        dgt.fp8_gemm_nt(a64, b_q, recipe_a=(1, 64), recipe_b=(128, 128))
    ks = [24, 104]
    flat = lambda dim: torch.zeros(dim * sum(ks), device='cuda').to(torch.float8_e4m3fn)
    sf = lambda dim: torch.ones((dim, 2), device='cuda')
    with pytest.raises(ValueError, match='multiple of 16'):
        dgt.k_grouped_fp8_gemm_nt_contiguous((flat(64), sf(64)), (flat(128), sf(128)), ks=ks,
                                             c=torch.zeros((2, 64, 128), device='cuda'))


# ---- the rest of the one-card GEMM surface ----------------------------------------


def _t8(x):
    """An e4m3 matrix transposed into a new contiguous tensor."""
    return x.view(torch.uint8).t().contiguous().view(x.dtype)


def _dense_case(gen, m, n, k, gran_n=128, po2=False):
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=po2)
    cast = per_block_cast_to_fp8 if gran_n == 128 else per_token_cast_to_fp8
    bq, sfb = cast(_randn(gen, n, k), use_ue8m0=po2)
    return aq, bq, sfa, sfb


@pytest.mark.parametrize('strategy', ['promote', 'dequant'])
@pytest.mark.parametrize('layout', ['nn', 'tn', 'tt'])
def test_dense_layouts_are_bitwise_nt_on_transposes(gen, layout, strategy):
    """Each layout's kernel is the NT kernel on the operands transposed with
    .t().contiguous(): the same bits; each against its plain version."""
    m, n, k = 80, 192, 400
    aq, bq, sfa, sfb = _dense_case(gen, m, n, k, po2=strategy == 'dequant')
    a_mn, b_mn = layout[0] == 't', layout[1] == 'n'
    a_op = _t8(aq) if a_mn else aq
    b_op = _t8(bq) if b_mn else bq
    dense.form_launches.clear()
    for out in (torch.bfloat16, torch.float32):
        kw = dict(out_dtype=out, strategy=strategy)
        d = dense.dense_gemm(a_op, b_op, sfa, sfb, a_mn=a_mn, b_mn=b_mn, **kw)
        d_nt = dense.dense_gemm(aq, bq, sfa, sfb, **kw)
        ref = dense.dense_gemm_plain(a_op, b_op, sfa, sfb, a_mn=a_mn, b_mn=b_mn, **kw)
        torch.cuda.synchronize()
        assert torch.equal(d, d_nt), out
        assert calc_diff(d, ref) < 1e-5, out
    assert dense.form_launches == {f'{strategy}_{layout}': 2, f'{strategy}_nt': 2}


@pytest.mark.parametrize('layout', ['nn', 'tn', 'tt'])
def test_dense_mn_major_copies_count_as_dense(gen, layout):
    """An MN-major operand of the dense kernel is made k-major by the dense
    library's copy of the relayout (csrc/relayout.cuh), counted under
    'dense', one launch an MN-major operand, none under 'k_grouped'."""
    aq, bq, sfa, sfb = _dense_case(gen, 80, 192, 400)
    a_mn, b_mn = layout[0] == 't', layout[1] == 'n'
    common.relayout_launches.update(dense=0, k_grouped=0)
    dense.dense_gemm(_t8(aq) if a_mn else aq, _t8(bq) if b_mn else bq, sfa, sfb, a_mn=a_mn,
                     b_mn=b_mn)
    torch.cuda.synchronize()
    assert common.relayout_launches == {'dense': a_mn + b_mn, 'k_grouped': 0}


@pytest.mark.parametrize('recipe', [(1, 128, 128), (1, 1, 128)])
def test_c_accumulation_on_the_card(gen, recipe):
    """c is added once to the finished f32 sum: in f32 the kernel's output
    with c is bitwise its output without c plus c; in bf16 the same sum
    rounded; the wgrad recipe with d = c = c."""
    import deepgemm_tpu_torch as dgt
    m, n, k = 96, 256, 384
    aq, bq, sfa, sfb = _dense_case(gen, m, n, k, gran_n=recipe[1])
    c = torch.randn((m, n), generator=gen, device='cuda') * 32
    d32 = dgt.fp8_gemm_nt((aq, sfa), (bq, sfb), d=c, c=c, recipe=recipe)
    d16 = dgt.fp8_gemm_nt((aq, sfa), (bq, sfb), c=c, recipe=recipe)
    plain = dgt.fp8_gemm_nt((aq, sfa), (bq, sfb), d=torch.float32, recipe=recipe)
    with plain_versions():
        ref = dgt.fp8_gemm_nt((aq, sfa), (bq, sfb), d=c, c=c, recipe=recipe)
    torch.cuda.synchronize()
    assert torch.equal(d32, plain + c)
    assert torch.equal(d16, (plain + c).to(torch.bfloat16))
    assert calc_diff(d32, ref) < 1e-5


@pytest.mark.parametrize('gran_n', [128, 1])
@pytest.mark.parametrize('m,n,k', [(128, 256, 1024), (48, 264, 1104)])
def test_dequant_kernel_matches_plain_and_promote(gen, m, n, k, gran_n):
    """'dequant' on power-of-two scales: against its plain version, and
    within 1e-5 of 'promote' on the same operands (other sums, not bits)."""
    aq, bq, sfa, sfb = _dense_case(gen, m, n, k, gran_n=gran_n, po2=True)
    d = dense.dense_gemm(aq, bq, sfa, sfb, gran_n=gran_n, strategy='dequant')
    ref = dense.dense_gemm_plain(aq, bq, sfa, sfb, gran_n=gran_n, strategy='dequant')
    promote = dense.dense_gemm(aq, bq, sfa, sfb, gran_n=gran_n)
    torch.cuda.synchronize()
    assert calc_diff(d, ref) < 1e-5 and calc_diff(d, promote) < 1e-5


# UE8M0 exponents at bf16's limits: 2^-127 and 2^-126 (widened values
# subnormal or flushed), 2^-100, 2^100 and 2^127 (products past f32's range,
# widened values past bf16's)
EXTREME_EXPONENTS = (-127, -126, -120, -100, -27, 0, 27, 100, 120, 127)


def _extreme_case(seed, m, k, device):
    """e4m3 codes [m, k] (every finite code; a third of them subnormal) with
    one power-of-two scale a 128-deep block from EXTREME_EXPONENTS, numpy
    seeded."""
    import numpy as np
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 256, size=(m, k)).astype(np.uint8)
    codes[rng.rand(m, k) < 1 / 3] &= 0x87                 # exponent field 0: subnormal or zero
    codes[(codes & 0x7F) == 0x7F] = 0x38                  # no NaN codes
    exps = rng.choice(EXTREME_EXPONENTS, size=(m, k // 128)).astype(np.float32)
    x = torch.from_numpy(codes).view(torch.float8_e4m3fn).to(device)
    return x, torch.from_numpy(np.exp2(exps)).to(device)


def _identity_e4m3(n, device):
    """The e4m3 identity [n, n] (code 0x38 is 1.0)."""
    return torch.eye(n, device=device).to(torch.float8_e4m3fn)


def _subnormal(x):
    return (x != 0) & (x.abs() < 2.0 ** -126)


def _checkered(rows, cols, device):
    """Scales 2^100 and 2^-100 in turns along rows and columns."""
    i = torch.arange(rows, device=device)[:, None] + torch.arange(cols, device=device)
    return torch.where(i % 2 == 0, 2.0 ** 100, 2.0 ** -100)


@pytest.mark.parametrize('form', ['e4m3', 'mixed'])
@pytest.mark.parametrize('gran_n', [1, 128])
@pytest.mark.parametrize('side', ['a', 'b'])
def test_dequant_extreme_ue8m0_scales_on_the_card(gen, side, gran_n, form):
    """'dequant' at UE8M0 exponents near bf16's limits and on subnormal e4m3
    codes: one operand (``side``) random codes with extreme scales, the other
    the identity (e4m3 with scales 2^100 and 2^-100, or bf16 times 2^100:
    'mixed'), so each output is one product: bitwise the plain version
    wherever that is not an f32 subnormal (NaN where it is NaN: an infinite
    widened value times the identity's zeros); where it is, the kernel's the
    same or a flushed zero (the tensor cores' f32 products)."""
    m = n = k = 256
    x, sx = _extreme_case(1 + (side == 'b'), m, k, 'cuda')
    eye = _identity_e4m3(k, 'cuda')
    s_eye = _checkered(k, k // 128, 'cuda')
    if form == 'mixed':
        eye, s_eye = eye.to(torch.bfloat16) * 2.0 ** 100, None
    if side == 'a':
        a, sfa, b, sfb = x, sx, eye, s_eye
    else:
        a, sfa, b, sfb = eye, s_eye, x, sx
    if gran_n == 128 and sfb is not None:
        # one scale a 128 x 128 block (x's: subnormal widened codes, products
        # past f32's range, flushed products; one at 2^120 or 2^127 would
        # turn every output it meets to NaN)
        sfb = (torch.tensor([[2.0 ** -127, 2.0 ** 100], [2.0 ** 27, 2.0 ** -120]], device='cuda')
               if side == 'b' else sfb[::128].contiguous())
    kw = dict(gran_n=gran_n, out_dtype=torch.float32, strategy='dequant')
    d = dense.dense_gemm(a, b, sfa, sfb, **kw)
    ref = dense.dense_gemm_plain(a, b, sfa, sfb, **kw)
    torch.cuda.synchronize()
    sub = _subnormal(ref)
    torch.testing.assert_close(d[~sub] + 0, ref[~sub] + 0, rtol=0, atol=0, equal_nan=True)
    assert ((d[sub] == ref[sub]) | (d[sub] == 0)).all()
    assert torch.isinf(ref).any() and (ref == 0).any() and (torch.isfinite(ref) & (ref != 0)).any()


def test_planar_fp4_b_in_the_kernel_is_bitwise_the_decoded_e4m3(gen):
    """Planar FP4 B decoded in the kernel is bitwise the e4m3 kernel on the
    decoded codes with B's (1, 128) scales per row, and the ops' three FP4
    routes give the same bits."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp4, repack_fp4_to_planar
    m, n, k = 48, 256, 768
    aq, sfa = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    b4, sf4 = per_token_cast_to_fp4(_randn(gen, n, k), use_ue8m0=True)
    planar = repack_fp4_to_planar(b4)
    dense.form_launches.clear()
    d = dense.dense_gemm(aq, planar, sfa, sf4, gran_n=1, fp4_b=True)
    codes = dense._decode_planar(planar)
    d_e4m3 = dense.dense_gemm(aq, codes, sfa, sf4, gran_n=1)
    ref = dense.dense_gemm_plain(aq, planar, sfa, sf4, gran_n=1, fp4_b=True)
    kw = dict(recipe_a=(1, 128), recipe_b=(1, 128))
    routes = [dgt.fp8_fp4_gemm_nt((aq, sfa), (planar, sf4), fp4_layout=f, **kw)
              for f in ('planar_in_kernel', 'planar_fold')] + [
              dgt.fp8_fp4_gemm_nt((aq, sfa), (b4, sf4), **kw)]
    torch.cuda.synchronize()
    assert dense.form_launches['promote_nt_fp4'] == 2
    assert torch.equal(d, d_e4m3) and calc_diff(d, ref) < 1e-5
    assert all(torch.equal(r, d) for r in routes)


@pytest.mark.parametrize('sms', [None, 1])
@pytest.mark.parametrize('m,n,k,gran_n', [(64, 192, 512, 128), (40, 200, 336, 1),
                                           (130, 264, 1040, 128)])
@pytest.mark.parametrize('strategy', ['promote', 'dequant'])
@pytest.mark.parametrize('bf16_side', ['none', 'a', 'b', 'both'])
def test_mixed_forms_match_plain(gen, monkeypatch, strategy, bf16_side, m, n, k, gran_n, sms):
    """Every form on bf16 products (csrc/dense_dequant.cu): e4m3 x e4m3
    'dequant' (beside the 'promote' kernel), an e4m3 operand beside a bf16
    one (a folded FP4 operand at scale granularity 32 or 64) under either
    strategy, and two bf16 operands; at ragged shapes (m < 64, n past a
    whole tile, a k tail shorter than a block), B's scales per 128 rows or
    per row, with and without c, in both outputs: against the plain version,
    one launch of its form each, a second launch bitwise the first. At these
    shapes the tile chooser takes 64 x 64 tiles; told of one SM (``sms``) it
    takes 64 x 128 and 128 x 128 ones, which one block then walks."""
    if sms is not None:
        monkeypatch.setattr(dense, 'get_num_sms', lambda device: sms)
    aq, bq, sfa, sfb = _dense_case(gen, m, n, k, gran_n=gran_n, po2=True)
    a, b = _randn(gen, m, k), _randn(gen, n, k)
    c = torch.randn((m, n), generator=gen, device='cuda') * 8
    a_op, sfa_op = (a, None) if bf16_side in ('a', 'both') else (aq, sfa)
    b_op, sfb_op = (b, None) if bf16_side in ('b', 'both') else (bq, sfb)
    for out in (torch.bfloat16, torch.float32):
        for c_op in (None, c):
            kw = dict(c=c_op, gran_n=gran_n, out_dtype=out, strategy=strategy)
            dense.form_launches.clear()
            d = dense.dense_gemm(a_op, b_op, sfa_op, sfb_op, **kw)
            assert dense.form_launches == {dense.form_of(a_op, b_op, strategy=strategy, c=c_op): 1}
            again = dense.dense_gemm(a_op, b_op, sfa_op, sfb_op, **kw)
            ref = dense.dense_gemm_plain(a_op, b_op, sfa_op, sfb_op, **kw)
            torch.cuda.synchronize()
            assert calc_diff(d, ref) < 1e-5, (out, c_op is None)
            assert torch.equal(d, again), (out, c_op is None)


@pytest.mark.parametrize('gran', [32, 64])
def test_fp4_fine_granularity_on_the_card(gen, gran):
    """FP4 B at gran 32 / 64 through the op: the mixed form, against the op's
    plain route (JAX's bf16 fold) and the dequantized product."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.utils.math import cast_back_from_fp4, per_token_cast_to_fp4
    m, n, k = 64, 256, 512
    a_q = per_token_cast_to_fp8(_randn(gen, m, k), use_ue8m0=False)
    b4 = per_token_cast_to_fp4(_randn(gen, n, k), use_ue8m0=True, gran_k=gran)
    dense.form_launches.clear()
    d = dgt.fp8_fp4_gemm_nt(a_q, b4)
    with plain_versions():
        ref = dgt.fp8_fp4_gemm_nt(a_q, b4)
    torch.cuda.synchronize()
    assert dense.form_launches == {'promote_nt_mixed': 1}
    assert calc_diff(d, ref) < 1e-5
    exact = (a_q[0].float() * a_q[1].repeat_interleave(128, 1)[:, :k]) @ \
        cast_back_from_fp4(*b4, gran_k=gran).t()
    assert calc_diff(d, exact) < 1e-5


@pytest.mark.parametrize('fp8', [False, True])
@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_contiguous_nn_is_bitwise_nt_on_transposes(gen, fp8, use_psum_layout):
    a, b, layout, kw = _dual_case(gen, (128, 384, 0, 256), 192, 336, fp8, use_psum_layout)
    kw.update(use_psum_layout=use_psum_layout, ensure_zero_padding=True)
    b_nn = (b.view(torch.uint8) if fp8 else b).transpose(1, 2).contiguous().view(b.dtype)
    kind = 'fp8' if fp8 else 'bf16'
    before = dict(grouped.contiguous_nn_launches)
    d = grouped.contiguous_gemm(a, b_nn, layout, b_mn=True, **kw)
    d_nt = grouped.contiguous_gemm(a, b, layout, **kw)
    ref = grouped.contiguous_gemm_plain(a, b_nn, layout, b_mn=True, **kw)
    torch.cuda.synchronize()
    assert grouped.contiguous_nn_launches[kind] == before[kind] + 1
    assert torch.equal(d, d_nt)
    assert calc_diff(d, ref) < 1e-5


@pytest.mark.parametrize('with_c', [False, True])
def test_k_grouped_flat_is_bitwise_tn(gen, with_c):
    """The flat NT form reads each group in place: bitwise the TN kernel on
    the same data (an empty group, a depth off 128, c or none)."""
    from deepgemm_tpu_torch.kernels.k_grouped import unflatten_k_major
    ks, m, n = [256, 0, 144, 384], 96, 200
    a, b, layout, kw = _k_grouped_case(gen, ks, m, n, True, False)
    flat = lambda x: torch.cat([x[s:s + kg].view(torch.uint8).t().contiguous().view(-1)
                                for s, kg in zip([0, 256, 256, 400], ks)]).view(x.dtype)
    a_f, b_f = flat(a), flat(b)
    assert torch.equal(unflatten_k_major(a_f, ks, m).view(torch.uint8),
                       a[:sum(ks)].view(torch.uint8))
    c = torch.randn((len(ks), m, n), generator=gen, device='cuda') if with_c else None
    before = k_grouped.flat_launches
    d = k_grouped.k_grouped_gemm_flat(a_f, b_f, ks, m, n, c, kw['sfa'], kw['sfb'])
    d_tn = k_grouped.k_grouped_gemm(a, b, layout, c, **kw)
    ref = k_grouped.k_grouped_gemm_flat_plain(a_f, b_f, ks, m, n, c, kw['sfa'], kw['sfb'])
    torch.cuda.synchronize()
    assert k_grouped.flat_launches == before + 1
    assert torch.equal(d, d_tn) and calc_diff(d, ref) < 1e-5


# ---- the Hopper mainloop (csrc/gemm_sm90.cuh): dense and k-grouped ----------


@pytest.mark.parametrize('m,n,k,gran,out,with_c', [
    (1, 192, 16, 128, torch.bfloat16, False),
    (16, 7170, 400, 1, torch.float32, True),
    (80, 192, 7168, 128, torch.float32, True),
    (2049, 7170, 400, 1, torch.bfloat16, True),      # 17 x 57 tiles: the persistent walk wraps
    (2049, 192, 16, 1, torch.float32, False),
    (80, 7170, 16, 128, torch.bfloat16, False),
    (16, 192, 7168, 1, torch.bfloat16, False),
    (1, 7170, 7168, 1, torch.float32, True),
])
def test_hopper_dense_matches_plain_at_ragged_shapes(gen, m, n, k, gran, out, with_c):
    """The wgmma mainloop against its plain version at ragged m, n and k
    (m below one 64-row tile, n off whole 16-byte output rows, k below one
    128-deep block), per-block and per-channel B scales, bf16 and f32 out,
    with c: within 1e-5; c added once to the finished sum (bitwise); the
    same bits on a second launch."""
    aq, bq, sfa, sfb = _dense_case(gen, m, n, k, gran_n=gran)
    c = torch.randn((m, n), generator=gen, device='cuda') * 32 if with_c else None
    dense.form_launches.clear()
    d = dense.dense_gemm(aq, bq, sfa, sfb, c=c, gran_n=gran, out_dtype=out)
    again = dense.dense_gemm(aq, bq, sfa, sfb, c=c, gran_n=gran, out_dtype=out)
    ref = dense.dense_gemm_plain(aq, bq, sfa, sfb, c=c, gran_n=gran, out_dtype=out)
    torch.cuda.synchronize()
    assert dense.form_launches == {'promote_nt+c' if with_c else 'promote_nt': 2}
    assert calc_diff(d, ref) < 1e-5
    assert torch.equal(d, again)
    if with_c:
        d32 = dense.dense_gemm(aq, bq, sfa, sfb, gran_n=gran, out_dtype=torch.float32)
        assert torch.equal(d, (d32 + c).to(out))


@pytest.mark.parametrize('sizes,m,n', [([0, 16, 144, 384], 96, 200), ([128] * 256, 512, 512)])
@pytest.mark.parametrize('with_c', [False, True])
def test_hopper_k_grouped_matches_plain(gen, sizes, m, n, with_c):
    """The FP8 k-grouped kernel (the wgmma mainloop, persistent over group
    tiles) at uneven depths (an empty group, one of 16, depths off 128) and
    at the training step's 256 groups of 128, with c or none: within 1e-5
    of the plain version, the same bits on a second launch, bf16 the f32
    sum rounded once, and the flat form bitwise the TN one."""
    from deepgemm_tpu_torch.kernels.k_grouped import unflatten_k_major
    a, b, layout, kw = _k_grouped_case(gen, sizes, m, n, True, False)
    c = torch.randn((len(sizes), m, n), generator=gen, device='cuda') if with_c else None
    starts = [sum(sizes[:g]) for g in range(len(sizes))]
    flat = lambda x: torch.cat([x[s:s + kg].view(torch.uint8).t().contiguous().view(-1)
                                for s, kg in zip(starts, sizes)]).view(x.dtype)
    a_f, b_f = flat(a), flat(b)
    assert torch.equal(unflatten_k_major(a_f, sizes, m).view(torch.uint8),
                       a[:sum(sizes)].view(torch.uint8))
    before = (dict(k_grouped.launches), k_grouped.flat_launches)
    d = k_grouped.k_grouped_gemm(a, b, layout, c, **kw)
    again = k_grouped.k_grouped_gemm(a, b, layout, c, **kw)
    d16 = k_grouped.k_grouped_gemm(a, b, layout, c, out_dtype=torch.bfloat16, **kw)
    d_flat = k_grouped.k_grouped_gemm_flat(a_f, b_f, sizes, m, n, c, kw['sfa'], kw['sfb'])
    ref = k_grouped.k_grouped_gemm_plain(a, b, layout, c, **kw)
    torch.cuda.synchronize()
    assert k_grouped.launches['fp8'] == before[0]['fp8'] + 3
    assert k_grouped.flat_launches == before[1] + 1
    assert calc_diff(d, ref) < 1e-5
    assert torch.equal(d, again) and torch.equal(d16, d.to(torch.bfloat16))
    assert torch.equal(d_flat, d)


@pytest.mark.parametrize('use_psum_layout', [False, True])
def test_k_major_relayout_kernel_is_bitwise_plain(gen, use_psum_layout):
    """The transposing gather that lays the TN operands out for the FP8
    k-grouped kernel (group g at column 128 sf_start[g], zeros elsewhere):
    bitwise its plain version, on rows of whole 16-byte chunks and not."""
    for dim in (200, 7170):
        x, _, layout, kw = _k_grouped_case(gen, (200, 0, 37, 256), dim, 64, True,
                                           use_psum_layout)
        before = common.relayout_launches['k_grouped']
        nsf = kw['sfa'].shape[0]
        got = k_grouped.tn_relayout(x, x, layout, nsf, use_psum_layout)
        with plain_versions():
            want = k_grouped.tn_relayout(x, x, layout, nsf, use_psum_layout)
        torch.cuda.synchronize()
        assert common.relayout_launches['k_grouped'] == before + 2
        assert got[4] == want[4] == 128 * nsf
        for g_, w_ in zip(got[:2], want[:2]):
            assert torch.equal(g_.view(torch.uint8), w_.view(torch.uint8)), dim


def test_training_step_forms_launch_the_hopper_kernels(gen):
    """The six dense calls of a training step (forward and dgrad with 128 x
    128 block scales, bf16 out; wgrad per-channel, f32 out) are the NT
    'promote' form, which runs the wgmma mainloop (csrc/dense.cu), the four
    contiguous calls (the experts' forward and dgrad) its e4m3 NT form on
    128-row tiles (csrc/contiguous.cu), and the two wgrad calls the FP8
    k-grouped kernel with its two relayouts."""
    base = dict(vocab=512, hidden=256, num_layers=1, num_heads=2, head_dim=64,
                num_experts=8, topk=2, moe_intermediate=256, capacity_factor=7.9,
                use_fp8_training=True, use_kernels=True)
    cfg = tt.ModelConfig(**base)
    params = tt.init_params(cfg, seed=0)
    tokens, targets = (torch.randint(0, 512, (2, 32), generator=gen, device='cuda')
                       for _ in range(2))
    dense.form_launches.clear()
    grouped.contiguous_form_launches.clear()
    k_grouped.launches.update(bf16=0, fp8=0)
    common.relayout_launches.update(dense=0, k_grouped=0)
    tt.train_step(params, tokens, targets, cfg, lr=5e-2)
    torch.cuda.synchronize()
    assert dense.form_launches == {'promote_nt': 6}
    assert grouped.contiguous_form_launches == {'wgmma_nt_fp8_m128': 4}
    assert k_grouped.launches == {'bf16': 0, 'fp8': 2}
    assert common.relayout_launches == {'dense': 0, 'k_grouped': 4}


# ---- the expert-parallel tier on [cuda:0] * D (and on D cards) -------------

def _ep_devices(placement, d):
    """The ranks' devices: all on card 0, or one card each (skips unless the
    machine has d cards)."""
    if placement == 'one card':
        return ['cuda:0'] * d
    if torch.cuda.device_count() < d:
        pytest.skip(f'needs {d} cards for one rank a card; this machine has '
                    f'{torch.cuda.device_count()}')
    return [f'cuda:{i}' for i in range(d)]


def _ep_mesh(placement, d, timeout=30.0):
    from deepgemm_tpu_torch.parallel import dist
    return dist.make_mesh([('ep', d)], _ep_devices(placement, d), timeout=timeout)


def _on(devices, t):
    return [t[i].to(dev) for i, dev in enumerate(devices)]


@pytest.mark.parametrize('placement', ['one card', 'cards'])
@pytest.mark.parametrize('d', [1, 2, 4])
def test_a2a_kernel_is_bitwise_the_all_to_all(gen, d, placement):
    """#15 bitwise the mesh's host all-to-all on every rank, on three
    back-to-back calls with other inputs (the receive buffer reused), for a
    bf16 slot payload and its f32 weight sideband (4-byte words)."""
    from deepgemm_tpu_torch.parallel import collectives, dist
    mesh = _ep_mesh(placement, d)
    for call in range(3):
        x = _randn(gen, d, d, 3, 40, 256)
        w = torch.rand((d, d, 3, 40), generator=gen, device='cuda')
        before = collectives.launches
        outs = mesh.map(lambda a, b: (collectives.pallas_all_to_all(a, 'ep'),
                                      collectives.pallas_all_to_all(b, 'ep'),
                                      dist.all_to_all(a, 'ep'), dist.all_to_all(b, 'ep')),
                        _on(mesh.devices, x), _on(mesh.devices, w))
        torch.cuda.synchronize()
        assert collectives.launches == before + 2 * d
        for r, (ka, kb, ha, hb) in enumerate(outs):
            assert torch.equal(ka, ha) and torch.equal(kb, hb), (call, r)
            assert torch.equal(ka[0].cpu(), x[0, r].cpu())


@pytest.mark.parametrize('placement', ['one card', 'cards'])
@pytest.mark.parametrize('d,fp8,cap', [(1, True, 40), (2, True, 40), (4, True, 40),
                                       (4, False, 40), (2, True, 18), (2, False, 18)])
def test_dispatch_gemm_kernel_is_bitwise_the_masked_kernel(gen, d, fp8, cap, placement):
    """#12: recv bitwise the all-to-all; out bitwise the masked kernel on
    recv, and within 1e-5 of the plain version. Its row tiles span slabs;
    at cap 18 a slab's rows are not whole 8-row atoms and its k-first scale
    columns not whole 16-byte chunks."""
    from deepgemm_tpu_torch.kernels import fused_moe
    from deepgemm_tpu_torch.parallel import dist
    mesh = _ep_mesh(placement, d)
    e_local, n, h = 2, 256, 256
    x = _randn(gen, d, d, e_local, cap, h)
    w = _randn(gen, d, e_local, n, h) * 0.05
    if fp8:
        xq, xsf = per_token_cast_to_fp8(x.view(-1, h), use_ue8m0=False)
        xq, xsf = xq.view(x.shape), xsf.view(*x.shape[:-1], -1)
        wq, wsf = quantize_experts(w.view(-1, n, h))
        wq, wsf = wq.view(d, e_local, n, h), wsf.view(d, e_local, n // 128, -1)
    else:
        xq, xsf, wq, wsf = x, None, w, None

    def rank(s, ssf, ww, wwsf):
        out, recv = fused_moe.fused_dispatch_gemm(s, ww, send_sf=ssf, w_sf=wwsf)
        want_recv = dist.all_to_all(s, 'ep')
        a = want_recv.transpose(0, 1).reshape(e_local, d * cap, h)
        sfa = None
        if ssf is not None:
            sfa = dist.all_to_all(ssf, 'ep').transpose(0, 1).reshape(e_local, d * cap, -1)
        masked = grouped.masked_gemm(a, ww, torch.full((e_local,), d * cap, dtype=torch.int32,
                                                       device=s.device), sfa=sfa, sfb=wwsf)
        return out, recv, want_recv, masked.view(e_local, d, cap, n)

    none = [None] * d
    args = (_on(mesh.devices, xq), none if xsf is None else _on(mesh.devices, xsf),
            _on(mesh.devices, wq), none if wsf is None else _on(mesh.devices, wsf))
    before = dict(fused_moe.dispatch_launches)
    outs = mesh.map(rank, *args)
    torch.cuda.synchronize()
    kind = 'fp8' if fp8 else 'bf16'
    assert fused_moe.dispatch_launches[kind] == before[kind] + d
    with plain_versions():
        plains = mesh.map(lambda s, ssf, ww, wwsf: fused_moe.fused_dispatch_gemm(
            s, ww, send_sf=ssf, w_sf=wwsf)[0], *args)
    for (out, recv, want_recv, masked), plain in zip(outs, plains):
        assert torch.equal(recv.view(torch.uint8), want_recv.view(torch.uint8))
        assert torch.equal(out, masked)
        assert calc_diff(out, plain) < 1e-5


def _ep_mega_inputs(gen, mode, d, e_local=2, cap=40, hidden=256, inter=512):
    """Per-rank inputs of the general kernel in ``mode``: send [D*D, E, cap,
    H] (rank r's slabs r*D .. r*D+D-1), its scales, rw_steps, and D ranks'
    expert weights [D*E, ...]."""
    scaled, w_fp4, act_fp8 = _MEGA_MODES[mode]
    x = _randn(gen, d * d, e_local, cap, hidden)
    x[..., cap - 5:, :] = 0
    rw = torch.rand((d * d, e_local, cap), generator=gen, device='cuda')
    w1 = _randn(gen, d * e_local, 2 * inter, hidden) * 0.05
    w2 = _randn(gen, d * e_local, hidden, inter) * 0.05
    if not scaled:
        return x, None, rw, (w1, None, w2, None), {}
    xq, xsf = per_token_cast_to_fp8(x.view(-1, hidden), use_ue8m0=False)
    xq, xsf = xq.view(x.shape), xsf.view(*x.shape[:-1], -1)
    if w_fp4:
        (w1q, w1sf), (w2q, w2sf) = _fp4_blocks(w1), _fp4_blocks(w2)
    else:
        (w1q, w1sf), (w2q, w2sf) = quantize_experts(w1), quantize_experts(w2)
    return xq, xsf, rw, (w1q, w1sf, w2q, w2sf), dict(w_fp4=w_fp4, act_fp8=act_fp8)


def _run_mega_ep(mesh, send, send_sf, rw, weights, kw, pool, force=False):
    from deepgemm_tpu_torch.kernels import fused_moe
    d = mesh.size
    e_local = send.shape[1]
    cut = lambda t, n: None if t is None else [t[r * n:(r + 1) * n].to(dev)
                                               for r, dev in enumerate(mesh.devices)]
    w1, w1sf, w2, w2sf = weights
    silu_tanh = send_sf is not None and not kw.get('act_fp8', False)

    def rank(s, ssf, r, a1, b1, a2, b2):
        xsf = None if ssf is None else ssf.float()
        return fused_moe.mega_ep(s, xsf, r, a1, b1, a2, b2, pool=pool, silu_tanh=silu_tanh,
                                 **kw)

    none = [None] * d
    return mesh.map(rank, cut(send, d), cut(send_sf, d) or none, cut(rw, d),
                    cut(w1, e_local), cut(w1sf, e_local) or none, cut(w2, e_local),
                    cut(w2sf, e_local) or none)


@pytest.mark.parametrize('placement', ['one card', 'cards'])
@pytest.mark.parametrize('d,mode', [(1, 'fp8'), (2, 'fp8'), (4, 'fp8'), (4, 'bf16'),
                                    (4, 'fp8_act_fp8'), (2, 'fp4'), (2, 'fp4_act_fp8')])
def test_mega_ep_kernel_is_bitwise_the_one_rank_kernel(gen, d, mode, placement):
    """#14: each rank's combine slab from rank s bitwise the one-rank kernel
    (#13) on the rows it sent to s; pools 1 .. D bitwise each other; within
    1e-5 of the plain version; FP4 bitwise the decoded fp8; at D = 1 the
    general kernel (force_general) bitwise the one-rank kernel."""
    from deepgemm_tpu_torch.kernels import fused_moe
    mesh = _ep_mesh(placement, d)
    send, send_sf, rw, weights, kw = _ep_mega_inputs(gen, mode, d)
    e_local = send.shape[1]
    silu_tanh = send_sf is not None and not kw.get('act_fp8', False)
    before = dict(fused_moe.ep_launches)
    pools = {p: _run_mega_ep(mesh, send, send_sf, rw, weights, kw, p)
             for p in (1, 2, 4) if d % p == 0}
    torch.cuda.synchronize()
    assert fused_moe.ep_launches[mode] == before[mode] + d * len(pools)
    with plain_versions():
        plain = _run_mega_ep(mesh, send, send_sf, rw, weights, kw, 1)
    w1, w1sf, w2, w2sf = weights
    experts = lambda t, s: None if t is None else t[s * e_local:(s + 1) * e_local]
    for r in range(d):
        for p, got in pools.items():
            assert torch.equal(got[r].cpu(), pools[1][r].cpu()), (p, r)
        assert calc_diff(pools[1][r].cpu(), plain[r].cpu()) < 1e-5
        for s in range(d):
            block = fused_moe.mega_local(
                send[r * d + s], None if send_sf is None else send_sf[r * d + s],
                rw[s * d + (s - r) % d], experts(w1, s), experts(w1sf, s), experts(w2, s),
                experts(w2sf, s), silu_tanh=silu_tanh, **kw)
            assert torch.equal(pools[1][r][s].cpu(), block.cpu()), (r, s)
    if kw.get('w_fp4'):
        dec = (fused_moe.decode_fp4_planar(w1), w1sf, fused_moe.decode_fp4_planar(w2), w2sf)
        fp8 = _run_mega_ep(mesh, send, send_sf, rw, dec, dict(kw, w_fp4=False), 1)
        for r in range(d):
            assert torch.equal(fp8[r].cpu(), pools[1][r].cpu())


@pytest.mark.parametrize('comm', ['xla', 'pallas', 'fused'])
def test_model_forward_over_a_mesh_on_the_card(gen, comm):
    """The fp8 model over ('ep', 4) ranks on card 0, one chunk: 'xla' and
    'pallas' two masked launches a layer a rank, 'pallas' three all-to-all
    launches a layer a rank (tokens, weights, combine) and bitwise 'xla';
    'fused' one general-kernel launch a layer a rank and nothing else, its
    MoE layer within JAX's fused-vs-unfused limit of 'xla''s; each within
    1e-5 of the plain versions."""
    from deepgemm_tpu_torch.kernels import fused_moe
    from deepgemm_tpu_torch.parallel import collectives, dist
    mesh = dist.make_mesh([('dp', 1), ('ep', 4)], ['cuda:0'] * 4, timeout=30.0)
    base = dict(vocab=512, hidden=256, num_layers=2, num_heads=2, head_dim=64, num_experts=8,
                topk=2, moe_intermediate=256, capacity_factor=8.0, use_fp8=True,
                use_kernels=True)
    params = tt.init_params(tt.ModelConfig(**base), seed=0)
    tokens = torch.randint(0, 512, (4, 16), generator=gen, device='cuda')
    cfg = tt.ModelConfig(**base, use_mega=True, mega_comm=comm, mega_chunks=1)
    xla = tt.forward(params, tokens, tt.ModelConfig(**base, use_mega=True, mega_comm='xla',
                                                    mega_chunks=1), mesh)
    counts = (collectives.launches, dict(fused_moe.ep_launches), dict(grouped.launches))
    logits = tt.forward(params, tokens, cfg, mesh)
    torch.cuda.synchronize()
    a2a = collectives.launches - counts[0]
    mega = fused_moe.ep_launches['fp8'] - counts[1]['fp8']
    masked = sum(grouped.launches.values()) - sum(counts[2].values())
    layers, ranks = base['num_layers'], 4
    with plain_versions():
        plain = tt.forward(params, tokens, cfg, mesh)
    assert torch.isfinite(logits).all()
    if comm == 'fused':
        assert (mega, masked, a2a) == (layers * ranks, 0, 0)
        # JAX's fused-vs-unfused limit holds per MoE layer (a routing flip
        # after it moves the logits further)
        layer = params['layers'][0]
        moe_in = tt.rms_norm(params['embed'][tokens], layer['ln2'])
        assert calc_diff(tt.moe_block(moe_in, layer, cfg, mesh),
                         tt.moe_block(moe_in, layer, tt.ModelConfig(
                             **base, use_mega=True, mega_comm='xla', mega_chunks=1), mesh)) < 1e-3
    else:
        # one chunk: the dispatch (tokens, weights) and the combine all-to-all
        assert (a2a, masked) == ((3 if comm == 'pallas' else 0) * layers * ranks,
                                 2 * layers * ranks)
        assert torch.equal(logits, xla)
    assert calc_diff(logits, plain) < 1e-5


_TRAP_SCRIPT = r'''
import sys, torch
from deepgemm_tpu_torch.parallel import collectives, dist
mesh = dist.make_mesh([('ep', 2)], ['cuda:0'] * 2, timeout=1.0)
x = torch.zeros(2, 64, device='cuda')
mesh.map(lambda v: collectives.pallas_all_to_all(v, 'ep'), [x, x])
torch.cuda.synchronize()
# rank 1 never enters the second call: the wrapper's host meeting before
# its launch (collectives.launch_spinning) times out on rank 0, which
# launches nothing
try:
    mesh.map(lambda v: collectives.pallas_all_to_all(v, 'ep') if dist.axis_index('ep') == 0
             else v, [x, x])
    print('host: no error')
except TimeoutError as exc:
    print('host:', str(exc).splitlines()[0])


def alone(v):
    """Rank 0's kernel launched past the host meeting, rank 1's never."""
    if dist.axis_index('ep') != 0:
        return v
    out = torch.empty_like(v)
    buf = dist.symmetric('a2a', v.numel() * v.element_size())
    lib = collectives._lib()
    lib.dgt_a2a(v.data_ptr(), out.data_ptr(), v[0].numel() * v.element_size(),
                *collectives.comm_args(buf))
    return out


# so rank 0's entry barrier must trap
mesh.map(alone, [x, x])
try:
    torch.cuda.synchronize()
    print('no error')
except RuntimeError as exc:
    print('error:', str(exc).splitlines()[0])
print('diagnostic:', collectives.comm_diagnostic(mesh))
'''


def test_a_missing_peer_traps_instead_of_hanging(gen):
    """A rank whose peer never enters the call: through the wrapper, its
    host meeting before the launch times out and raises, with no launch;
    past it, its kernel's spin gives up after the mesh's timeout (1 s here),
    writes its diagnostic words and traps; the host sees a CUDA error, not a
    hang. In a child process, since a trap ends the CUDA context."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=f'{root}{os.pathsep}{os.environ.get("PYTHONPATH", "")}')
    proc = subprocess.run([sys.executable, '-c', _TRAP_SCRIPT], capture_output=True, text=True,
                          timeout=240, env=env, cwd=root)
    out = proc.stdout
    assert 'host: rank 0: waited more than 1.0 s' in out, (out, proc.stderr[-2000:])
    assert 'error:' in out, (out, proc.stderr[-2000:])
    assert "diagnostic: [(0, 'barrier', 1" in out, out
