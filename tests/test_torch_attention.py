"""The port's indexer logits (deepgemm_tpu_torch/ops/attention.py and the
kernels' plain versions behind it on the CPU) against the JAX package on the
same numpy inputs: MQA logits full, compressed and with ragged ks; paged MQA
logits with both strategies, 1-D and 2-D context lengths, next_n 1 to 6;
packed FP4 operands and their mixed pairs with e4m3; the varlen pairing in
its host and device forms; the schedule metadata. The JAX side runs its
Pallas kernels in interpret mode, as its own tests do."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import deepgemm_tpu as dg
from deepgemm_tpu.ops.attention import split_fused_kv_cache_fp4 as jax_split_fp4
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.ops.attention import split_fused_kv_cache_fp4
from deepgemm_tpu_torch.testing import assert_bitwise_equal, calc_diff


def _t(x):
    """A JAX or numpy array as a CPU tensor, bit for bit."""
    return tensor_from_numpy(np.asarray(x), device='cpu')


def _check_logits(got, want, tol=1e-5):
    """-inf at the same places, calc_diff over the rest."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    mask = ~np.isneginf(want)
    assert calc_diff(np.where(mask, got, 0), np.where(mask, want, 0)) < tol


def _mqa_inputs(sq, skv, h, d, seed):
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(sq, h, d), jnp.bfloat16)
    kv = jnp.asarray(rng.randn(skv, d), jnp.bfloat16)
    w = jnp.asarray(rng.randn(sq, h).astype(np.float32))
    q8 = jnp.clip(q.astype(jnp.float32), -448, 448).astype(jnp.float8_e4m3fn)
    kv8, sf = dg.per_custom_dims_cast_to_fp8(kv, (0,), use_ue8m0=False)
    return q8, kv8, sf, w


def _ranges(sq, skv, disable_cp):
    """The JAX suite's [ks, ke) windows (tests/test_attention.py:27-41)."""
    if disable_cp:
        return np.zeros(sq, np.int32), np.arange(sq, dtype=np.int32) + (skv - sq)
    chunk, cp = sq // 2, skv // sq
    cp_id = cp // 3
    ks, ke = np.zeros(sq, np.int32), np.zeros(sq, np.int32)
    for i in range(chunk):
        ke[i] = cp_id * chunk + i
        ke[i + chunk] = (cp * 2 - 1 - cp_id) * chunk + i
    return ks, ke


@pytest.mark.parametrize('sq,skv,h,d,disable_cp', [(64, 256, 4, 128, True),
                                                   (64, 256, 4, 128, False),
                                                   (32, 128, 8, 64, True)])
def test_mqa_logits_matches_jax(sq, skv, h, d, disable_cp):
    q8, kv8, sf, w = _mqa_inputs(sq, skv, h, d, seed=0)
    ks, ke = _ranges(sq, skv, disable_cp)
    want = dg.fp8_mqa_logits((q8, None), (kv8, sf), w, jnp.asarray(ks), jnp.asarray(ke))
    got = dgt.fp8_mqa_logits((_t(q8), None), (_t(kv8), _t(sf)), _t(w), torch.from_numpy(ks),
                             torch.from_numpy(ke))
    assert got.shape == (sq, skv) and got.dtype == torch.float32
    _check_logits(got, want)


@pytest.mark.parametrize('ragged', [False, True])
def test_mqa_logits_compressed_matches_jax(ragged):
    """The compressed layout: tile-constant ks (0) in the kernel, ragged ks
    through one full pass and a per-row gather; 0 past ke - ks."""
    sq, skv, h, d = 64, 512, 4, 64
    q8, kv8, sf, w = _mqa_inputs(sq, skv, h, d, seed=2)
    rng = np.random.RandomState(12)
    if ragged:
        ks = rng.randint(0, skv // 2, size=sq).astype(np.int32)
        ke = ks + rng.randint(1, skv // 2, size=sq).astype(np.int32)
    else:
        ks, ke = _ranges(sq, skv, True)
    maxk = int((ke - ks).max())
    want = np.asarray(dg.fp8_fp4_mqa_logits((q8, None), (kv8, sf), w, jnp.asarray(ks),
                                            jnp.asarray(ke), max_seqlen_k=maxk))
    got = dgt.fp8_fp4_mqa_logits((_t(q8), None), (_t(kv8), _t(sf)), _t(w),
                                 torch.from_numpy(ks), torch.from_numpy(ke), max_seqlen_k=maxk)
    assert got.shape == (sq, maxk)
    assert calc_diff(got, want) < 1e-5
    zero = np.arange(maxk)[None, :] >= (ke - ks)[:, None]
    assert not got.numpy()[zero].any()
    full = dgt.fp8_mqa_logits((_t(q8), None), (_t(kv8), _t(sf)), _t(w), torch.from_numpy(ks),
                              torch.from_numpy(ke)).numpy()
    for i in range(sq):         # the compressed row is the full row's window, bit for bit
        np.testing.assert_array_equal(got.numpy()[i, :ke[i] - ks[i]], full[i, ks[i]:ke[i]])


def _paged_inputs(b, nn, h, d, bkv, mps, ctx_2d, seed):
    rng = np.random.RandomState(seed)
    nb = b * mps + 3
    q = jnp.clip(jnp.asarray(rng.randn(b, nn, h, d), jnp.float32), -448,
                 448).astype(jnp.float8_e4m3fn)
    w = jnp.asarray(rng.randn(b * nn, h).astype(np.float32))
    bt = rng.permutation(nb)[:b * mps].reshape(b, mps).astype(np.int32)
    shape = (b, nn) if ctx_2d else (b,)
    ctx = rng.randint(nn + 1, bkv * mps, size=shape).astype(np.int32)
    kvv = jnp.asarray(rng.randn(nb, bkv, d), jnp.float8_e4m3fn)
    kvs = jnp.asarray(rng.rand(nb, bkv).astype(np.float32))
    return q, w, jnp.asarray(ctx), jnp.asarray(bt), kvv, kvs


@pytest.mark.parametrize('next_n,ctx_2d', [(1, False), (2, False), (1, True), (2, True)])
def test_paged_mqa_logits_matches_jax(next_n, ctx_2d):
    """Both strategies against the JAX gather strategy (which the JAX suite
    holds bitwise equal to its zero-copy kernel at d = 128), and bitwise
    against each other."""
    b, h, d, bkv, mps = 3, 4, 128, 64, 4
    q, w, ctx, bt, kvv, kvs = _paged_inputs(b, next_n, h, d, bkv, mps, ctx_2d, seed=5)
    max_len = bkv * mps
    want = dg.fp8_fp4_paged_mqa_logits((q, None), (kvv, kvs), w, ctx, bt, None, max_len)
    args = ((_t(q), None), (_t(kvv), _t(kvs)), _t(w), _t(ctx), _t(bt), None, max_len)
    got = {s: dgt.fp8_fp4_paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
    assert got['gather'].shape == (b * next_n, max_len)
    _check_logits(got['gather'], want)
    assert_bitwise_equal(got['paged'], got['gather'], 'paged vs gather')


def test_fused_kv_cache_layout_matches_jax():
    """The reference's fused byte cache splits into the same bits, and the
    legacy entry reads it as the pre-split pair."""
    rng = np.random.RandomState(7)
    nb, bkv, d = 5, 64, 32
    fused = rng.randint(0, 256, size=(nb, bkv, 1, d + 4)).astype(np.uint8)
    sf = rng.rand(nb, bkv).astype(np.float32) + 0.5
    fused.reshape(nb, -1)[:, bkv * d:] = sf.view(np.uint8).reshape(nb, -1)
    fused.reshape(nb, -1)[:, :bkv * d] &= 0x77                   # no NaN codes
    vals_j, sf_j = dg.split_fused_kv_cache(jnp.asarray(fused), d)
    vals_t, sf_t = dgt.split_fused_kv_cache(torch.from_numpy(fused), d)
    assert_bitwise_equal(vals_t, np.asarray(vals_j), 'values')
    assert_bitwise_equal(sf_t, np.asarray(sf_j), 'scales')
    q = torch.from_numpy(rng.randn(2, 1, 2, d).astype(np.float32)).to(torch.float8_e4m3fn)
    w = torch.from_numpy(rng.rand(2, 2).astype(np.float32))
    bt, ctx = torch.tensor([[0, 1], [3, 4]], dtype=torch.int32), torch.tensor([100, 70])
    legacy = dgt.fp8_paged_mqa_logits((q, None), torch.from_numpy(fused), w, ctx, bt, None, 128)
    split = dgt.fp8_fp4_paged_mqa_logits((q, None), (vals_t, sf_t), w, ctx, bt, None, 128)
    assert_bitwise_equal(legacy, split, 'fused vs split cache')


def test_clean_logits_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(32, 128).astype(np.float32)
    ks = rng.randint(0, 32, size=32).astype(np.int32)
    ke = ks + rng.randint(1, 96, size=32).astype(np.int32)
    want = np.asarray(dg.clean_logits_(jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(ke)))
    t = torch.from_numpy(logits.copy())
    out = dgt.clean_logits_(t, torch.from_numpy(ks), torch.from_numpy(ke))
    assert out is t                                                # in place
    assert_bitwise_equal(out, want, 'clean_logits_')


def _fp4(x):
    """bf16 rows [.., d] as JAX casts them: packed e2m1 [.., d/2] and one
    packed-UE8M0 int32 of per-32 scales a row."""
    lead, d = x.shape[:-1], x.shape[-1]
    packed, sf = dg.per_token_cast_to_fp4(x.reshape(-1, d), use_ue8m0=True, gran_k=32,
                                          use_packed_ue8m0=True)
    return packed.reshape(*lead, d // 2), sf.reshape(lead)


def _fp4_fused_cache(rng, nb, bkv, d):
    """The reference's FP4 fused byte cache [nb, bkv, 1, d/2 + 4]
    (tests/test_attention.py:357-374): a block's packed bytes, then its
    tokens' packed scales."""
    packed, sf = _fp4(jnp.asarray(rng.randn(nb * bkv, d), jnp.bfloat16))
    fused = np.empty((nb, bkv * (d // 2 + 4)), np.uint8)
    fused[:, :bkv * (d // 2)] = np.asarray(packed).reshape(nb, -1).view(np.uint8)
    fused[:, bkv * (d // 2):] = np.asarray(sf).reshape(nb, -1).view(np.uint8)
    return fused.reshape(nb, bkv, 1, d // 2 + 4)


def _pair(x):
    return tuple(None if y is None else _t(y) for y in x)


@pytest.mark.parametrize('kv_kind', ['fp4', 'e4m3'])
def test_fp4_mqa_logits_matches_jax(kv_kind):
    """FP4 q with an FP4 kv (tests/test_attention.py:306) or an e4m3 kv: the
    port decodes as JAX does and runs the bf16 instance (its plain version
    here); within 1e-5 of JAX, -inf at the same places."""
    rng = np.random.RandomState(11)
    sq, skv, h, d = 64, 256, 4, 128
    q = jnp.asarray(rng.randn(sq, h, d), jnp.bfloat16)
    kv = jnp.asarray(rng.randn(skv, d), jnp.bfloat16)
    w = jnp.asarray(rng.randn(sq, h).astype(np.float32))
    ks, ke = _ranges(sq, skv, True)
    kv_pair = _fp4(kv) if kv_kind == 'fp4' else dg.per_custom_dims_cast_to_fp8(
        kv, (0,), use_ue8m0=False)
    want = dg.fp8_fp4_mqa_logits(_fp4(q), kv_pair, w, jnp.asarray(ks), jnp.asarray(ke))
    got = dgt.fp8_fp4_mqa_logits(_pair(_fp4(q)), _pair(kv_pair), _t(w), torch.from_numpy(ks),
                                 torch.from_numpy(ke))
    assert got.shape == (sq, skv)
    _check_logits(got, want)


@pytest.mark.parametrize('q_kind,cache_kind', [('fp4', 'fused_fp4'), ('fp4', 'split_fp4'),
                                               ('fp4', 'e4m3'), ('e4m3', 'fused_fp4')])
def test_fp4_paged_mqa_logits_matches_jax(q_kind, cache_kind):
    """FP4 paged decode (tests/test_attention.py:382): an FP4 q, an FP4
    cache as the fused byte layout or the pre-split pair, and the mixed
    pairs (FP4 q with an e4m3 cache; e4m3 q with an FP4 cache, which decodes
    whatever q is); within 1e-5 of JAX, both strategies bitwise equal."""
    rng = np.random.RandomState(13)
    b, h, d, bkv, mps = 3, 4, 128, 64, 3
    nb, max_len = b * mps, bkv * mps
    fused = _fp4_fused_cache(rng, nb, bkv, d)
    if cache_kind == 'fused_fp4':
        cache_j, cache_t = jnp.asarray(fused), torch.from_numpy(fused)
    elif cache_kind == 'split_fp4':
        cache_j = jax_split_fp4(jnp.asarray(fused), d)
        cache_t = _pair(cache_j)
    else:
        vals = jnp.asarray(rng.randn(nb, bkv, d), jnp.float8_e4m3fn)
        scales = jnp.asarray(rng.rand(nb, bkv).astype(np.float32))
        cache_j, cache_t = (vals, scales), _pair((vals, scales))
    bt = rng.permutation(nb).reshape(b, mps).astype(np.int32)
    ctx = rng.randint(2, max_len, size=b).astype(np.int32)
    qf = jnp.asarray(rng.randn(b, 1, h, d), jnp.bfloat16)
    if q_kind == 'fp4':
        q = _fp4(qf)
    else:
        q = (jnp.clip(qf.astype(jnp.float32), -448, 448).astype(jnp.float8_e4m3fn), None)
    w = jnp.asarray(rng.randn(b, h).astype(np.float32))
    want = dg.fp8_fp4_paged_mqa_logits(q, cache_j, w, jnp.asarray(ctx), jnp.asarray(bt), None,
                                       max_len)
    args = (_pair(q), cache_t, _t(w), torch.from_numpy(ctx), torch.from_numpy(bt), None,
            max_len)
    got = {s: dgt.fp8_fp4_paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
    _check_logits(got['gather'], want)
    assert_bitwise_equal(got['paged'], got['gather'], 'paged vs gather')


def test_split_fused_kv_cache_fp4_matches_jax():
    fused = _fp4_fused_cache(np.random.RandomState(17), 5, 16, 64)
    vals_j, sf_j = jax_split_fp4(jnp.asarray(fused), 64)
    vals_t, sf_t = split_fused_kv_cache_fp4(torch.from_numpy(fused), 64)
    assert vals_t.dtype == torch.int8 and sf_t.dtype == torch.int32
    assert_bitwise_equal(vals_t, np.asarray(vals_j), 'values')
    assert_bitwise_equal(sf_t, np.asarray(sf_j), 'scales')


def _varlen_case(seed):
    """The JAX suite's varlen case (tests/test_attention.py:419-463): 3
    sequences of 1-3 tokens, per-token contexts, the fused fp8 cache."""
    rng = np.random.RandomState(seed)
    raw_b, h, d, bkv, mps = 3, 4, 64, 64, 3
    nb, max_len = raw_b * mps, bkv * mps
    vals = rng.randn(nb, bkv, d).astype(np.float32).clip(-448, 448)
    vals = np.asarray(jnp.asarray(vals, jnp.float8_e4m3fn))
    sf = (rng.rand(nb, bkv) + 0.5).astype(np.float32)
    fused = np.concatenate([vals.view(np.uint8).reshape(nb, -1),
                            sf.view(np.uint8).reshape(nb, -1)], axis=1)
    fused = fused.reshape(nb, bkv, 1, d + 4)
    bt_raw = rng.permutation(nb).reshape(raw_b, -1).astype(np.int32)
    tokens = rng.randint(1, 4, size=raw_b)
    indices = np.repeat(np.arange(raw_b, dtype=np.int32), tokens)
    offsets = np.concatenate([np.arange(t, dtype=np.int32) for t in tokens])
    ctx = (rng.randint(8, max_len - 4, size=raw_b).astype(np.int32)[indices] + offsets)
    rows = int(tokens.sum())
    q = jnp.clip(jnp.asarray(rng.randn(rows, 1, h, d), jnp.float32), -448,
                 448).astype(jnp.float8_e4m3fn)
    w = jnp.asarray(rng.randn(rows, h).astype(np.float32))
    return (q, fused, w, ctx.reshape(rows, 1), bt_raw[indices], max_len, indices,
            raw_b, int(tokens.max()))


def test_paged_mqa_varlen_host_form_matches_jax():
    """Varlen `indices` given as values (tests/test_attention.py:419): the
    host form, within 1e-5 of JAX's host pairing."""
    q, fused, w, ctx, bt, max_len, indices, _, _ = _varlen_case(14)
    want = dg.fp8_fp4_paged_mqa_logits((q, None), jnp.asarray(fused), w, jnp.asarray(ctx),
                                       jnp.asarray(bt), None, max_len, indices=indices)
    for idx in (indices, torch.from_numpy(indices)):          # numpy, or a tensor without bounds
        got = dgt.fp8_fp4_paged_mqa_logits((_t(q), None), torch.from_numpy(fused), _t(w),
                                           torch.from_numpy(ctx), torch.from_numpy(bt), None,
                                           max_len, indices=idx)
        assert got.shape == (len(indices), max_len)
        _check_logits(got, want)


def test_paged_mqa_varlen_device_form_matches_jax_traced():
    """Varlen with static bounds (tests/test_attention.py:465): the device
    form (torch indices, no host read) within 1e-5 of JAX's jitted traced
    pairing, and bitwise equal to the port's host form, with both bounds
    above the data's (rows past them stay padding)."""
    import jax
    q, fused, w, ctx, bt, max_len, indices, raw_b, t_max = _varlen_case(15)
    for mb, tm in ((raw_b, t_max), (raw_b + 2, t_max + 1)):
        @jax.jit
        def traced(q_, w_, ctx_, bt_, idx_):
            return dg.fp8_fp4_paged_mqa_logits((q_, None), jnp.asarray(fused), w_, ctx_, bt_,
                                               None, max_len, indices=idx_, max_batch=mb,
                                               max_tokens_per_seq=tm)

        want = traced(q, w, jnp.asarray(ctx), jnp.asarray(bt), jnp.asarray(indices))
        args = ((_t(q), None), torch.from_numpy(fused), _t(w), torch.from_numpy(ctx),
                torch.from_numpy(bt), None, max_len)
        device = dgt.fp8_fp4_paged_mqa_logits(*args, indices=torch.from_numpy(indices),
                                              max_batch=mb, max_tokens_per_seq=tm)
        host = dgt.fp8_fp4_paged_mqa_logits(*args, indices=indices)
        _check_logits(device, want)
        assert_bitwise_equal(device, host, 'device vs host pairing')


@pytest.mark.parametrize('next_n,ctx_2d', [(6, False), (6, True), (5, True)])
def test_paged_mqa_logits_beyond_one_tile_matches_jax(next_n, ctx_2d):
    """next_n x heads above the 256 q2 rows of one kernel block (64 heads,
    next_n 5 and 6), which the port's op used to refuse: within 1e-5 of
    JAX, both strategies bitwise equal."""
    b, h, d, bkv, mps = 2, 64, 64, 64, 3
    q, w, ctx, bt, kvv, kvs = _paged_inputs(b, next_n, h, d, bkv, mps, ctx_2d, seed=6)
    max_len = bkv * mps
    want = dg.fp8_fp4_paged_mqa_logits((q, None), (kvv, kvs), w, ctx, bt, None, max_len)
    args = ((_t(q), None), (_t(kvv), _t(kvs)), _t(w), _t(ctx), _t(bt), None, max_len)
    got = {s: dgt.fp8_fp4_paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
    _check_logits(got['gather'], want)
    assert_bitwise_equal(got['paged'], got['gather'], 'paged vs gather')


@pytest.mark.parametrize('lens,num_sms', [([0, 100, 0, 64, 65, 0], 3),
                                          ([0, 0, 300, 7, 0, 0, 1, 0], 8),
                                          ([130, 1], 40),          # more units than segments
                                          ([5000, 64, 0, 777], 0),  # num_sms 0: 8 units
                                          ([0, 0], 4)])
def test_paged_mqa_logits_metadata_matches_jax(lens, num_sms):
    """The schedule table bitwise equal to JAX's (its native scheduler),
    with leading, middle and trailing zero-context rows and more units than
    segments."""
    lens = np.array(lens, np.int32)
    want = np.asarray(dg.get_paged_mqa_logits_metadata(jnp.asarray(lens), 64, num_sms))
    got = dgt.get_paged_mqa_logits_metadata(torch.from_numpy(lens), 64, num_sms)
    assert got.dtype == torch.int32 and got.shape == (max(num_sms or 8, 1) + 1, 2)
    assert_bitwise_equal(got, want, 'schedule')


def test_unported_operands_raise():
    """What still raises: the device form of varlen `indices` with a bound
    missing (as JAX's traced form raises), and a packed FP4 kv beside an
    e4m3 q in the prefill op (JAX passes its bytes undecoded: nothing
    defined to match). Neither takes another path."""
    q8 = torch.zeros(2, 1, 2, 64, dtype=torch.float8_e4m3fn)
    cache = (torch.zeros(4, 64, 64, dtype=torch.float8_e4m3fn), torch.ones(4, 64))
    args = ((q8, None), cache, torch.ones(2, 2), torch.tensor([[10], [20]]),
            torch.tensor([[0], [1]], dtype=torch.int32), None, 64)
    for bounds in (dict(max_batch=2), dict(max_tokens_per_seq=1)):
        with pytest.raises(ValueError, match='requires static bounds'):
            dgt.fp8_fp4_paged_mqa_logits(*args, indices=torch.tensor([0, 1]), **bounds)
    q = torch.zeros(4, 2, 64, dtype=torch.float8_e4m3fn)
    kv4 = (torch.zeros(8, 32, dtype=torch.int8), torch.ones(8, dtype=torch.int32))
    ks, ke = torch.zeros(4, dtype=torch.int32), torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match='needs a packed FP4 q'):
        dgt.fp8_fp4_mqa_logits((q, None), kv4, torch.ones(4, 2), ks, ke)
