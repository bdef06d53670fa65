"""The port's indexer logits (deepgemm_tpu_torch/ops/attention.py and the
kernels' plain versions behind it on the CPU) against the JAX package on the
same numpy inputs: MQA logits full, compressed and with ragged ks; paged MQA
logits with both strategies, 1-D and 2-D context lengths, next_n 1 and 2.
The JAX side runs its Pallas kernels in interpret mode, as its own tests do."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import deepgemm_tpu as dg
import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
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


def test_unported_operands_raise():
    """Packed FP4 operands and varlen indices raise; neither takes another path."""
    q4 = torch.zeros(4, 2, 32, dtype=torch.int8)
    kv = (torch.zeros(8, 64, dtype=torch.float8_e4m3fn), torch.ones(8))
    ks, ke = torch.zeros(4, dtype=torch.int32), torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match='Queue 1 #1'):
        dgt.fp8_fp4_mqa_logits((q4, torch.zeros(4, 2, dtype=torch.int32)), kv,
                               torch.ones(4, 2), ks, ke)
    q8 = torch.zeros(2, 1, 2, 64, dtype=torch.float8_e4m3fn)
    cache = (torch.zeros(4, 64, 64, dtype=torch.float8_e4m3fn), torch.ones(4, 64))
    args = ((q8, None), cache, torch.ones(2, 2), torch.tensor([10, 20]),
            torch.tensor([[0], [1]], dtype=torch.int32), None, 64)
    with pytest.raises(NotImplementedError, match='Queue 1 #1'):
        dgt.fp8_fp4_paged_mqa_logits(*args, indices=torch.tensor([0, 0]))
    with pytest.raises(NotImplementedError, match='Queue 1 #1'):
        dgt.fp8_fp4_paged_mqa_logits(*args[:1], (torch.zeros(4, 64, 32, dtype=torch.int8),
                                                 torch.ones(4, 64, dtype=torch.int32)), *args[2:])
