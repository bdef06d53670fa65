"""The port's lightning-indexer consumers (deepgemm_tpu_torch/models/
indexer.py) against the JAX package on the same numpy inputs: the top-k
selection on ties, the prefill and the decode sparse attention (against JAX
and a numpy oracle over the same selection), the decode's gather-fused
'pallas' mode, and the gathers not carried over."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import deepgemm_tpu as dg
from deepgemm_tpu.models import indexer as jax_indexer
from deepgemm_tpu_torch.models import indexer
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.testing import calc_diff


def _t(x):
    return tensor_from_numpy(np.asarray(x), device='cpu')


def _oracle_attention(q, k_sel, v_sel, valid, scale):
    scores = np.einsum('qhd,qthd->qht', q, k_sel) * scale
    scores = np.where(valid[:, None, :], scores, -np.inf)
    e = np.where(valid[:, None, :], np.exp(scores - scores.max(axis=-1, keepdims=True)), 0.0)
    probs = e / np.clip(e.sum(axis=-1, keepdims=True), 1e-30, None)
    return np.einsum('qht,qthd->qhd', probs, v_sel)


def _tied_logits():
    rng = np.random.RandomState(41)
    b, n = 8, 512
    logits = rng.randn(b, n).astype(np.float32)
    logits[1, :] = np.repeat(rng.randn(n // 8), 8)        # tie runs across the k-th place
    logits[2, 5:200] = logits[2, 4]
    logits[3, 50:] = -np.inf                              # fewer than k finite
    logits[4, 300:] = -np.inf
    logits[5, :] = -np.inf
    logits[6, 10] = np.nan
    return logits


def test_topk_indices_match_lax_top_k_on_ties(monkeypatch):
    """The same indices in the same order as JAX's lax.top_k (by score, ties
    toward the lower position, -inf slots invalid), tie runs across the k-th
    place included, where torch.topk promises no tie rule."""
    monkeypatch.setenv('DGT_TOPK_METHOD', 'sort')
    logits = _tied_logits()
    logits[6, 10] = 0.0                         # NaN ordering is not part of either contract
    for k in (96, 512):
        idx, valid = indexer._topk_indices(torch.from_numpy(logits), k)
        idx_j, valid_j = jax_indexer._topk_indices(jnp.asarray(logits), k)
        assert idx.dtype == torch.int32 and valid.dtype == torch.bool
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert valid[3].sum() == 50 and not valid[5].any()


def test_indexer_sparse_attention_matches_jax():
    rng = np.random.RandomState(31)
    sq, skv, h, d, hi, di, topk = 32, 256, 4, 64, 2, 32, 16
    q = jnp.asarray(rng.randn(sq, h, d), jnp.bfloat16)
    k = jnp.asarray(rng.randn(skv, h, d), jnp.bfloat16)
    v = jnp.asarray(rng.randn(skv, h, d), jnp.bfloat16)
    iq = jnp.asarray(rng.randn(sq, hi, di), jnp.bfloat16)
    ikv = jnp.asarray(rng.randn(skv, di), jnp.bfloat16)
    iw = jnp.asarray(rng.rand(sq, hi).astype(np.float32))
    ks = np.zeros(sq, np.int32)
    ke = (np.arange(sq) + (skv - sq)).astype(np.int32)
    want = jax_indexer.indexer_sparse_attention(q, k, v, iq, ikv, iw, jnp.asarray(ks),
                                                jnp.asarray(ke), topk)
    got = indexer.indexer_sparse_attention(_t(q), _t(k), _t(v), _t(iq), _t(ikv), _t(iw),
                                           torch.from_numpy(ks), torch.from_numpy(ke), topk)
    assert got.shape == (sq, h, d) and got.dtype == torch.bfloat16
    assert calc_diff(got, np.asarray(want, np.float32)) < 1e-5

    # the numpy oracle over the selection the JAX logits make
    iq8 = jnp.clip(iq.astype(jnp.float32), -448, 448).astype(jnp.float8_e4m3fn)
    ikv8, isf = dg.per_custom_dims_cast_to_fp8(ikv, (0,), use_ue8m0=False)
    logits = np.asarray(dg.fp8_mqa_logits((iq8, None), (ikv8, isf), iw, jnp.asarray(ks),
                                          jnp.asarray(ke)))
    sel = np.argsort(-logits, axis=-1, kind='stable')[:, :topk]
    valid = np.isfinite(np.take_along_axis(logits, sel, axis=-1))
    k_np, v_np = np.asarray(k, np.float32), np.asarray(v, np.float32)
    ref = _oracle_attention(np.asarray(q, np.float32), k_np[sel], v_np[sel], valid,
                            1.0 / np.sqrt(d))
    assert calc_diff(got, ref) < 1e-3


@pytest.mark.parametrize('case', ['flat', 'short_contexts'])
def test_indexer_sparse_decode_matches_jax(case):
    """The flat token gather against JAX's; 'short_contexts' selects more
    rows than some contexts hold, so those rows carry invalid slots."""
    rng = np.random.RandomState(32)
    b, h, d, hi, di = 3, 4, 64, 2, 32
    topk = 8 if case == 'flat' else 128
    block_kv, bps = 64, 3
    max_ctx, nb = block_kv * bps, b * bps
    k_pages = jnp.asarray(rng.randn(nb, block_kv, h, d), jnp.bfloat16)
    v_pages = jnp.asarray(rng.randn(nb, block_kv, h, d), jnp.bfloat16)
    ivals = jnp.clip(jnp.asarray(rng.randn(nb, block_kv, di), jnp.float32), -448,
                     448).astype(jnp.float8_e4m3fn)
    isf = jnp.asarray(rng.rand(nb, block_kv).astype(np.float32))
    bt = rng.permutation(nb).reshape(b, bps).astype(np.int32)
    ctx = rng.randint(topk + 1, max_ctx, b).astype(np.int32)
    if case == 'short_contexts':
        ctx[:2] = (37, 100)
    q = jnp.asarray(rng.randn(b, 1, h, d), jnp.bfloat16)
    iq = jnp.asarray(rng.randn(b, 1, hi, di), jnp.bfloat16)
    iw = jnp.asarray(rng.rand(b, hi).astype(np.float32))
    want = jax_indexer.indexer_sparse_decode(q, (k_pages, v_pages), (ivals, isf), iq, iw,
                                             jnp.asarray(ctx), jnp.asarray(bt), max_ctx, topk)
    got = indexer.indexer_sparse_decode(_t(q), (_t(k_pages), _t(v_pages)), (_t(ivals), _t(isf)),
                                        _t(iq), _t(iw), torch.from_numpy(ctx),
                                        torch.from_numpy(bt), max_ctx, topk)
    assert got.shape == (b, 1, h, d)
    assert calc_diff(got, np.asarray(want, np.float32)) < 1e-5


def _decode_case(seed=23):
    """The JAX suite's gather-fused decode case (tests/test_sparse_attn.py:
    119-145): d 128, so JAX's 'pallas' runs its gather-fused kernel."""
    rng = np.random.RandomState(seed)
    b, h, d, hi, di, topk, bkv, mps = 4, 2, 128, 2, 32, 16, 16, 4
    nbs, mcl = b * mps, bkv * mps
    kp = jnp.asarray(rng.randn(nbs, bkv, h, d) * 0.2, jnp.bfloat16)
    vp = jnp.asarray(rng.randn(nbs, bkv, h, d) * 0.2, jnp.bfloat16)
    ikp = jnp.clip(jnp.asarray(rng.randn(nbs, bkv, di), jnp.float32), -448,
                   448).astype(jnp.float8_e4m3fn)
    isfp = jnp.asarray(rng.rand(nbs, bkv).astype(np.float32))
    btab = jnp.asarray(rng.permutation(nbs).reshape(b, mps), jnp.int32)
    ctx = jnp.asarray(rng.randint(topk + 1, mcl, b), jnp.int32)
    q = jnp.asarray(rng.randn(b, 1, h, d), jnp.bfloat16)
    iq = jnp.asarray(rng.randn(b, 1, hi, di), jnp.bfloat16)
    iw = jnp.asarray(rng.rand(b, hi).astype(np.float32))
    jax_args = (q, (kp, vp), (ikp, isfp), iq, iw, ctx, btab, mcl, topk)
    port_args = (_t(q), (_t(kp), _t(vp)), (_t(ikp), _t(isfp)), _t(iq), _t(iw), _t(ctx),
                 _t(btab), mcl, topk)
    return jax_args, port_args


def test_decode_pallas_matches_jax_pallas_and_flat(monkeypatch):
    """DGT_SPARSE_GATHER=pallas: the port's gather-fused decode against JAX's
    (its Pallas kernel in interpret mode) within 1e-5, and bitwise equal to
    the port's 'flat' decode."""
    jax_args, port_args = _decode_case()
    flat = indexer.indexer_sparse_decode(*port_args)
    monkeypatch.setenv('DGT_SPARSE_GATHER', 'pallas')
    want = np.asarray(jax_indexer.indexer_sparse_decode(*jax_args), np.float32)
    got = indexer.indexer_sparse_decode(*port_args)
    assert got.shape == (4, 1, 2, 128) and got.dtype == torch.bfloat16
    assert calc_diff(got, want) < 1e-5
    assert torch.equal(got, flat)


@pytest.mark.parametrize('mode', ['2level', 'other'])
def test_decode_gathers_other_than_flat_raise(monkeypatch, mode):
    """The port takes 'flat' and 'pallas' only: the JAX module's '2level'
    form and any other value raise rather than fall back to another
    gather."""
    rng = np.random.RandomState(33)
    b, h, d, nb, bkv = 2, 2, 64, 4, 16
    pages = torch.from_numpy(rng.randn(nb, bkv, h, d).astype(np.float32)).bfloat16()
    ivals = torch.from_numpy(rng.randn(nb, bkv, 32).astype(np.float32)).to(torch.float8_e4m3fn)
    monkeypatch.setenv('DGT_SPARSE_GATHER', mode)
    with pytest.raises(NotImplementedError,
                       match=r"takes \('flat', 'pallas'\).*Queue 1, \"Not carried over\""):
        indexer.indexer_sparse_decode(
            torch.zeros(b, 1, h, d, dtype=torch.bfloat16), (pages, pages),
            (ivals, torch.ones(nb, bkv)), torch.zeros(b, 1, 2, 32), torch.ones(b, 2),
            torch.tensor([20, 30]), torch.arange(4, dtype=torch.int32).view(b, 2), 2 * bkv, 8)
