"""The port's sparse attention over the selected rows (deepgemm_tpu_torch/
kernels/sparse_attn.py; on the CPU its plain version) against the JAX
package's: the fused kernel and the XLA tail (DGT_SPARSE_ATTN=xla, which the
JAX suite holds equal to its kernel), a float64 numpy oracle, rows with no
valid position, and the shape contract."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepgemm_tpu.kernels import sparse_attn as jax_sparse_attn
from deepgemm_tpu.models import indexer as jax_indexer
from deepgemm_tpu_torch.kernels import sparse_attn
from deepgemm_tpu_torch.models import indexer
from deepgemm_tpu_torch.models.convert import tensor_from_numpy
from deepgemm_tpu_torch.testing import calc_diff


def _t(x):
    return tensor_from_numpy(np.asarray(x), device='cpu')


def _oracle(q, k_sel, v_sel, valid, scale):
    q, k_sel, v_sel = (np.asarray(x, np.float64) for x in (q, k_sel, v_sel))
    valid = np.asarray(valid)
    scores = np.einsum('bhd,bthd->bth', q, k_sel) * scale
    scores = np.where(valid[:, :, None], scores, -np.inf)
    m = np.max(scores, axis=1, keepdims=True)
    e = np.where(valid[:, :, None], np.exp(scores - np.where(np.isfinite(m), m, 0.0)), 0.0)
    den = e.sum(axis=1)
    out = np.einsum('bth,bthd->bhd', e, v_sel)
    return out / np.where(den > 0, den, 1.0)[:, :, None]


def _inputs(rows, t, h, d, seed):
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(rows, h, d), jnp.bfloat16)
    k = jnp.asarray(rng.randn(rows, t, h, d), jnp.bfloat16)
    v = jnp.asarray(rng.randn(rows, t, h, d), jnp.bfloat16)
    valid = rng.rand(rows, t) > 0.3
    valid[:, 0] = True
    return q, k, v, valid


# the CUDA kernel's edges, held here through the plain version, its oracle
# on the card: ragged head groups (h 3 and 20), topk 1 and one past a
# producer window (33), d 256
_EDGES = [(2, 33, 3, 128), (2, 1, 20, 64), (2, 33, 20, 256)]


@pytest.mark.parametrize('rows,t,h,d', [(5, 24, 4, 128), (3, 40, 2, 64)] + _EDGES)
def test_gathered_attention_matches_jax(rows, t, h, d):
    q, k, v, valid = _inputs(rows, t, h, d, seed=11)
    scale = 1.0 / np.sqrt(d)
    got = sparse_attn.gathered_attention(_t(q), _t(k), _t(v), torch.from_numpy(valid), scale)
    assert got.shape == (rows, h, d) and got.dtype == torch.bfloat16
    want = jax_sparse_attn.gathered_attention(q, k, v, jnp.asarray(valid), scale)
    assert calc_diff(got, np.asarray(want, np.float32)) < 1e-5
    assert calc_diff(got, _oracle(q, k, v, valid, scale)) < 2e-3


def test_no_valid_row_is_zero_and_masking_selects():
    """A row with no valid position gives 0 (the JAX kernel's contract), and
    a NaN or Inf in an unselected row cannot reach the output (the port
    masks by select, not by adding -inf)."""
    q, k, v, valid = _inputs(4, 16, 2, 128, seed=12)
    valid[2, :] = False
    k, v = np.asarray(k, np.float32), np.asarray(v, np.float32)
    k[1, ~valid[1]] = np.nan
    v[3, ~valid[3]] = np.inf
    kt = torch.from_numpy(k).to(torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    out = sparse_attn.gathered_attention(_t(q), kt, vt, torch.from_numpy(valid), 0.1)
    assert torch.isfinite(out).all()
    assert not out[2].any()
    ok = [0, 1, 3]
    ref = _oracle(np.asarray(q)[ok], np.nan_to_num(k[ok]), np.nan_to_num(v[ok], posinf=0.0),
                  valid[ok], 0.1)
    assert calc_diff(out[ok], ref) < 2e-3


def test_fused_eligible_is_the_kernels_contract(monkeypatch):
    """The kernel takes the serving shape (128 heads, topk 2048), where
    JAX's VMEM budget sends its 'auto' mode to XLA, and raises for a head_dim
    outside its contract rather than taking another path; the port reads no
    DGT_SPARSE_ATTN."""
    assert sparse_attn.fused_eligible(2048, 128, 128)
    assert not jax_sparse_attn.fused_eligible(2048, 128, 128)
    assert all(sparse_attn.fused_eligible(7, 3, d) for d in (64, 128, 256))
    assert not sparse_attn.fused_eligible(16, 2, 96)
    q, k, v, valid = (_t(x) for x in _inputs(2, 16, 2, 96, seed=14))
    monkeypatch.setenv('DGT_SPARSE_ATTN', 'xla')
    with pytest.raises(ValueError, match='head_dim'):
        sparse_attn.gathered_attention(q, k, v, valid.bool(), 0.1)


def _decode_inputs(seed):
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
    return (q, (kp, vp), (ikp, isfp), iq, iw, ctx, btab, mcl, topk)


def _to_port(args):
    return tuple(tuple(_t(y) for y in x) if isinstance(x, tuple) else
                 (_t(x) if hasattr(x, 'shape') else x) for x in args)


def test_indexer_decode_attention_modes_match_jax_xla(monkeypatch):
    """The decode through the port's attention (the kernel's plain version
    on the CPU) against JAX's decode in both its attention modes, the XLA
    tail and the fused kernel, on the same state (the gathers other than
    the flat one: tests/test_torch_indexer.py)."""
    args = _decode_inputs(seed=13)
    port = _to_port(args)
    got = indexer.indexer_sparse_decode(*port)
    assert got.shape == (4, 1, 2, 128)
    for mode in ('xla', 'fused'):
        monkeypatch.setenv('DGT_SPARSE_ATTN', mode)
        want = np.asarray(jax_indexer.indexer_sparse_decode(*args), np.float32)
        assert calc_diff(got, want) < 1e-5, mode


def _paged_inputs(rows, t, h, d, n, seed):
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(rows, h, d), jnp.bfloat16)
    cache = jnp.asarray(rng.randn(n, h, d), jnp.bfloat16)
    tok = rng.randint(0, n, (rows, t)).astype(np.int32)
    valid = rng.rand(rows, t) > 0.3
    valid[:, 0] = True
    return q, cache, tok, valid


@pytest.mark.parametrize('rows,t,h,d,n', [(4, 64, 8, 128, 256), (3, 24, 2, 128, 100)] +
                         [(rows, t, h, d, 50) for rows, t, h, d in _EDGES])
def test_sparse_attention_paged_matches_jax(rows, t, h, d, n):
    """The gather-fused attention (its plain version here) against JAX's
    gather-fused kernel in interpret mode, at the JAX suite's shapes
    (tests/test_sparse_attn.py:98-99), within 1e-5; and bitwise equal to
    the port's flat gather + gathered attention on the same rows."""
    q, cache, tok, valid = _paged_inputs(rows, t, h, d, n, seed=21)
    scale = 1.0 / np.sqrt(d)
    want = jax_sparse_attn.sparse_attention_paged(q, cache, cache, jnp.asarray(tok),
                                                  jnp.asarray(valid), scale)
    got = sparse_attn.sparse_attention_paged(_t(q), _t(cache), _t(cache), torch.from_numpy(tok),
                                             torch.from_numpy(valid), scale)
    assert got.shape == (rows, h, d) and got.dtype == torch.bfloat16
    assert calc_diff(got, np.asarray(want, np.float32)) < 1e-5
    k_sel = _t(cache).index_select(0, torch.from_numpy(tok).long().view(-1)).view(rows, t, h, d)
    gathered = sparse_attn.gathered_attention(_t(q), k_sel, k_sel, torch.from_numpy(valid),
                                              scale)
    assert torch.equal(got, gathered)


def test_sparse_attention_paged_masks_by_select():
    """NaN and Inf in cache rows no valid entry selects stay out of the
    output; a row with no valid entry gives 0; invalid entries may point
    out of range (clipped, never read); against the float64 oracle."""
    rows, t, h, d, n = 4, 16, 2, 64, 40
    q, cache, tok, valid = _paged_inputs(rows, t, h, d, n, seed=22)
    valid[2, :] = False
    tok[1, ~valid[1]] = 10 * n
    tok[3, ~valid[3]] = -5
    k = np.asarray(cache, np.float32)
    v = np.asarray(cache, np.float32) * 0.5
    unused = np.ones(n, bool)
    unused[tok[valid]] = False
    assert unused.any()
    k[unused], v[unused] = np.nan, np.inf
    kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    out = sparse_attn.sparse_attention_paged(_t(q), kt, vt, torch.from_numpy(tok),
                                             torch.from_numpy(valid), 0.1)
    assert torch.isfinite(out).all()
    assert not out[2].any()
    ok = [0, 1, 3]
    sel = np.clip(tok, 0, n - 1)
    k_sel = np.asarray(kt.float())[sel]
    v_sel = np.asarray(vt.float())[sel]
    ref = _oracle(np.asarray(q)[ok], np.nan_to_num(k_sel[ok]),
                  np.nan_to_num(v_sel[ok], posinf=0.0), valid[ok], 0.1)
    assert calc_diff(out[ok], ref) < 2e-3


def test_sparse_attention_paged_contract():
    """The same shape contract as the gathered entry (head_dim 64, 128 or
    256); bf16 operands and output only."""
    q, cache, tok, valid = (_t(x) if not isinstance(x, np.ndarray) else torch.from_numpy(x)
                            for x in _paged_inputs(2, 8, 2, 96, 10, seed=23))
    with pytest.raises(ValueError, match='head_dim'):
        sparse_attn.sparse_attention_paged(q, cache, cache, tok, valid, 0.1)
    q, cache, tok, valid = (_t(x) if not isinstance(x, np.ndarray) else torch.from_numpy(x)
                            for x in _paged_inputs(2, 8, 2, 64, 10, seed=23))
    with pytest.raises(TypeError, match='bf16'):
        sparse_attn.sparse_attention_paged(q, cache.float(), cache, tok, valid, 0.1)
    with pytest.raises(TypeError, match='writes bf16'):
        sparse_attn.sparse_attention_paged(q, cache, cache, tok, valid, 0.1,
                                           out_dtype=torch.float32)
