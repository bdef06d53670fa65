"""Attention (MQA lightning-indexer) public API, the counterpart of
deepgemm_tpu/ops/attention.py:

  * ``fp8_fp4_mqa_logits`` / legacy ``fp8_mqa_logits``: prefill scoring with
    per-row [ks, ke) windows, full or compressed layout;
  * ``fp8_fp4_paged_mqa_logits`` / legacy ``fp8_paged_mqa_logits``: decode
    scoring against a paged fp8 cache, 1-D or 2-D context lengths, the
    'gather' or 'paged' (zero-copy) strategy;
  * ``split_fused_kv_cache``: the reference's fused byte cache into
    (e4m3 values, f32 scales);
  * ``clean_logits_``: the -inf fill outside each row's window.

Still to be ported, with the next slice (ROADMAP.md Queue 1 #1): packed FP4
operands and the varlen ``indices`` pairing, which raise rather than take
another path, and ``get_paged_mqa_logits_metadata``.
"""

import torch

from ..kernels import mqa_logits as mqa_kernel
from ..kernels import paged_mqa
from .gemm import _split_pair

_FP4_TODO = ('packed FP4 indexer operands are not ported yet: the next slice, '
             'ROADMAP.md Queue 1 #1')
_VARLEN_TODO = ('varlen `indices` pairing is not ported yet: the next slice, '
                'ROADMAP.md Queue 1 #1')


def _is_packed_fp4(x: torch.Tensor) -> bool:
    return x.dtype in (torch.int8, torch.uint8)


def fp8_fp4_mqa_logits(q, kv, weights, cu_seq_len_k_start, cu_seq_len_k_end,
                       clean_logits: bool = True, max_seqlen_k: int = 0,
                       logits_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``logits[i, j] = sum_h w[i, h] * relu(q[i, h, :] . kv[j, :]) * sf[j]``
    for ``j`` in ``[ks[i], ke[i])``, -inf elsewhere; with ``max_seqlen_k >
    0`` the compressed [sq, max_seqlen_k] layout where row i starts at its
    own ks (0 past ke - ks). ``q`` is e4m3 [sq, h, d] (or a (q, None) pair),
    ``kv`` an (e4m3 [skv, d], f32 [skv] or None) pair."""
    q_val, q_sf = _split_pair(q)
    kv_val, kv_sf = _split_pair(kv)
    if _is_packed_fp4(q_val) or _is_packed_fp4(kv_val):
        raise NotImplementedError(_FP4_TODO)
    del q_sf, clean_logits          # the range fill is part of the kernel
    return mqa_kernel.mqa_logits(q_val, kv_val, weights, cu_seq_len_k_start,
                                 cu_seq_len_k_end, kv_sf=kv_sf, max_seqlen_k=max_seqlen_k,
                                 logits_dtype=logits_dtype)


def fp8_mqa_logits(q, kv, weights, cu_seqlen_ks, cu_seqlen_ke,
                   clean_logits: bool = True) -> torch.Tensor:
    """Legacy SM90 entry: f32 logits in the full [sq, skv] layout."""
    return fp8_fp4_mqa_logits(q, kv, weights, cu_seqlen_ks, cu_seqlen_ke,
                              clean_logits=clean_logits, max_seqlen_k=0,
                              logits_dtype=torch.float32)


def split_fused_kv_cache(fused_kv_cache: torch.Tensor, head_dim: int):
    """The fused byte cache [num_blocks, block_kv, 1, head_dim + 4] (a block's
    value bytes, then its f32 scale bytes) -> (e4m3 values [nb, bkv, d], f32
    scales [nb, bkv])."""
    nb, bkv = fused_kv_cache.shape[:2]
    flat = fused_kv_cache.reshape(nb, -1)
    if flat.shape[1] != bkv * (head_dim + 4):
        raise ValueError(f'fused cache: {flat.shape[1]} bytes a block, expected '
                         f'{bkv * (head_dim + 4)}')
    values = flat[:, :bkv * head_dim].reshape(nb, bkv, head_dim).contiguous()
    sf = flat[:, bkv * head_dim:].reshape(nb, bkv, 4).contiguous()
    return values.view(torch.float8_e4m3fn), sf.view(torch.float32).reshape(nb, bkv)


def fp8_fp4_paged_mqa_logits(q, fused_kv_cache, weights, context_lens, block_table,
                             schedule_meta=None, max_context_len: int = 0,
                             clean_logits: bool = True,
                             logits_dtype: torch.dtype = torch.float32, indices=None,
                             strategy: str = 'gather', max_batch: int = 0,
                             max_tokens_per_seq: int = 0) -> torch.Tensor:
    """Decode-side paged indexer scoring. ``q`` is e4m3 [B, next_n, h, d] (or
    a (q, None) pair); ``fused_kv_cache`` the reference byte layout
    (``d + 4`` bytes a token) or a pre-split (e4m3 values [nb, bkv, d], f32
    scales [nb, bkv]) pair; weights [B * next_n, h]; context_lens [B] or
    [B, next_n]; block_table [B, mb]. Returns [B * next_n, max_context_len]
    with -inf outside range. ``schedule_meta`` is accepted and unused, as in
    JAX: the kernel's grid needs no schedule."""
    q_val, _ = _split_pair(q)
    if indices is not None or max_batch or max_tokens_per_seq:
        raise NotImplementedError(_VARLEN_TODO)
    if _is_packed_fp4(q_val):
        raise NotImplementedError(_FP4_TODO)
    del schedule_meta, clean_logits
    d = q_val.shape[-1]
    if isinstance(fused_kv_cache, (tuple, list)):
        kv_cache, kv_sf = fused_kv_cache
        if _is_packed_fp4(kv_cache):
            raise NotImplementedError(_FP4_TODO)
    else:
        if fused_kv_cache.shape[-1] == d // 2 + 4:
            raise NotImplementedError(_FP4_TODO)
        kv_cache, kv_sf = split_fused_kv_cache(fused_kv_cache, d)
    if logits_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f'logits dtype {logits_dtype}: f32 or bf16')
    out = paged_mqa.paged_mqa_logits(q_val, kv_cache, kv_sf, weights, context_lens,
                                     block_table, max_context_len, strategy=strategy)
    return out.to(logits_dtype)


def fp8_paged_mqa_logits(q, fused_kv_cache, weights, context_lens, block_table,
                         schedule_meta=None, max_model_len: int = 0,
                         clean_logits: bool = True) -> torch.Tensor:
    """Legacy SM90 entry: f32 logits."""
    return fp8_fp4_paged_mqa_logits(q, fused_kv_cache, weights, context_lens, block_table,
                                    schedule_meta, max_model_len, clean_logits,
                                    torch.float32)


def clean_logits_(logits: torch.Tensor, cu_seq_len_k_start: torch.Tensor,
                  cu_seq_len_k_end: torch.Tensor) -> torch.Tensor:
    """Fill ``logits`` [sq, skv] outside each row's [ks, ke) with -inf, in
    place, and return it (JAX returns a new array; the indexer kernels fuse
    this fill)."""
    col = torch.arange(logits.shape[1], device=logits.device)[None, :]
    valid = (col >= cu_seq_len_k_start[:, None]) & (col < cu_seq_len_k_end[:, None])
    return logits.masked_fill_(~valid, float('-inf'))
