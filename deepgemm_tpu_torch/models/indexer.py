"""Lightning-indexer sparse attention, the consumer the MQA logits kernels
exist for (the counterpart of deepgemm_tpu/models/indexer.py): score every
cache position with the cheap fp8 indexer, keep the top-k per row, and run
exact attention over only those positions.

  prefill: fp8_fp4_mqa_logits -> top-k per query row -> gather -> attention
  decode:  fp8_fp4_paged_mqa_logits over the paged cache -> top-k ->
           'flat': flat token gather -> attention over the selected rows
           'pallas': the gather-fused attention, reading the selected rows
           in place from the cache (no gather)

The decode's ``DGT_SPARSE_GATHER`` (envs.py) picks between the two, with
JAX's value names and JAX's default 'flat'; both compute the same function
and, on the card, the same bits. Unlike JAX
(deepgemm_tpu/models/indexer.py:129-143), 'pallas' never drops quietly to
'flat': on CUDA tensors it launches the gather-fused kernel or raises
outside its contract.

The selection (a stable sort) and the flat gather are torch, as they are XLA
in JAX; the scoring and the attention are the port's kernels, on CUDA tensors
always. The JAX module's selection and attention switches
(``DGT_TOPK_METHOD``, ``DGT_SPARSE_ATTN``) and its '2level' gather have no
counterpart: they choose between ways to the same function, and JAX's own
measurements found the alternatives no faster (ROADMAP.md, Queue 1, "Not carried
over").
"""

import math
from typing import Optional, Tuple

import torch

from .. import envs
from ..kernels import sparse_attn
from ..ops import attention as attn_ops
from ..utils.math import cast_to_fp8, per_custom_dims_cast_to_fp8, topk_stable

GATHER_MODES = ('flat', 'pallas')


def _topk_indices(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k positions [rows, k] int32, ordered by score, and their
    validity (a row may have fewer than k in-range positions); ties toward
    the lower position, as ``lax.top_k`` (:func:`topk_stable`), so it gives
    JAX's set."""
    vals, idx = topk_stable(logits, k)
    return idx.to(torch.int32), torch.isfinite(vals)


def _index_q_fp8(index_q: torch.Tensor) -> torch.Tensor:
    """The indexer query as the serving recipe casts it: clipped to +-448,
    e4m3, no scale."""
    return cast_to_fp8(index_q.float())


@torch.no_grad()
def indexer_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             index_q: torch.Tensor, index_kv: torch.Tensor,
                             index_weights: torch.Tensor, ks: torch.Tensor,
                             ke: torch.Tensor, topk: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Prefill-side sparse attention. q/k/v [sq|skv, h, d] bf16 (the
    attention streams); index_q [sq, hi, di], index_kv [skv, di],
    index_weights [sq, hi] (the indexer streams); ks/ke [sq]: row i attends
    only within [ks_i, ke_i). Returns [sq, h, d]."""
    sq, h, d = q.shape
    skv = k.shape[0]
    scale = scale or 1.0 / math.sqrt(d)
    ikv, ikv_sf = per_custom_dims_cast_to_fp8(index_kv, (0,), use_ue8m0=False)
    logits = attn_ops.fp8_fp4_mqa_logits((_index_q_fp8(index_q), None), (ikv, ikv_sf),
                                         index_weights, ks, ke)
    sel, valid = _topk_indices(logits, topk)                       # [sq, topk]
    flat = sel.long().clamp(0, skv - 1).reshape(-1)
    k_sel = k.index_select(0, flat).view(sq, -1, h, d)
    v_sel = v.index_select(0, flat).view(sq, -1, h, d)
    return sparse_attn.gathered_attention(q, k_sel, v_sel, valid, scale)


@torch.no_grad()
def indexer_sparse_decode(q: torch.Tensor, kv_cache, index_cache, index_q: torch.Tensor,
                          index_weights: torch.Tensor, context_lens: torch.Tensor,
                          block_table: torch.Tensor, max_context_len: int, topk: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Decode-side sparse attention over a paged cache. q [B, 1, h, d] bf16;
    kv_cache = (k_pages, v_pages), each [num_blocks, block_kv, h, d] bf16;
    index_cache = (e4m3 values [num_blocks, block_kv, di], f32 scales
    [num_blocks, block_kv]); index_q [B, 1, hi, di]; index_weights [B, hi].
    Returns [B, 1, h, d]. ``DGT_SPARSE_GATHER`` 'flat' (the default) takes
    the selected rows with one gather of flat token rows; 'pallas' hands
    their flat indices to the gather-fused attention, which reads them in
    place (the pages are viewed flat, never copied); any other value
    raises."""
    b, nn, h, d = q.shape
    if nn != 1:
        raise ValueError(f'decode takes one query token a row, got next_n={nn}')
    k_pages, v_pages = kv_cache
    num_blocks, block_kv = k_pages.shape[:2]
    mb = block_table.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    gather_mode = envs.sparse_gather()
    if gather_mode not in GATHER_MODES:
        raise NotImplementedError(
            f'DGT_SPARSE_GATHER={gather_mode!r}: the port takes {GATHER_MODES} (the flat '
            f"token gather, or the gather-fused attention); JAX's '2level' gather is not "
            f'carried over (ROADMAP.md Queue 1, "Not carried over")')

    logits = attn_ops.fp8_fp4_paged_mqa_logits(
        (_index_q_fp8(index_q), None), index_cache, index_weights, context_lens,
        block_table, None, max_context_len)                          # [B, max_ctx]
    sel, valid = _topk_indices(logits, topk)                         # [B, topk]
    pos = sel.long().clamp(0, max_context_len - 1)
    pages, offs = pos // block_kv, pos % block_kv
    table = block_table.long().clamp(0, num_blocks - 1)
    blocks = torch.gather(table, 1, pages.clamp(max=mb - 1))         # [B, topk]
    tok = blocks * block_kv + offs                                   # [B, topk] flat rows
    k_rows, v_rows = k_pages.view(-1, h, d), v_pages.view(-1, h, d)
    if gather_mode == 'pallas':
        return sparse_attn.sparse_attention_paged(q[:, 0], k_rows, v_rows, tok, valid,
                                                  scale)[:, None]
    k_sel = k_rows.index_select(0, tok.reshape(-1)).view(b, -1, h, d)
    v_sel = v_rows.index_select(0, tok.reshape(-1)).view(b, -1, h, d)
    return sparse_attn.gathered_attention(q[:, 0], k_sel, v_sel, valid, scale)[:, None]
