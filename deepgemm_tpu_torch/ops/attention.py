"""Attention (MQA lightning-indexer) public API, the counterpart of
deepgemm_tpu/ops/attention.py:

  * ``fp8_fp4_mqa_logits`` / legacy ``fp8_mqa_logits``: prefill scoring with
    per-row [ks, ke) windows, full or compressed layout;
  * ``fp8_fp4_paged_mqa_logits`` / legacy ``fp8_paged_mqa_logits``: decode
    scoring against a paged cache, 1-D or 2-D context lengths, any next_n,
    the 'gather' or 'paged' (zero-copy) strategy, and the varlen
    ``indices`` pairing in a host and a device form;
  * ``split_fused_kv_cache`` / ``split_fused_kv_cache_fp4``: the reference's
    fused byte caches into (values, scales);
  * ``get_paged_mqa_logits_metadata``: the balanced work schedule;
  * ``clean_logits_``: the -inf fill outside each row's window.

Packed FP4 operands (e2m1 codes two a byte with per-32 UE8M0 scales) are
decoded here into bf16, exactly (an e2m1 value times a power of two fits
bf16), and run the kernels' bf16 instances, as JAX folds them before its
kernels (deepgemm_tpu/ops/attention.py:23-35).
"""

from typing import Tuple

import numpy as np
import torch

from ..kernels import mqa_logits as mqa_kernel
from ..kernels import paged_mqa
from ..utils.math import decode_fp4_rows
from .gemm import _split_pair


def _is_packed_fp4(x: torch.Tensor) -> bool:
    return x.dtype in (torch.int8, torch.uint8)


def _decode_fp4_rows(packed: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
    """Packed e2m1 rows [..., d/2] with per-32 UE8M0 scales (packed int32
    [...] or f32 [..., d/32]) -> bf16 [..., d], exactly."""
    if sf is None:
        raise ValueError('packed FP4 operands need their per-32 scales')
    return decode_fp4_rows(packed, sf, 32)


def fp8_fp4_mqa_logits(q, kv, weights, cu_seq_len_k_start, cu_seq_len_k_end,
                       clean_logits: bool = True, max_seqlen_k: int = 0,
                       logits_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``logits[i, j] = sum_h w[i, h] * relu(q[i, h, :] . kv[j, :]) * sf[j]``
    for ``j`` in ``[ks[i], ke[i])``, -inf elsewhere; with ``max_seqlen_k >
    0`` the compressed [sq, max_seqlen_k] layout where row i starts at its
    own ks (0 past ke - ks). ``q`` is e4m3 [sq, h, d] (or a (q, None) pair),
    ``kv`` an (e4m3 [skv, d], f32 [skv] or None) pair.

    FP4: ``q = (packed e2m1 [sq, h, d/2] int8, per-32 UE8M0 scales [sq, h]
    packed int32)`` decodes into bf16; a packed ``kv = ([skv, d/2], [skv])``
    with it decodes too (its scale then 1), an e4m3 kv stays e4m3. A packed
    kv beside an e4m3 q raises: JAX hands its bytes to the kernel undecoded
    (deepgemm_tpu/ops/attention.py:48-53), which has no defined answer."""
    q_val, q_sf = _split_pair(q)
    kv_val, kv_sf = _split_pair(kv)
    if _is_packed_fp4(q_val):
        q_val = _decode_fp4_rows(q_val, q_sf)
        if _is_packed_fp4(kv_val):
            kv_val, kv_sf = _decode_fp4_rows(kv_val, kv_sf), None
    elif _is_packed_fp4(kv_val):
        raise ValueError('a packed FP4 kv needs a packed FP4 q: with an e4m3 q the JAX '
                         'op passes the packed bytes undecoded, which computes nothing defined')
    del clean_logits                # the range fill is part of the kernel
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


def split_fused_kv_cache_fp4(fused_kv_cache: torch.Tensor, head_dim: int):
    """The FP4 fused byte cache [num_blocks, block_kv, 1, head_dim / 2 + 4]
    (a block's packed e2m1 bytes, then one packed-UE8M0 int32 of per-32
    scales a token) -> (packed int8 [nb, bkv, d / 2], packed scales int32
    [nb, bkv])."""
    nb, bkv = fused_kv_cache.shape[:2]
    half = head_dim // 2
    flat = fused_kv_cache.reshape(nb, -1)
    if flat.shape[1] != bkv * (half + 4):
        raise ValueError(f'fused FP4 cache: {flat.shape[1]} bytes a block, expected '
                         f'{bkv * (half + 4)}')
    values = flat[:, :bkv * half].reshape(nb, bkv, half).contiguous()
    sf = flat[:, bkv * half:].reshape(nb, bkv, 4).contiguous()
    return values.view(torch.int8), sf.view(torch.int32).reshape(nb, bkv)


def get_paged_mqa_logits_metadata(context_lens: torch.Tensor, block_kv: int,
                                  num_sms: int) -> torch.Tensor:
    """The balanced work schedule of the paged decode: each batch row's
    context in ceil(ctx / block_kv) segments, and ``num_units = max(num_sms
    or 8, 1)`` workers each given the next ~total / num_units of them.
    Returns [num_units + 1, 2] int32 cursors (batch row, segment): worker
    u's start (past rows with no context), then the end. The port's copy of
    csrc/dgt_runtime.cpp:dgt_paged_mqa_schedule, written in torch on the
    lengths' device: a cumulative sum, then a search at total * u //
    num_units, so CUDA lengths give a CUDA table with no host sync. The
    kernels do not read it, as in JAX (its use to size the TPU's kv tile has
    no counterpart here)."""
    num_units = max(int(num_sms) if num_sms else 8, 1)
    lens = torch.as_tensor(context_lens).reshape(-1).long()
    splits = torch.div(lens + block_kv - 1, block_kv, rounding_mode='trunc')
    cum = torch.cat([splits.new_zeros(1), splits.cumsum(0)])   # segments before each row
    units = torch.arange(num_units + 1, device=lens.device)
    done = cum[-1:] * units // num_units                       # segments before each cursor
    row = torch.searchsorted(cum[1:], done, right=True)        # first row not yet done
    return torch.stack([row, done - cum[row]], dim=1).to(torch.int32)


def _varlen_group(indices) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """The host form of the varlen pairing (deepgemm_tpu/ops/attention.py:
    129-145): flat query rows grouped by sequence id, from the values. Returns each
    row's sequence id and rank within it, the sequence count and the most
    rows of one sequence."""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu()                             # a sync for CUDA indices
    idx = np.asarray(indices).astype(np.int64)
    if idx.ndim != 1:
        raise ValueError(f'indices: shape {idx.shape}, expected [batch]')
    raw_batch = int(idx.max()) + 1 if idx.size else 0
    order = np.argsort(idx, kind='stable')
    pos = np.empty(idx.shape[0], np.int64)
    pos[order] = np.arange(idx.shape[0]) - np.searchsorted(idx[order], idx[order])
    t_max = int(np.bincount(idx, minlength=max(raw_batch, 1)).max()) if idx.size else 0
    return idx, pos, raw_batch, t_max


def _varlen_group_device(indices: torch.Tensor, max_batch: int):
    """The device form (deepgemm_tpu/ops/attention.py:148-170,
    ``_varlen_group_traced``): the same grouping in torch on the indices'
    device, shapes fixed by the bounds, no host sync. Returns each row's
    sequence id and rank (int64) and each sequence's first row [max_batch]
    (0 for a sequence with no row); rows past a bound are dropped by the
    caller's scatters."""
    idx = indices.reshape(-1).long()
    b = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    idx_sorted = idx[order]
    ar = torch.arange(b, device=idx.device)
    pos = torch.empty_like(idx)
    pos[order] = ar - torch.searchsorted(idx_sorted, idx_sorted)
    inside = (idx >= 0) & (idx < max_batch)
    first_row = torch.full((max_batch + 1,), b, dtype=torch.long, device=idx.device)
    first_row.scatter_reduce_(0, torch.where(inside, idx, max_batch), ar, 'amin')
    first_row = first_row[:max_batch]
    return idx, pos, torch.where(first_row < b, first_row, 0)


def _scatter_rows(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...] zeros with row dst[i] = src[i]; a dst of n or more is
    dropped (it lands in a spare row that is cut off). e4m3 through bytes."""
    raw = src.view(torch.uint8) if src.dtype == torch.float8_e4m3fn else src
    out = raw.new_zeros((n + 1, *raw.shape[1:]))
    out.index_copy_(0, dst.clamp(max=n), raw)
    return out[:n].view(src.dtype)


def _paged_varlen(q_val, kv_cache, kv_sf, weights, context_lens, block_table, max_context_len,
                  indices, strategy, max_batch, max_tokens_per_seq):
    """The varlen pairing (deepgemm_tpu/ops/attention.py:237-275): the flat
    query rows of each sequence become one batch row of a 2-D-context call,
    so the
    sequence's pages stream once for all its tokens; the result comes back
    in the flat rows' order. A torch ``indices`` with a bound takes the
    device form, both bounds required; otherwise the host form, whose
    shapes come from the values (CUDA indices are read to the host: a
    sync), widened by any bound given, as in JAX."""
    b, nn, h, d = q_val.shape
    if nn != 1:
        raise ValueError(f'varlen takes next_n == 1, got {nn}')
    dev = q_val.device
    if isinstance(indices, torch.Tensor) and (max_batch > 0 or max_tokens_per_seq > 0):
        if max_batch <= 0 or max_tokens_per_seq <= 0:
            raise ValueError('the device form of varlen `indices` requires static bounds: '
                             'pass max_batch (> max sequence id) and max_tokens_per_seq '
                             '(>= rows of the largest sequence); without bounds the shapes '
                             'come from the values, read to the host')
        raw_batch, t_max = max_batch, max_tokens_per_seq
        idx, pos, first_row = _varlen_group_device(indices.to(dev), raw_batch)
        keep = (idx >= 0) & (idx < raw_batch) & (pos < t_max)
    else:
        idx, pos, raw_batch, t_max = _varlen_group(indices)
        raw_batch, t_max = max(raw_batch, max_batch), max(t_max, max_tokens_per_seq)
        if idx.shape[0] != b:
            raise ValueError(f'indices: {idx.shape[0]} rows, q has {b}')
        first_row = np.zeros(raw_batch, np.int64)
        first_row[idx[::-1]] = np.arange(b - 1, -1, -1)
        idx, pos, first_row = (torch.from_numpy(x).to(dev) for x in (idx, pos, first_row))
        keep = torch.ones_like(idx, dtype=torch.bool)
    n = raw_batch * t_max
    slot = torch.where(keep, idx * t_max + pos, n)          # the padded row of each flat row
    q_pad = _scatter_rows(q_val[:, 0], slot, n).view(raw_batch, t_max, h, d)
    w_pad = _scatter_rows(weights, slot, n)
    ctx2d = _scatter_rows(context_lens.reshape(-1).to(torch.int32), slot, n)
    out = paged_mqa.paged_mqa_logits(q_pad, kv_cache, kv_sf, w_pad,
                                     ctx2d.view(raw_batch, t_max), block_table[first_row],
                                     max_context_len, strategy=strategy)
    return out[(idx * t_max + pos).clamp(0, n - 1)]


def fp8_fp4_paged_mqa_logits(q, fused_kv_cache, weights, context_lens, block_table,
                             schedule_meta=None, max_context_len: int = 0,
                             clean_logits: bool = True,
                             logits_dtype: torch.dtype = torch.float32, indices=None,
                             strategy: str = 'gather', max_batch: int = 0,
                             max_tokens_per_seq: int = 0) -> torch.Tensor:
    """Decode-side paged indexer scoring. ``q`` is e4m3 [B, next_n, h, d] (or
    a (q, None) pair) or FP4 (packed e2m1 [B, next_n, h, d/2], per-32 UE8M0
    scales [B, next_n, h]); ``fused_kv_cache`` the reference byte layout
    (``d + 4`` bytes a token, or FP4 ``d/2 + 4``) or a pre-split pair (e4m3
    values [nb, bkv, d] with f32 scales [nb, bkv], or packed FP4 [nb, bkv,
    d/2] with packed scales [nb, bkv]); weights [B * next_n, h];
    context_lens [B] or [B, next_n]; block_table [B, mb]. Returns [B *
    next_n, max_context_len] with -inf outside range. An FP4 q and an FP4
    cache each decode into bf16 whatever the other is (the cache's scale
    then 1), as in JAX. ``indices`` [B] (next_n 1) pairs the flat rows of
    one sequence into one kernel row (see :func:`_paged_varlen`).
    ``schedule_meta`` is accepted and unused, as in JAX: the kernel's grid
    needs no schedule."""
    q_val, q_sf = _split_pair(q)
    d = 2 * q_val.shape[-1] if _is_packed_fp4(q_val) else q_val.shape[-1]
    if _is_packed_fp4(q_val):
        q_val = _decode_fp4_rows(q_val, q_sf)
    del schedule_meta, clean_logits
    if isinstance(fused_kv_cache, (tuple, list)):
        kv_cache, kv_sf = fused_kv_cache
        if _is_packed_fp4(kv_cache) and kv_cache.shape[-1] == d // 2:
            kv_cache = _decode_fp4_rows(kv_cache, kv_sf)
            kv_sf = torch.ones(kv_cache.shape[:2], dtype=torch.float32, device=kv_cache.device)
    elif fused_kv_cache.shape[-1] == d // 2 + 4:
        kv_cache = _decode_fp4_rows(*split_fused_kv_cache_fp4(fused_kv_cache, d))
        kv_sf = torch.ones(kv_cache.shape[:2], dtype=torch.float32, device=kv_cache.device)
    else:
        kv_cache, kv_sf = split_fused_kv_cache(fused_kv_cache, d)
    if logits_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f'logits dtype {logits_dtype}: f32 or bf16')
    if indices is not None:
        out = _paged_varlen(q_val, kv_cache, kv_sf, weights, context_lens, block_table,
                            max_context_len, indices, strategy, max_batch, max_tokens_per_seq)
    else:
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
