"""Paged MQA logits of the decode side (the indexer scoring of every batch
row's next_n query tokens against its paged fp8 cache): the wrappers of the
two CUDA entries, their plain PyTorch versions and their launch counts.

    logits[b * nn + t, j] = sum_h w * relu(q[b, t, h, :] . kv(b, j)) * sf(b, j)

where ``kv(b, j)`` is row ``j % block_kv`` of page ``block_table[b, j //
block_kv]``, for ``j`` below the causal offset ``ctx[b] - nn + 1 + t`` (a
1-D context) or the token's own ``ctx[b, t]`` (2-D), -inf elsewhere
(deepgemm_tpu/kernels/paged_mqa.py:143-158).

Replaces:
  * the 'gather' strategy, deepgemm_tpu/kernels/paged_mqa.py:_build_paged_mqa
    (``pl.pallas_call`` at paged_mqa.py:166): the wrapper linearises each
    batch row's pages with a torch ``index_select`` (an XLA gather in JAX,
    paged_mqa.py:446-452) and the kernel streams them;
  * the 'paged' (zero-copy) strategy, _build_paged_mqa_zerocopy
    (``pl.pallas_call`` at paged_mqa.py:382): the kernel reads the pages and
    their scales in place through the clamped block table.
Kernel: csrc/paged_mqa.cu (both entries) on the body of csrc/mqa_tile.cuh;
the two give the same bits. q and the cache are e4m3 or bf16 each (the bf16
instances run the decoded FP4 operands). A batch row's next_n tokens run as
one query tile, or, where its q2 rows (next_n x heads) do not fit one block,
as several tiles of :func:`tile_rows` tokens that read the same pages, so
any next_n runs, as in JAX. Bound on the H100: the cache bytes each row's
context needs (bytes bound). Not ported: the TPU kernel's DMA knobs
(``DGT_ZC_SLOTS``, ``DGT_ZC_COALESCE`` and the page adjacency levels,
paged_mqa.py:415-482) and the JAX op's ``tile_kv`` chooser
(ops/attention.py:203-220): they tune the TPU's DMA engines and change
nothing the function computes.
"""

import ctypes

import torch

from ..runtime import build
from ..utils.math import ceil_div
from .common import select_rows, use_plain
from .mqa_logits import check_dtypes, is_bf16

# Kernel launches since the counts were last set to 0, by entry.
launches = {'gather': 0, 'paged': 0}

NEG_INF = float('-inf')
STRATEGIES = ('gather', 'paged')
# csrc/mqa_tile.cuh: q2 rows (query rows x heads) of one block, output columns
# of a kv tile, the score tile's f32 pitch, kv tiles a block, shared memory
MAX_ROWS, _BN, _S_PITCH, _TILES_PER_BLOCK, MAX_SMEM = 256, 64, 68, 4, 232448


def _entry(strategy: str):
    lib = build.load('paged_mqa')
    if strategy == 'gather':
        fn = lib.dgt_paged_mqa_logits_gather
        argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    else:
        fn = lib.dgt_paged_mqa_logits_paged
        argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def row_bounds(context_lens: torch.Tensor, next_n: int) -> torch.Tensor:
    """[B * nn] int32: the end of each query row's valid columns (the causal
    offset with a 1-D context, the token's own context with a 2-D one)."""
    ctx = context_lens.to(torch.int32)
    if ctx.dim() == 2:
        return ctx.reshape(-1).contiguous()
    t = torch.arange(next_n, dtype=torch.int32, device=ctx.device)
    return (ctx[:, None] - next_n + 1 + t[None, :]).reshape(-1).contiguous()


def smem_bytes(rows: int, h: int, d: int, q_bytes: int, kv_bytes: int) -> int:
    """Shared memory of one block of ``rows`` query rows (csrc/mqa_tile.cuh
    smem_bytes): each operand is kept in its own type (1 byte e4m3, 2 bf16)."""
    rp = ceil_div(rows * h, 16) * 16
    return (rp * (d * q_bytes + 16) + 2 * _BN * (d * kv_bytes + 16) + rp * _S_PITCH * 4
            + 2 * _BN * 4 + rows * h * 4 + 2 * rows * 4 + (_TILES_PER_BLOCK * _BN + 1) * 4)


def fits_tile(rows: int, h: int, d: int, q_dtype: torch.dtype, kv_dtype: torch.dtype) -> bool:
    """Whether one block takes ``rows`` query rows of ``h`` heads at head_dim
    ``d``: d a multiple of 32 up to 256, at most MAX_ROWS q2 rows, and the
    shared memory of the operands' instance within the H100's 227 KB."""
    size = lambda dt: 2 if dt == torch.bfloat16 else 1
    return (d % 32 == 0 and 32 <= d <= 256 and 1 <= rows * h <= MAX_ROWS
            and smem_bytes(rows, h, d, size(q_dtype), size(kv_dtype)) <= MAX_SMEM)


def tile_rows(next_n: int, h: int, d: int, q_dtype: torch.dtype,
              kv_dtype: torch.dtype) -> int:
    """Query tokens of one kernel tile: the largest divisor of next_n whose
    q2 rows fit one block (:func:`fits_tile`), so a batch row's
    tokens split into equal tiles and no row is padded. Raises if not even
    one token fits."""
    for rows in range(next_n, 0, -1):
        if next_n % rows == 0 and fits_tile(rows, h, d, q_dtype, kv_dtype):
            return rows
    raise ValueError(f'the kernel takes head_dim a multiple of 32 up to 256 and one query '
                     f'token of {h} heads in a block; got d={d}, {q_dtype} x {kv_dtype}')


def _check(q: torch.Tensor, weights: torch.Tensor, kv: torch.Tensor) -> int:
    """Raise unless the operands are what the kernel takes; returns
    :func:`tile_rows`."""
    b, nn, h, d = q.shape
    check_dtypes(q, kv)
    if kv.shape[-1] != d:
        raise ValueError(f'cache head_dim {kv.shape[-1]} != q head_dim {d}')
    if tuple(weights.shape) != (b * nn, h):
        raise ValueError(f'weights: shape {tuple(weights.shape)}, expected [{b * nn}, {h}]')
    return tile_rows(nn, h, d, q.dtype, kv.dtype)


def linearise(kv_cache: torch.Tensor, kv_sf: torch.Tensor, block_table: torch.Tensor):
    """The 'gather' strategy's copy: each batch row's pages in order,
    kv_lin [B, mb * block_kv, d] and sf_lin [B, mb * block_kv]."""
    b, mb = block_table.shape
    nb, bkv, d = kv_cache.shape
    bt = block_table.reshape(-1).long()
    kv_lin = select_rows(kv_cache, bt).view(b, mb * bkv, d)
    sf_lin = kv_sf.float().index_select(0, bt).view(b, mb * bkv)
    return kv_lin, sf_lin


def paged_mqa_logits_plain(q: torch.Tensor, kv_lin: torch.Tensor, sf_lin: torch.Tensor,
                           weights: torch.Tensor, hi: torch.Tensor,
                           max_model_len: int) -> torch.Tensor:
    """Both entries' function in plain PyTorch, on the linearised cache:
    products in f32 on the upcast operands (exact for e4m3 and bf16), then the ReLU,
    the scale, the weighted head sum and the mask, one batch row at a time.
    Columns past the linearised cache read as zero rows, as in the kernel."""
    b, nn, h, d = q.shape
    n = min(kv_lin.shape[1], max_model_len)
    cols = torch.arange(max_model_len, device=q.device)
    out = torch.empty((b * nn, max_model_len), dtype=torch.float32, device=q.device)
    w = weights.float().view(b, nn, h)
    for i in range(b):
        scores = torch.einsum('thd,jd->thj', q[i].float(), kv_lin[i, :n].float())
        scores = torch.relu(scores) * sf_lin[i, :n].float()
        logits = torch.zeros((nn, max_model_len), dtype=torch.float32, device=q.device)
        logits[:, :n] = (scores * w[i][:, :, None]).sum(1)
        valid = cols[None, :] < hi[i * nn:(i + 1) * nn, None]
        out[i * nn:(i + 1) * nn] = torch.where(valid, logits, NEG_INF)
    return out


def paged_mqa_logits_gather(q: torch.Tensor, kv_lin: torch.Tensor, sf_lin: torch.Tensor,
                            weights: torch.Tensor, hi: torch.Tensor,
                            max_model_len: int) -> torch.Tensor:
    """The 'gather' entry on the linearised cache (see :func:`linearise`):
    q [B, nn, h, d] e4m3 or bf16, weights [B * nn, h] f32, hi [B * nn] int32
    (see :func:`row_bounds`). CPU tensors take the plain version, CUDA
    tensors launch the kernel or raise."""
    rows = _check(q, weights, kv_lin)
    if use_plain(q, kv_lin, sf_lin, weights, hi):
        return paged_mqa_logits_plain(q, kv_lin, sf_lin, weights, hi, max_model_len)
    b, nn, h, d = q.shape
    q, kv_lin, sf_lin = q.contiguous(), kv_lin.contiguous(), sf_lin.float().contiguous()
    w, hi = weights.float().contiguous(), hi.to(torch.int32).contiguous()
    lo = torch.zeros_like(hi)
    out = torch.empty((b * nn, max_model_len), dtype=torch.float32, device=q.device)
    lib, fn = _entry('gather')
    code = fn(q.data_ptr(), w.data_ptr(), kv_lin.data_ptr(), sf_lin.data_ptr(), lo.data_ptr(),
              hi.data_ptr(), out.data_ptr(), b, nn, rows, h, d, kv_lin.shape[1], max_model_len,
              is_bf16(q), is_bf16(kv_lin), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'paged_mqa_logits_gather')
    launches['gather'] += 1
    return out


def paged_mqa_logits_paged(q: torch.Tensor, kv_cache: torch.Tensor, kv_sf: torch.Tensor,
                           weights: torch.Tensor, hi: torch.Tensor, block_table: torch.Tensor,
                           max_model_len: int) -> torch.Tensor:
    """The zero-copy entry: the pages kv_cache [num_blocks, block_kv, d] e4m3
    or bf16 and kv_sf [num_blocks, block_kv] f32 read in place through
    block_table [B, mb] (clamped to valid pages here). CPU tensors take the
    plain version (on the linearised cache: the same function), CUDA tensors
    launch the kernel or raise."""
    rows = _check(q, weights, kv_cache)
    nb, bkv, d = kv_cache.shape
    bt = block_table.to(torch.int32).clamp(0, nb - 1).contiguous()
    if use_plain(q, kv_cache, kv_sf, weights, hi, bt):
        kv_lin, sf_lin = linearise(kv_cache, kv_sf, bt)
        return paged_mqa_logits_plain(q, kv_lin, sf_lin, weights, hi, max_model_len)
    b, nn, h, _ = q.shape
    q, kv_cache, kv_sf = q.contiguous(), kv_cache.contiguous(), kv_sf.float().contiguous()
    w, hi = weights.float().contiguous(), hi.to(torch.int32).contiguous()
    lo = torch.zeros_like(hi)
    out = torch.empty((b * nn, max_model_len), dtype=torch.float32, device=q.device)
    lib, fn = _entry('paged')
    code = fn(q.data_ptr(), w.data_ptr(), kv_cache.data_ptr(), kv_sf.data_ptr(), bt.data_ptr(),
              lo.data_ptr(), hi.data_ptr(), out.data_ptr(), b, nn, rows, h, d, bt.shape[1], bkv,
              max_model_len, is_bf16(q), is_bf16(kv_cache),
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'paged_mqa_logits_paged')
    launches['paged'] += 1
    return out


def paged_mqa_logits(q: torch.Tensor, kv_cache: torch.Tensor, kv_sf: torch.Tensor,
                     weights: torch.Tensor, context_lens: torch.Tensor,
                     block_table: torch.Tensor, max_model_len: int,
                     strategy: str = 'gather') -> torch.Tensor:
    """q [B, next_n, h, d] e4m3 or bf16 (any next_n); kv_cache [num_blocks,
    block_kv, d] e4m3 or bf16 with per-token kv_sf [num_blocks, block_kv]
    f32; weights [B * next_n, h];
    context_lens [B] (1-D, causal per-token offsets) or [B, next_n] (2-D);
    block_table [B, mb]. Returns f32 [B * next_n, max_model_len], -inf
    outside range. ``strategy`` 'gather' (the default) linearises the pages
    first; 'paged' reads them in place; both give the same bits."""
    if strategy not in STRATEGIES:
        raise ValueError(f'strategy {strategy!r}: one of {STRATEGIES}')
    hi = row_bounds(context_lens, q.shape[1])
    if strategy == 'paged':
        return paged_mqa_logits_paged(q, kv_cache, kv_sf, weights, hi, block_table,
                                      max_model_len)
    bt = block_table.to(torch.int32).clamp(0, kv_cache.shape[0] - 1)
    kv_lin, sf_lin = linearise(kv_cache, kv_sf, bt)
    return paged_mqa_logits_gather(q, kv_lin, sf_lin, weights, hi, max_model_len)
