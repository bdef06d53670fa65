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
Kernel: csrc/paged_mqa.cu (both entries) on the Hopper body of
csrc/mqa_sm90.cuh, #7's (kv rows on wgmma's M, the query heads on N, the
ReLU, the weights and the head sum in registers), with its paged source: the
producer turns the block table into the cache rows of each stage's pages
and loads them by TMA (the gather entry's linearised cache is one page a
batch row). The two give the same bits. q and the cache are e4m3 or bf16
each (the bf16 instances run the decoded FP4 operands); e4m3 x e4m3 runs
widened exactly to bf16, so its sums are f32 sums of exact products, as the
plain version's are, and the decode's top-k selects what it selects. A batch row's
next_n tokens are one query tile, run as groups of queries that read the
same pages, so any next_n runs, as in JAX. Bound on the H100: the cache
bytes each row's context needs (bytes bound). Not ported: the TPU kernel's DMA knobs
(``DGT_ZC_SLOTS``, ``DGT_ZC_COALESCE`` and the page adjacency levels,
paged_mqa.py:415-482) and the JAX op's ``tile_kv`` chooser
(ops/attention.py:203-220): they tune the TPU's DMA engines and change
nothing the function computes.
"""

import ctypes

import torch

from ..runtime import build
from ..runtime.config import get_num_sms
from .common import select_rows, use_plain
from .mqa_logits import check_dtypes, check_shape, is_bf16, query_columns

# Kernel launches since the counts were last set to 0, by entry.
launches = {'gather': 0, 'paged': 0}
# The instance of the last launch: (q bf16, kv bf16, a query's columns), the
# template arguments of csrc/mqa_sm90.cuh's kernel beside Source::kPaged.
last_instance = None

NEG_INF = float('-inf')
STRATEGIES = ('gather', 'paged')


def _entry(strategy: str):
    lib = build.load('paged_mqa')
    if strategy == 'gather':
        fn = lib.dgt_paged_mqa_logits_gather
        argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    else:
        fn = lib.dgt_paged_mqa_logits_paged
        argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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


def _check(q: torch.Tensor, weights: torch.Tensor, kv: torch.Tensor):
    """Raise unless the operands are what the kernel takes (on any device)."""
    b, nn, h, d = q.shape
    check_dtypes(q, kv)
    if kv.shape[-1] != d:
        raise ValueError(f'cache head_dim {kv.shape[-1]} != q head_dim {d}')
    if tuple(weights.shape) != (b * nn, h):
        raise ValueError(f'weights: shape {tuple(weights.shape)}, expected [{b * nn}, {h}]')
    check_shape(h, d)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte aligned base (the tensor maps read
    from one)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launched(strategy: str, q: torch.Tensor, kv: torch.Tensor):
    global last_instance
    launches[strategy] += 1
    last_instance = (is_bf16(q), is_bf16(kv), query_columns(q.shape[2]))


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
    _check(q, weights, kv_lin)
    if use_plain(q, kv_lin, sf_lin, weights, hi):
        return paged_mqa_logits_plain(q, kv_lin, sf_lin, weights, hi, max_model_len)
    b, nn, h, d = q.shape
    q, kv_lin, sf_lin = _aligned(q), _aligned(kv_lin), _aligned(sf_lin.float())
    w, hi = weights.float().contiguous(), hi.to(torch.int32).contiguous()
    out = torch.empty((b * nn, max_model_len), dtype=torch.float32, device=q.device)
    lib, fn = _entry('gather')
    # lo null: every row's window starts at column 0
    code = fn(q.data_ptr(), w.data_ptr(), kv_lin.data_ptr(), sf_lin.data_ptr(), None,
              hi.data_ptr(), out.data_ptr(), b, nn, h, d, kv_lin.shape[1], max_model_len,
              is_bf16(q), is_bf16(kv_lin), get_num_sms(q.device),
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'paged_mqa_logits_gather')
    _launched('gather', q, kv_lin)
    return out


def paged_mqa_logits_paged(q: torch.Tensor, kv_cache: torch.Tensor, kv_sf: torch.Tensor,
                           weights: torch.Tensor, hi: torch.Tensor, block_table: torch.Tensor,
                           max_model_len: int) -> torch.Tensor:
    """The zero-copy entry: the pages kv_cache [num_blocks, block_kv, d] e4m3
    or bf16 and kv_sf [num_blocks, block_kv] f32 read in place through
    block_table [B, mb] (clamped to valid pages here). CPU tensors take the
    plain version (on the linearised cache: the same function), CUDA tensors
    launch the kernel or raise."""
    _check(q, weights, kv_cache)
    nb, bkv, d = kv_cache.shape
    bt = block_table.to(torch.int32).clamp(0, nb - 1).contiguous()
    if use_plain(q, kv_cache, kv_sf, weights, hi, bt):
        kv_lin, sf_lin = linearise(kv_cache, kv_sf, bt)
        return paged_mqa_logits_plain(q, kv_lin, sf_lin, weights, hi, max_model_len)
    b, nn, h, _ = q.shape
    q, kv_cache, kv_sf = _aligned(q), _aligned(kv_cache), _aligned(kv_sf.float())
    w, hi = weights.float().contiguous(), hi.to(torch.int32).contiguous()
    out = torch.empty((b * nn, max_model_len), dtype=torch.float32, device=q.device)
    lib, fn = _entry('paged')
    code = fn(q.data_ptr(), w.data_ptr(), kv_cache.data_ptr(), kv_sf.data_ptr(), bt.data_ptr(),
              None, hi.data_ptr(), out.data_ptr(), b, nn, h, d, nb, bt.shape[1], bkv,
              max_model_len, is_bf16(q), is_bf16(kv_cache), get_num_sms(q.device),
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'paged_mqa_logits_paged')
    _launched('paged', q, kv_cache)
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
