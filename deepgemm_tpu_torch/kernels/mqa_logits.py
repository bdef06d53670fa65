"""MQA ("lightning indexer") logits of the prefill side: the wrapper of the
CUDA kernel, its plain PyTorch version and its launch count.

    logits[i, j] = sum_h w[i, h] * relu(q[i, h, :] . kv[j, :]) * sf[j]

for ``j`` in ``[ks[i], ke[i])``, -inf elsewhere; with ``max_seqlen_k > 0``
the compressed layout ``[sq, max_seqlen_k]``, where column ``c`` of row ``i``
is kv position ``ks[i] + c``, filled with 0 past ``ke[i] - ks[i]``.

Replaces: deepgemm_tpu/kernels/mqa_logits.py:_build_mqa_logits
(``pl.pallas_call`` at mqa_logits.py:133). Kernel: csrc/mqa_logits.cu on the
Hopper body of csrc/mqa_sm90.cuh (kv rows on wgmma's M, the query heads on
N, fed by TMA into a ring of stages; the ReLU, the weights and the head sum
in registers; tiles outside every row's window load nothing; a persistent
grid). q and kv are e4m3 or bf16 each: e4m3 x e4m3 runs wgmma e4m3, any bf16
operand wgmma bf16 with an e4m3 operand widened exactly, which runs the FP4
indexer operands the op layer decodes into bf16, as JAX feeds them to its
kernel (deepgemm_tpu/kernels/mqa_logits.py:106-109). Bound on the H100: the
bench shape (2048 x 8192, 64 heads, d 128) is tensor-core bound, ~1000 fp8
operations a byte. The compressed layout runs in the kernel when
``ks`` is constant over each tile of query rows (ks == 0 and context-parallel
chunks); ragged ``ks`` takes one full-layout pass and a per-row gather, as in
JAX (mqa_logits.py:183-202).
"""

import ctypes
from typing import Optional

import torch

from ..runtime import build
from ..runtime.config import get_num_sms
from ..utils.math import ceil_div
from .common import use_plain

# Kernel launches since the count was last set to 0.
launches = 0
# The instance of the last launch: (q bf16, kv bf16, a query's columns), the
# template arguments of csrc/mqa_sm90.cuh's kernel.
last_instance = None

NEG_INF = float('-inf')
OPERAND_DTYPES = (torch.float8_e4m3fn, torch.bfloat16)   # the kernels' instances
MAX_HEADS = 256         # csrc/mqa_sm90.cuh: a query's heads fill at most two n128 halves
_PLAIN_CHUNK = 1 << 26  # f32 scores per step of the plain version


def _entry():
    fn = build.load('mqa_logits').dgt_mqa_logits
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def is_bf16(t: torch.Tensor) -> int:
    """1 for a bf16 operand, 0 for e4m3: the C entries' instance flags."""
    return int(t.dtype == torch.bfloat16)


def rows_per_tile(num_heads: int) -> int:
    """Query rows of one tile, the compressed layout's unit (one kv base a
    tile): as many as fit 128 q2 rows (at least one)."""
    return max(1, 128 // num_heads)


def query_columns(h: int) -> int:
    """A query's wgmma columns in csrc/mqa_sm90.cuh: h rounded up to a power
    of two, at least 8 (the kernel's kHp)."""
    return max(8, 1 << (h - 1).bit_length())


def check_shape(h: int, d: int):
    """Raise unless csrc/mqa_sm90.cuh takes ``h`` heads of head_dim ``d``:
    d a multiple of 32 up to 256, 1 to MAX_HEADS heads (every operand pair
    fits the card's shared memory there)."""
    if not (d % 32 == 0 and 32 <= d <= 256 and 1 <= h <= MAX_HEADS):
        raise ValueError(f'the kernel takes head_dim a multiple of 32 up to 256 and 1 to '
                         f'{MAX_HEADS} heads; got d={d}, h={h}')


def check_dtypes(q: torch.Tensor, kv: torch.Tensor):
    """Raise unless q and kv are each e4m3 or bf16."""
    if q.dtype not in OPERAND_DTYPES or kv.dtype not in OPERAND_DTYPES:
        raise TypeError(f'q and kv must each be e4m3 or bf16, got {q.dtype} and {kv.dtype}')


def check_operands(q: torch.Tensor, kv: torch.Tensor, kv_sf: Optional[torch.Tensor],
                   weights: torch.Tensor):
    """Raise unless the operands are what the kernel takes (on any device)."""
    sq, h, d = q.shape
    check_dtypes(q, kv)
    if kv.dim() != 2 or kv.shape[1] != d:
        raise ValueError(f'kv: shape {tuple(kv.shape)}, expected [skv, {d}]')
    if kv_sf is not None and (kv_sf.dtype != torch.float32 or tuple(kv_sf.shape) != (kv.shape[0],)):
        raise ValueError(f'kv_sf: {kv_sf.dtype} {tuple(kv_sf.shape)}, expected f32 [{kv.shape[0]}]')
    if tuple(weights.shape) != (sq, h):
        raise ValueError(f'weights: shape {tuple(weights.shape)}, expected [{sq}, {h}]')
    check_shape(h, d)


def mqa_logits_plain(q: torch.Tensor, kv: torch.Tensor, kv_sf: Optional[torch.Tensor],
                     weights: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     kv_base: Optional[torch.Tensor], out_cols: int,
                     fill: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: column ``c`` of row ``i`` is kv
    row ``base_i + c`` (``kv_base`` per tile of ``rows_per_tile(h)`` rows, or
    0), kept on ``[lo_i, hi_i)``, ``fill`` elsewhere. Products in f32 on the
    upcast operands (exact for e4m3 and bf16), a few rows at a time."""
    sq, h, d = q.shape
    skv = kv.shape[0]
    base = None if kv_base is None else kv_base.long().repeat_interleave(rows_per_tile(h))[:sq]
    cols = torch.arange(out_cols, device=q.device)
    kv_f = kv.float()
    sf = torch.ones(skv, device=q.device) if kv_sf is None else kv_sf
    out = torch.empty((sq, out_cols), dtype=torch.float32, device=q.device)
    step = max(1, _PLAIN_CHUNK // max(1, h * out_cols))
    for i0 in range(0, sq, step):
        i1 = min(sq, i0 + step)
        # the kv row of each column: [1, out_cols] shared, or [n, out_cols] per row
        src = cols[None, :] if base is None else base[i0:i1, None] + cols[None, :]
        inside = src < skv
        src = src.clamp(max=skv - 1)
        kv_rows = torch.where(inside[..., None], kv_f[src], 0.0)
        scores = torch.matmul(q[i0:i1].float(), kv_rows.transpose(1, 2))     # [n, h, out_cols]
        scores = torch.relu(scores) * torch.where(inside, sf[src], 0.0)[:, None, :]
        logits = (scores * weights[i0:i1].float()[:, :, None]).sum(1)
        valid = (cols[None, :] >= lo[i0:i1, None]) & (cols[None, :] < hi[i0:i1, None])
        out[i0:i1] = torch.where(valid, logits, fill)
    return out


def mqa_logits_kernel(q: torch.Tensor, kv: torch.Tensor, kv_sf: Optional[torch.Tensor],
                      weights: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      kv_base: Optional[torch.Tensor], out_cols: int,
                      fill: float) -> torch.Tensor:
    """:func:`mqa_logits_plain`'s function: CPU tensors take the plain
    version, CUDA tensors launch the kernel or raise."""
    check_operands(q, kv, kv_sf, weights)
    if use_plain(q, kv, kv_sf, weights, lo, hi, kv_base):
        return mqa_logits_plain(q, kv, kv_sf, weights, lo, hi, kv_base, out_cols, fill)
    sq, h, d = q.shape
    bq = rows_per_tile(h)
    # the tensor maps read from 16-byte aligned bases
    aligned = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()
    q = aligned(q.contiguous())
    kv = aligned(kv.contiguous())
    w = weights.float().contiguous()
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    sf = None if kv_sf is None else aligned(kv_sf.contiguous())
    base = None if kv_base is None else kv_base.to(torch.int32).contiguous()
    if base is not None and base.numel() != ceil_div(sq, bq):
        raise ValueError(f'kv_base: {base.numel()} entries, expected one per {bq} query rows')
    out = torch.empty((sq, out_cols), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = build.load('mqa_logits')
    code = _entry()(q.data_ptr(), w.data_ptr(), kv.data_ptr(), ptr(sf), lo.data_ptr(),
                    hi.data_ptr(), ptr(base), out.data_ptr(), sq, bq, h, d, kv.shape[0],
                    out_cols, fill, is_bf16(q), is_bf16(kv), get_num_sms(q.device),
                    torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'mqa_logits')
    global launches, last_instance
    launches += 1
    last_instance = (is_bf16(q), is_bf16(kv), query_columns(h))
    return out


def mqa_logits(q: torch.Tensor, kv: torch.Tensor, weights: torch.Tensor,
               ks: torch.Tensor, ke: torch.Tensor, kv_sf: Optional[torch.Tensor] = None,
               max_seqlen_k: int = 0,
               logits_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q [sq, h, d] e4m3 or bf16; kv [skv, d] e4m3 or bf16 (+ per-token kv_sf
    [skv] f32);
    weights [sq, h]; ks/ke [sq] int. Returns [sq, skv] logits with -inf
    outside [ks, ke), or the compressed [sq, max_seqlen_k] layout (0 past
    ke - ks). The compressed layout checks on the host whether ks is constant
    over each tile of query rows, as JAX does with a concrete ks."""
    sq, h, _ = q.shape
    skv = kv.shape[0]
    if logits_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f'logits dtype {logits_dtype}: f32 or bf16')
    ks, ke = ks.to(torch.int32), ke.to(torch.int32)
    if max_seqlen_k <= 0:
        out = mqa_logits_kernel(q, kv, kv_sf, weights, ks, ke, None, skv, NEG_INF)
        return out.to(logits_dtype)
    bq = rows_per_tile(h)
    tiles = ceil_div(sq, bq)
    ks_tiles = torch.cat([ks, ks[-1:].expand(tiles * bq - sq)]).view(tiles, bq)
    if not bool((ks_tiles == ks_tiles[:, :1]).all()):
        # ragged ks: one full-layout pass, then each row's [ks, ks + max_seqlen_k)
        full = mqa_logits_kernel(q, kv, kv_sf, weights, ks, ke, None, skv, NEG_INF)
        cols = ks[:, None].long() + torch.arange(max_seqlen_k, device=q.device)[None, :]
        vals = torch.gather(full, 1, cols.clamp(0, skv - 1))
        return torch.where(cols < ke[:, None], vals, 0.0).to(logits_dtype)
    out = mqa_logits_kernel(q, kv, kv_sf, weights, torch.zeros_like(ks), ke - ks,
                            ks_tiles[:, 0].contiguous(), max_seqlen_k, 0.0)
    return out.to(logits_dtype)
