"""Grouped NT GEMMs for the MoE experts, bf16 or scaled FP8: the wrappers of
the CUDA kernels, their plain PyTorch versions and their launch counts.

Masked (decode). Replaces: deepgemm_tpu/kernels/grouped.py:_build_masked
(``pl.pallas_call`` at grouped.py:576).
Kernel: csrc/masked.cu on the Hopper mainloop of csrc/gemm_sm90.cuh (wgmma
+ TMA, warp-specialised, persistent; ``widen_body``, the body of the dense
forms on bf16 products): bf16, and e4m3 with the f32 promotion (B scaled
per 128 rows or per row; bf16 or f32 out), its codes widened exactly to
bf16 so that each 128-deep block's products are summed in f32 as the plain
version sums them (e4m3 wgmma sums at reduced precision).
Bound on the H100: the model's expert GEMMs have max_m = 40 rows per expert
against 4096 x 7168 (or 7168 x 2048) weights, ~80 operations per weight
byte, so streaming every expert's weights once from HBM bounds them. The
items are (group, row tile, column tile), 64-row tiles where max_m <= 64
(decode), else 128 (the einsum's 4096 rows a head), the column tiles of a
row tile on neighbouring SMs so its A rows come from L2; an item at or past
``masked_m[g]`` is skipped before any load. ``masked_m`` is read on the
device only, so no call syncs the host. The fused dispatch + L1
(kernels/fused_moe.py) runs the same body and is bitwise this kernel.

Contiguous (prefill and training). Replaces:
deepgemm_tpu/kernels/grouped.py:_build_contiguous (``pl.pallas_call`` at
grouped.py:240), NT (k-major B [G, n, k]) and NN (MN-major B [G, k, n], B's
BlockSpec at grouped.py:139-145), bf16 and e4m3 with the promotion.
Kernel: csrc/contiguous.cu on the Hopper mainloop of csrc/gemm_sm90.cuh
(wgmma + TMA, warp-specialised, persistent). Each m-tile's group and its
group's end row come from :func:`compute_tile_gids`, a few device ops on
``grouped_layout``: the host never reads the layout. The JAX kernel's
static equal-group and compare-chain paths are host-side speed variants of
the same function, so this one device-side lookup serves them all. Bound on
the H100: at the training step's shapes (256 experts of 128 rows against
4096 x 7168 or 7168 x 2048 weights) each expert's fp8 weights are read once
for 128 rows, 256 operations per weight byte, below the H100's ~590 fp8
operations per HBM byte, so weight bytes bound it. The tiles are 128 rows
where the mk alignment is a multiple of 128 (one pass over each expert's
weights), else 64, and the column tiles of one row tile run on neighbouring
SMs, so its A rows are read from L2. The NN form reads B as it lies (bf16:
wgmma's transposed B; e4m3: each stage transposed in shared memory) and is
bitwise the NT form on ``b.transpose(1, 2).contiguous()``.

Contiguous, dual-B form (``DGT_GROUPED_DUAL_B=1``). Replaces:
deepgemm_tpu/kernels/grouped.py:_build_contiguous_dual_b (``pl.pallas_call``
at grouped.py:401). Kernel: the same entry of csrc/contiguous.cu over
256 x 64 tiles whose two 128-row halves each read their own group's B
(:func:`compute_dual_tile_gids`, on the device). A tile whose halves share
a group stages its B once for 256 rows; a straddling tile stages both. Each
half computes what the contiguous kernel's tile computes, in the same order,
so the result is bitwise the contiguous kernel's. It is pinned only, as in
JAX (measured negative on the v5e there; its H100 time is in PERF.md): on
the card it can save L2 traffic, not HBM bytes.
"""

import ctypes
from typing import Optional

import torch

from ..heuristics.configs import BLOCK_M, DUAL_BLOCK_M, contiguous_block_m, get_sm90_config
from ..runtime import build
from ..runtime.config import get_mk_alignment_for_contiguous_layout, get_num_sms
from ..utils.math import align, ceil_div
from .common import (COUNT_LOCK, check_operand, count_launch, promote_block, psum_group_starts,
                     select_rows, sfb_shift, use_plain)

# Kernel launches per instantiation since the counts were last set to 0:
# the masked kernel (bf16 out; 'fp8_f32' the fp8 instance with f32 out) and
# the contiguous kernel's NT, NN and dual-B forms.
launches = {'bf16': 0, 'fp8': 0, 'fp8_f32': 0}
contiguous_launches = {'bf16': 0, 'fp8': 0}
contiguous_nn_launches = {'bf16': 0, 'fp8': 0}
dual_b_launches = {'bf16': 0, 'fp8': 0}
# The contiguous kernel's launches by body and form (see :func:`contiguous_form`).
contiguous_form_launches = {}

# The body that runs the contiguous kernel's forms (csrc/gemm_sm90.cuh).
CONTIGUOUS_BODY = 'wgmma'

# Rows of each half of a dual-B tile.
_DUAL_HALF = DUAL_BLOCK_M // 2

# Upcast at most this many bytes of f32 weights at once in the plain version
# (all 256 experts of a DeepSeek-V3 layer at once would take 30 GB).
_PLAIN_CHUNK_BYTES = 1 << 31


def _entry():
    fn = build.load('masked').dgt_masked_gemm_nt
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _contiguous_entry():
    fn = build.load('contiguous').dgt_contiguous_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def contiguous_form(kind: str, layout: str, block_m: int) -> str:
    """The key a contiguous launch is counted under in
    :data:`contiguous_form_launches`: the body, the form ('nt', 'nn' or
    'dual'), the operands ('bf16' or 'fp8') and the tile's rows."""
    return f'{CONTIGUOUS_BODY}_{layout}_{kind}_m{block_m}'


def masked_gemm_plain(a: torch.Tensor, b: torch.Tensor, masked_m: torch.Tensor,
                      sfa: Optional[torch.Tensor] = None,
                      sfb: Optional[torch.Tensor] = None, gran_n: int = 128,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch. Every row is computed; rows at
    or past ``masked_m[g]`` are unspecified in the contract, so
    ``masked_m`` is not read (no host sync)."""
    del masked_m
    num_groups, max_m, k = a.shape
    n = b.shape[1]
    d = torch.empty((num_groups, max_m, n), dtype=out_dtype, device=a.device)
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, n * k * 4))
    for g0 in range(0, num_groups, chunk):
        sl = slice(g0, g0 + chunk)
        if sfa is None:
            part = torch.matmul(a[sl].float(), b[sl].float().transpose(1, 2))
        else:
            part = promote_block(a[sl], b[sl], sfa[sl], sfb[sl], gran_n)
        d[sl] = part.to(out_dtype)
    return d


def masked_gemm(a: torch.Tensor, b: torch.Tensor, masked_m: torch.Tensor,
                sfa: Optional[torch.Tensor] = None,
                sfb: Optional[torch.Tensor] = None, gran_n: int = 128,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """d[g, :masked_m[g]] = a[g] @ b[g]^T in ``out_dtype``: bf16, or f32 for
    e4m3 operands (the same promoted sum, unrounded).

    ``a`` [G, max_m, k] and ``b`` [G, n, k] are both bf16 (no scales) or both
    e4m3 with f32 scales ``sfa`` [G, max_m, ceil(k/128)] and ``sfb``
    [G, ceil(n/gran_n), ceil(k/128)] (the promotion). ``masked_m`` [G] int32
    lies on the operands' device. Rows at or past ``masked_m[g]`` are
    unspecified.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    is_fp8 = a.dtype == torch.float8_e4m3fn
    if out_dtype not in (torch.bfloat16, torch.float32) or (out_dtype == torch.float32
                                                            and not is_fp8):
        raise NotImplementedError(f'output dtype {out_dtype} with {a.dtype} operands: '
                                  f'bf16, or f32 for e4m3 operands')
    if use_plain(a, b, masked_m, sfa, sfb):
        return masked_gemm_plain(a, b, masked_m, sfa, sfb, gran_n, out_dtype)
    num_groups, max_m, k = a.shape
    n = b.shape[1]
    dtype = torch.float8_e4m3fn if is_fp8 else torch.bfloat16
    shift = sfb_shift(gran_n)
    check_operand(a, 'a', dtype, (num_groups, max_m, k))
    check_operand(b, 'b', dtype, (num_groups, n, k))
    check_operand(masked_m, 'masked_m', torch.int32, (num_groups,))
    if is_fp8:
        if sfa is None or sfb is None:
            raise ValueError('fp8 operands need sfa and sfb')
        ksf = ceil_div(k, 128)
        check_operand(sfa, 'sfa', torch.float32, (num_groups, max_m, ksf))
        check_operand(sfb, 'sfb', torch.float32, (num_groups, ceil_div(n, gran_n), ksf))
    elif sfa is not None or sfb is not None:
        raise ValueError('scales go with e4m3 operands only')
    if min(num_groups, max_m, n, k) == 0 or k % 16 or n % 2:
        raise ValueError(f'the kernel takes non-empty shapes, k % 16 == 0 and '
                         f'even n; got G={num_groups}, max_m={max_m}, n={n}, k={k}')
    out_f32 = out_dtype == torch.float32
    cfg = get_sm90_config(max_m, n, num_groups, 4 if out_f32 else 2,
                          num_sms=get_num_sms(a.device), masked=True, elem=a.element_size())
    ksf = ceil_div(k, 128)
    sfa_ld, sfb_ld = align(max_m, 4), align(ceil_div(n, gran_n), 4)
    # the scales' k-first copies, which the entry writes in a pre-pass
    scratch = (torch.empty(num_groups * ksf * (sfa_ld + sfb_ld), dtype=torch.float32,
                           device=a.device) if is_fp8 else None)
    d = torch.empty((num_groups, max_m, n), dtype=out_dtype, device=a.device)
    fn = _entry()
    code = fn(a.data_ptr(), b.data_ptr(),
              sfa.data_ptr() if is_fp8 else None,
              sfb.data_ptr() if is_fp8 else None,
              None if scratch is None else scratch.data_ptr(),
              masked_m.data_ptr(), d.data_ptr(),
              num_groups, max_m, n, k, sfa_ld, sfb_ld, int(is_fp8), shift, int(out_f32),
              cfg.block_m, cfg.num_stages, cfg.num_sms,
              torch.cuda.current_stream(a.device).cuda_stream)
    build.check(build.load('masked'), code, 'masked_gemm')
    count_launch(launches, 'fp8_f32' if out_f32 else 'fp8' if is_fp8 else 'bf16')
    return d


def compute_tile_gids(grouped_layout: torch.Tensor, num_groups: int, m: int,
                      block_m: int, use_psum_layout: bool):
    """Per-m-tile (group id, group end row), int32 [ceil(m / block_m)] each,
    by device ops alone (counterpart of
    deepgemm_tpu/kernels/grouped.py:compute_tile_gids).

    ``grouped_layout`` is per-row group ids with -1 padding ([m]), or, with
    ``use_psum_layout``, per-group end rows ([G]; group g starts at the
    previous end aligned up to the mk alignment). ``block_m`` must divide
    that alignment, so a tile holds the rows of one group (the kernel's
    tiles: :func:`contiguous_block_m`); a tile of padding rows only takes
    the group before it, whose end row precedes the tile (the zero-padding
    epilogue then blanks it whole)."""
    align = get_mk_alignment_for_contiguous_layout()
    if align % block_m:
        raise ValueError(f'the mk alignment {align} is not a multiple of the kernel\'s '
                         f'{block_m}-row tiles')
    dev = grouped_layout.device
    layout = grouped_layout.long()
    tile_starts = torch.arange(ceil_div(m, block_m), device=dev) * block_m
    if use_psum_layout:
        ends = layout
        starts = psum_group_starts(ends)
        gids = torch.searchsorted(starts, tile_starts, right=True) - 1
        gids = gids.clamp(0, num_groups - 1)
        row_ends = ends[gids]
    else:
        ids = layout
        carried = torch.cummax(ids, dim=0).values.clamp(min=0)
        gids = carried[tile_starts]
        contrib = torch.where(ids >= 0, torch.arange(1, m + 1, device=dev), 0)
        ends_real = torch.zeros(num_groups, dtype=torch.long, device=dev).scatter_reduce(
            0, ids.clamp(min=0), contrib, 'amax')
        row_ends = ends_real[gids]
    return gids.int(), row_ends.int()


def compute_dual_tile_gids(grouped_layout: torch.Tensor, num_groups: int, m: int,
                           use_psum_layout: bool) -> torch.Tensor:
    """Per 256-row tile the groups of its top and bottom 128-row halves,
    int32 [m / 256, 2], by device ops alone: :func:`compute_tile_gids` at
    128-row blocks, paired. ``m`` must be a multiple of 256."""
    if m % (2 * _DUAL_HALF):
        raise ValueError(f'the dual-B form takes m % {2 * _DUAL_HALF} == 0, got m={m}')
    gids, _ = compute_tile_gids(grouped_layout, num_groups, m, _DUAL_HALF, use_psum_layout)
    return gids.view(-1, 2)


def _rows_by_tile_plain(a, b, gids, block, sfa, sfb, gran_n):
    """d[m, n] bf16: each ``block``-row tile of a against its group's B
    (``gids`` per tile), gathered a chunk of tiles at a time."""
    m, k = a.shape
    n = b.shape[1]
    tiles = gids.numel()
    rows = tiles * block

    def tiled(t):                       # [m, w] -> [tiles, block, w], zero rows past m
        out = torch.zeros((rows, t.shape[1]), dtype=t.dtype, device=t.device)
        out[:m] = t
        return out.view(tiles, block, t.shape[1])

    a_t = tiled(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).view(a.dtype)
    sfa_t = None if sfa is None else tiled(sfa)
    d = torch.empty((tiles, block, n), dtype=torch.bfloat16, device=a.device)
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, n * k * 4))
    for t0 in range(0, tiles, chunk):
        sl = slice(t0, t0 + chunk)
        g = gids[sl].long()
        b_c = select_rows(b, g)
        if sfa is None:
            part = torch.matmul(a_t[sl].float(), b_c.float().transpose(1, 2))
        else:
            part = promote_block(a_t[sl], b_c, sfa_t[sl], select_rows(sfb, g), gran_n)
        d[sl] = part.to(torch.bfloat16)
    return d.view(rows, n)[:m]


def contiguous_gemm_plain(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor,
                          sfa: Optional[torch.Tensor] = None,
                          sfb: Optional[torch.Tensor] = None, gran_n: int = 128,
                          use_psum_layout: bool = False,
                          ensure_zero_padding: bool = False,
                          b_mn: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same per-tile group
    lookup, then each tile's rows against its group's B, rows past the
    group's end zeroed on request."""
    if b_mn:
        b = _transposed(b)
    m = a.shape[0]
    gids, row_ends = compute_tile_gids(grouped_layout, b.shape[0], m, BLOCK_M,
                                       use_psum_layout)
    d = _rows_by_tile_plain(a, b, gids, BLOCK_M, sfa, sfb, gran_n)
    if ensure_zero_padding:
        row_end = row_ends.repeat_interleave(BLOCK_M)[:m]
        live = torch.arange(m, device=a.device) < row_end
        d = torch.where(live[:, None], d, torch.zeros((), dtype=d.dtype, device=d.device))
    return d


def contiguous_dual_gemm_plain(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor,
                               sfa: Optional[torch.Tensor] = None,
                               sfb: Optional[torch.Tensor] = None, gran_n: int = 128,
                               use_psum_layout: bool = False) -> torch.Tensor:
    """The dual-B kernel's function in plain PyTorch: 256-row tiles, each of
    their two halves against its own group's B."""
    pairs = compute_dual_tile_gids(grouped_layout, b.shape[0], a.shape[0], use_psum_layout)
    return _rows_by_tile_plain(a, b, pairs.view(-1), _DUAL_HALF, sfa, sfb, gran_n)


def _transposed(b: torch.Tensor) -> torch.Tensor:
    """[G, k, n] -> contiguous [G, n, k], for e4m3 too (through a byte view)."""
    if b.dtype == torch.float8_e4m3fn:
        return b.view(torch.uint8).transpose(1, 2).contiguous().view(b.dtype)
    return b.transpose(1, 2).contiguous()


def _check_contiguous_operands(a, b, grouped_layout, sfa, sfb, gran_n, use_psum_layout,
                               b_mn=False):
    """Raise unless the operands are what the contiguous kernels take."""
    m, k = a.shape
    num_groups = b.shape[0]
    n = b.shape[2] if b_mn else b.shape[1]
    is_fp8 = a.dtype == torch.float8_e4m3fn
    dtype = torch.float8_e4m3fn if is_fp8 else torch.bfloat16
    check_operand(a, 'a', dtype, (m, k))
    check_operand(b, 'b', dtype, (num_groups, k, n) if b_mn else (num_groups, n, k))
    if b_mn and n * a.element_size() % 16:
        raise ValueError(f'an MN-major B\'s rows must be whole 16-byte chunks; got n={n}')
    check_operand(grouped_layout, 'grouped_layout', torch.int32,
                  (num_groups,) if use_psum_layout else (m,))
    if is_fp8:
        if sfa is None or sfb is None:
            raise ValueError('fp8 operands need sfa and sfb')
        ksf = ceil_div(k, 128)
        check_operand(sfa, 'sfa', torch.float32, (m, ksf))
        check_operand(sfb, 'sfb', torch.float32, (num_groups, ceil_div(n, gran_n), ksf))
    elif sfa is not None or sfb is not None:
        raise ValueError('scales go with e4m3 operands only')
    if min(num_groups, m, n, k) == 0 or k % 16 or n % 2:
        raise ValueError(f'the kernel takes non-empty shapes, k % 16 == 0 and '
                         f'even n; got G={num_groups}, m={m}, n={n}, k={k}')


def _launch_contiguous(a, b, gids, row_ends, sfa, sfb, gran_n, b_mn, layout):
    """d [m, n] bf16 from the contiguous kernel's form ``layout`` ('nt',
    'nn' or 'dual') over the groups of its tiles ``gids`` (the chooser's
    tiles: :func:`contiguous_block_m` rows, 256 for 'dual') and their end
    rows (or None); counts the launch."""
    m, k = a.shape
    num_groups = b.shape[0]
    n = b.shape[2] if b_mn else b.shape[1]
    is_fp8 = a.dtype == torch.float8_e4m3fn
    kind = 'fp8' if is_fp8 else 'bf16'
    ksf = ceil_div(k, 128)
    sfa_ld = align(m, 4)
    sfb_ld = align(ceil_div(n, gran_n), 4)
    # the scales' k-first copies, which the entry writes in a pre-pass
    scratch = (torch.empty(ksf * (sfa_ld + num_groups * sfb_ld), dtype=torch.float32,
                           device=a.device) if is_fp8 else None)
    cfg = get_sm90_config(m, n, num_groups, 2, num_sms=get_num_sms(a.device),
                          contiguous=layout, elem=a.element_size(),
                          mk_alignment=get_mk_alignment_for_contiguous_layout())
    d = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    code = _contiguous_entry()(
        a.data_ptr(), b.data_ptr(), sfa.data_ptr() if is_fp8 else None,
        sfb.data_ptr() if is_fp8 else None, None if scratch is None else scratch.data_ptr(),
        gids.data_ptr(), None if row_ends is None else row_ends.data_ptr(), d.data_ptr(),
        m, n, k, num_groups, sfa_ld, sfb_ld, sfb_shift(gran_n), int(is_fp8), int(b_mn),
        cfg.block_m, cfg.num_stages, cfg.num_sms, torch.cuda.current_stream(a.device).cuda_stream)
    build.check(build.load('contiguous'), code, f'contiguous_gemm ({layout})')
    counts = {'nt': contiguous_launches, 'nn': contiguous_nn_launches,
              'dual': dual_b_launches}[layout]
    form = contiguous_form(kind, layout, cfg.block_m)
    with COUNT_LOCK:
        counts[kind] += 1
        contiguous_form_launches[form] = contiguous_form_launches.get(form, 0) + 1
    return d


def contiguous_gemm(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor,
                    sfa: Optional[torch.Tensor] = None, sfb: Optional[torch.Tensor] = None,
                    gran_n: int = 128, use_psum_layout: bool = False,
                    ensure_zero_padding: bool = False, b_mn: bool = False) -> torch.Tensor:
    """d[m, n] bf16 = a[m, k] @ b[gid(m-tile)][n, k]^T over the contiguous
    layout (see :func:`compute_tile_gids`).

    ``a`` [m, k] and ``b`` [G, n, k] (``b_mn``: [G, k, n], the NN layout,
    n % 16 == 0 for e4m3 and n % 8 == 0 for bf16) are both bf16 (no
    scales) or both e4m3 with f32 scales ``sfa`` [m, ceil(k/128)] and ``sfb``
    [G, ceil(n/gran_n), ceil(k/128)] (the promotion). ``grouped_layout``
    (int32, on the operands' device) is per-row ids [m] or, with
    ``use_psum_layout``, per-group end rows [G]. With
    ``ensure_zero_padding`` the rows past their group's end are zero;
    without it they hold whatever a's padding rows give.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if use_plain(a, b, grouped_layout, sfa, sfb):
        return contiguous_gemm_plain(a, b, grouped_layout, sfa, sfb, gran_n,
                                     use_psum_layout, ensure_zero_padding, b_mn)
    _check_contiguous_operands(a, b, grouped_layout, sfa, sfb, gran_n, use_psum_layout, b_mn)
    block_m = contiguous_block_m(get_mk_alignment_for_contiguous_layout())
    gids, row_ends = compute_tile_gids(grouped_layout, b.shape[0], a.shape[0], block_m,
                                       use_psum_layout)
    return _launch_contiguous(a, b, gids, row_ends if ensure_zero_padding else None, sfa, sfb,
                              gran_n, b_mn, 'nn' if b_mn else 'nt')


def contiguous_dual_gemm(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor,
                         sfa: Optional[torch.Tensor] = None, sfb: Optional[torch.Tensor] = None,
                         gran_n: int = 128, use_psum_layout: bool = False) -> torch.Tensor:
    """:func:`contiguous_gemm`'s function (no zero padding) in the dual-B
    form: 256-row tiles, ``m % 256 == 0``, the same operands. Bitwise
    :func:`contiguous_gemm`'s result.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if use_plain(a, b, grouped_layout, sfa, sfb):
        return contiguous_dual_gemm_plain(a, b, grouped_layout, sfa, sfb, gran_n,
                                          use_psum_layout)
    _check_contiguous_operands(a, b, grouped_layout, sfa, sfb, gran_n, use_psum_layout)
    pairs = compute_dual_tile_gids(grouped_layout, b.shape[0], a.shape[0], use_psum_layout)
    return _launch_contiguous(a, b, pairs, None, sfa, sfb, gran_n, False, 'dual')
