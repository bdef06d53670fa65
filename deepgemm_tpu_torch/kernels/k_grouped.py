"""K-grouped GEMM (the MoE weight gradient), bf16 or FP8 with per-channel
scales: the wrapper of the CUDA kernel, its plain PyTorch version and its
launch counts.

Replaces: deepgemm_tpu/kernels/k_grouped.py:_build_k_grouped
(``pl.pallas_call`` at k_grouped.py:237).
Kernels: csrc/k_grouped.cu. FP8 runs the Hopper mainloop of
csrc/gemm_sm90.cuh: a persistent grid walks (group, row tile, column tile)
work items, TMA loads each 128-deep k block, wgmma multiplies it and the
f32 promotion applies the group's compacted k-first scales. Like the JAX
wrapper (k_grouped.py:438-440) this one turns the TN operands k-major with
one copy (:func:`tn_relayout`, the transposing gather of csrc/relayout.cuh,
:func:`common.k_major_relayout`); the copy places group g at column 128 x sf_start[g] with
zeros up to the next 128 (its scale rows count its 128-deep blocks, so the
copy is 128 x nsf columns wide, known on the host without a sync), and no
128-column TMA box crosses a group. bf16 runs the mma.sync
mainloop of csrc/gemm_mainloop.cuh over a copy with each group at a
16-element aligned column, one grid slice per group.
Bound on the H100: at the training step's wgrad shapes (256 groups of 128
rows into [4096, 7168] or [7168, 2048] per group) each output element takes
256 operations and is written once, 2 bytes in bf16 or 4 in f32, so the
output's bytes bound it (15 GB in bf16 at L1). The bf16 epilogue exists for
that: it rounds the same f32 sum once, the bits of f32-then-cast without the
f32 tensor; the kernel writes whole rows while the next item's loads run.

The flat NT form (``k_grouped_fp8_gemm_nt_contiguous``,
deepgemm_tpu/ops/k_grouped.py:66-96): each group's A and B segments stored
k-major and flattened, ``a[m x k_g]`` from element ``m * k_start[g]``. JAX
unflattens them (XLA fuses that into the kernel's reads); here the flat
entry of csrc/k_grouped.cu reads each segment in place through a tensor map
per group, so no relayout copy precedes it. Every depth must be a multiple
of 16 elements (a tensor map's row stride is whole 16 bytes); the wrapper
raises otherwise. TMA zero-fills past each depth, so its stages hold the
bytes of the TN form's on the same data: it is bitwise the TN kernel.
"""

import ctypes
from typing import Optional, Sequence

import torch

from ..heuristics.configs import get_gemm_config, get_sm90_config
from ..runtime import build
from ..runtime.config import get_num_sms
from ..utils.math import align, ceil_div
from .common import (check_operand, k_major_relayout, k_major_relayout_plain, psum_group_starts,
                     use_plain)

# Kernel launches per operand type since the counts were last set to 0, and
# of the flat NT form (e4m3). The FP8 TN form's relayout (one per operand)
# counts as common.relayout_launches['k_grouped'].
launches = {'bf16': 0, 'fp8': 0}
flat_launches = 0

_GRAN_K = 128           # scale block depth: one stage of the fp8 mainloop
_COL_ALIGN = 16         # elements: each group's first column in the bf16 k-major copy
_MAP_BYTES = 128        # one CUtensorMap
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _fp8_entry():
    fn = build.load('k_grouped').dgt_k_grouped_fp8_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bf16_entry():
    fn = build.load('k_grouped').dgt_k_grouped_bf16_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flat_entry():
    fn = build.load('k_grouped').dgt_k_grouped_fp8_gemm_flat
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def compute_k_group_metadata(grouped_layout: torch.Tensor, use_psum_layout: bool,
                             gran_k: int = _GRAN_K):
    """Per-group (first row, depth, first scale row), int64 [G] each, by
    device ops alone: the counterpart of
    deepgemm_tpu/kernels/k_grouped.py:compute_k_tile_metadata, which turns
    the same three per group into a table per k-tile. This kernel walks each
    group's own k range, so the per-group values are all it needs.

    ``grouped_layout`` is per-group depths [G] (groups packed back to back)
    or, with ``use_psum_layout``, per-group end rows [G] (group g starts at
    the previous end aligned up to the 128-row mk alignment; a group whose
    aligned start passes its end is empty). Scales are compacted per group:
    ceil(depth / gran_k) rows each, in group order."""
    layout = grouped_layout.long()
    if use_psum_layout:
        starts = psum_group_starts(layout)
        sizes = (layout - starts).clamp(min=0)
    else:
        sizes = layout
        starts = torch.cumsum(sizes, 0) - sizes
    sf_rows = (sizes + gran_k - 1) // gran_k
    sf_starts = torch.cumsum(sf_rows, 0) - sf_rows
    return starts, sizes, sf_starts


def _k_major_columns(starts: torch.Tensor, sizes: torch.Tensor, total_k: int, col_align: int,
                     ldk: int):
    """The source row of each column of the k-major copy [dim, ldk] of a TN
    operand [total_k, dim] (int32 [ldk], -1 for a zero column), with group g
    at column ``pstarts[g]``: each group padded to a multiple of
    ``col_align`` columns, back to back. Returns (src, pstarts)."""
    padded = (sizes + col_align - 1) // col_align * col_align
    pstarts = torch.cumsum(padded, 0) - padded
    src = torch.full((ldk + 1,), -1, dtype=torch.long, device=sizes.device)
    if total_k:
        rows = torch.arange(total_k, device=sizes.device)
        g = (torch.searchsorted(starts, rows, right=True) - 1).clamp(0, sizes.numel() - 1)
        local = rows - starts[g]
        live = (local >= 0) & (local < sizes[g])
        src.scatter_(0, torch.where(live, pstarts[g] + local, ldk), rows)
    return src[:ldk].int().contiguous(), pstarts


def _rows_of_4(sf: torch.Tensor) -> torch.Tensor:
    """k-first scales [nsf, dim] with each row padded to a multiple of 4
    (16 bytes: the kernel copies scale rows in bulk)."""
    pad = -sf.shape[1] % 4
    return torch.nn.functional.pad(sf, (0, pad)) if pad else sf


def _k_major(x: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor):
    """TN operand x [total_k, dim] -> k-major [dim, ldk] with group g at
    column ``pstarts[g]`` (16-element aligned) and zeros elsewhere, for the
    bf16 kernel, in plain PyTorch on the device. Returns (k-major tensor,
    pstarts, ldk)."""
    total_k = x.shape[0]
    ldk = align(total_k, _COL_ALIGN) + _COL_ALIGN * (sizes.numel() + (total_k == 0))
    src, pstarts = _k_major_columns(starts, sizes, total_k, _COL_ALIGN, ldk)
    return k_major_relayout_plain(x, src), pstarts, ldk


def tn_relayout(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor, nsf: int,
                use_psum_layout: bool = False):
    """The FP8 kernel's operands from the TN ones: a [total_k, m] and b
    [total_k, n] e4m3 as k-major [m, ldk] and [n, ldk], ldk = 128 x nsf (nsf
    the scale rows, one per 128-deep block of each group), group g at column
    128 x sf_start[g] with zeros past its depth, by :func:`common.k_major_relayout`.
    Returns (a_km, b_km, depths, first scale rows, ldk), the per-group
    values int32 on the device."""
    starts, sizes, sf_starts = compute_k_group_metadata(grouped_layout, use_psum_layout)
    ldk = _GRAN_K * max(nsf, 1)
    src = _k_major_columns(starts, sizes, a.shape[0], _GRAN_K, ldk)[0]
    return (k_major_relayout(a, src, 'k_grouped'), k_major_relayout(b, src, 'k_grouped'),
            sizes.int().contiguous(), sf_starts.int().contiguous(), ldk)


def k_grouped_gemm_plain(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor,
                         c: Optional[torch.Tensor] = None,
                         sfa: Optional[torch.Tensor] = None,
                         sfb: Optional[torch.Tensor] = None,
                         use_psum_layout: bool = False,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per group, the f32 sum from
    ``c[g]`` (or zero) of each 128-deep block's product, scaled as
    ``(p * sfb[row]) * sfa[row]`` for fp8. Reads the group sizes on the
    host (a sync), which the kernel never does."""
    total_k, m = a.shape
    n = b.shape[1]
    num_groups = grouped_layout.numel()
    starts, sizes, sf_starts = (t.tolist() for t in compute_k_group_metadata(
        grouped_layout, use_psum_layout))
    d = torch.empty((num_groups, m, n), dtype=out_dtype, device=a.device)
    for g in range(num_groups):
        acc = (c[g].float().clone() if c is not None
               else torch.zeros((m, n), dtype=torch.float32, device=a.device))
        for j in range(ceil_div(sizes[g], _GRAN_K)):
            lo = starts[g] + j * _GRAN_K
            hi = starts[g] + min(sizes[g], (j + 1) * _GRAN_K)
            p = torch.matmul(a[lo:hi].float().t(), b[lo:hi].float())
            if sfa is not None:
                row = sf_starts[g] + j
                p = (p * sfb[row][None, :]) * sfa[row][:, None]
            acc += p
        d[g] = acc.to(out_dtype)
    return d


def k_grouped_gemm(a: torch.Tensor, b: torch.Tensor, grouped_layout: torch.Tensor,
                   c: Optional[torch.Tensor] = None, sfa: Optional[torch.Tensor] = None,
                   sfb: Optional[torch.Tensor] = None, use_psum_layout: bool = False,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """d[g] = c[g] + a[ks_g]^T @ b[ks_g], f32 accumulation, [G, m, n] in
    ``out_dtype`` (f32, the op's contract, or bf16: the same sum rounded
    once).

    ``a`` [total_k, m] and ``b`` [total_k, n] (MN-major, TN layout) are
    both bf16 or both e4m3 with per-channel f32 scales ``sfa``
    [nsf_total, m] and ``sfb`` [nsf_total, n], k-first and compacted per
    group (see :func:`compute_k_group_metadata`). ``grouped_layout`` [G]
    int32 lies on the operands' device; ``c`` [G, m, n] f32 or None (zero).
    An empty group gives c[g] (or zero). Rows of a and b outside every
    group are not read.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(f'output dtype {out_dtype}: f32 or bf16 only')
    if use_plain(a, b, grouped_layout, c, sfa, sfb):
        return k_grouped_gemm_plain(a, b, grouped_layout, c, sfa, sfb, use_psum_layout,
                                    out_dtype)
    total_k, m = a.shape
    n = b.shape[1]
    num_groups = grouped_layout.numel()
    is_fp8 = a.dtype == torch.float8_e4m3fn
    dtype = torch.float8_e4m3fn if is_fp8 else torch.bfloat16
    check_operand(a, 'a', dtype, (total_k, m))
    check_operand(b, 'b', dtype, (total_k, n))
    check_operand(grouped_layout, 'grouped_layout', torch.int32, (num_groups,))
    if c is not None:
        check_operand(c, 'c', torch.float32, (num_groups, m, n))
    if is_fp8:
        if sfa is None or sfb is None:
            raise ValueError('fp8 operands need sfa and sfb')
        nsf = sfa.shape[0]
        check_operand(sfa, 'sfa', torch.float32, (nsf, m))
        check_operand(sfb, 'sfb', torch.float32, (nsf, n))
    elif sfa is not None or sfb is not None:
        raise ValueError('scales go with e4m3 operands only')
    if min(num_groups, m, n) == 0 or n % 2:
        raise ValueError(f'the kernel takes non-empty outputs and even n; '
                         f'got G={num_groups}, m={m}, n={n}')
    d = torch.empty((num_groups, m, n), dtype=out_dtype, device=a.device)
    out_f32 = int(out_dtype == torch.float32)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    c_ptr = c.data_ptr() if c is not None else None
    if is_fp8:
        a_km, b_km, sizes, sf_starts, ldk = tn_relayout(a, b, grouped_layout, nsf,
                                                        use_psum_layout)
        cfg = get_sm90_config(m, n, num_groups, out_dtype.itemsize,
                              num_sms=get_num_sms(a.device), k_grouped=True)
        sfa4, sfb4 = _rows_of_4(sfa), _rows_of_4(sfb)
        code = _fp8_entry()(a_km.data_ptr(), b_km.data_ptr(), sfa4.data_ptr(), sfb4.data_ptr(),
                            c_ptr, sizes.data_ptr(), sf_starts.data_ptr(), d.data_ptr(),
                            num_groups, m, n, ldk, sfa4.shape[1], sfb4.shape[1], cfg.block_m,
                            cfg.num_stages, cfg.num_sms, out_f32, stream)
    else:
        starts, sizes, _ = compute_k_group_metadata(grouped_layout, use_psum_layout)
        a_km, pstarts, ldk = _k_major(a, starts, sizes)
        b_km = _k_major(b, starts, sizes)[0]
        pstarts, sizes = pstarts.int().contiguous(), sizes.int().contiguous()
        cfg = get_gemm_config(m, n, num_groups, num_sms=get_num_sms(a.device))
        code = _bf16_entry()(a_km.data_ptr(), b_km.data_ptr(), c_ptr, pstarts.data_ptr(),
                             sizes.data_ptr(), d.data_ptr(), num_groups, m, n, ldk, out_f32,
                             cfg.block_n, stream)
    build.check(build.load('k_grouped'), code, 'k_grouped_gemm')
    launches['fp8' if is_fp8 else 'bf16'] += 1
    return d


def unflatten_k_major(x: torch.Tensor, ks: Sequence[int], dim: int) -> torch.Tensor:
    """The flat NT operand (group g's k-major [dim, k_g] segment from element
    dim * sum(ks[:g])) as the TN operand [sum(ks), dim]: JAX's unflatten
    (deepgemm_tpu/ops/k_grouped.py:83-91), one copy."""
    flat = x.reshape(-1)
    segs, off = [], 0
    for kg in ks:
        segs.append(flat[off * dim:(off + kg) * dim].view(dim, kg).t())
        off += kg
    if not segs:
        return flat.new_empty((0, dim))
    if x.dtype == torch.float8_e4m3fn:
        return torch.cat([s.view(torch.uint8) for s in segs]).view(x.dtype)
    return torch.cat(segs)


def k_grouped_gemm_flat_plain(a: torch.Tensor, b: torch.Tensor, ks: Sequence[int], m: int,
                              n: int, c: Optional[torch.Tensor], sfa: torch.Tensor,
                              sfb: torch.Tensor,
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The flat kernel's function in plain PyTorch: the TN plain version on
    the unflattened operands."""
    sizes = torch.tensor(list(ks), dtype=torch.int32, device=a.device)
    return k_grouped_gemm_plain(unflatten_k_major(a, ks, m), unflatten_k_major(b, ks, n),
                                sizes, c, sfa, sfb, out_dtype=out_dtype)


def k_grouped_gemm_flat(a: torch.Tensor, b: torch.Tensor, ks: Sequence[int], m: int, n: int,
                        c: Optional[torch.Tensor], sfa: torch.Tensor, sfb: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """d[g] = c[g] + a_g @ b_g^T with a_g [m, k_g] and b_g [n, k_g] e4m3, each
    group's segment k-major and flattened one after another in ``a`` and
    ``b`` (any shape, m * sum(ks) and n * sum(ks) elements), per-channel f32
    scales k-first and compacted per group (``sfa`` [nsf_total, m], ``sfb``
    [nsf_total, n]); ``ks`` the host list of depths, each a multiple of 16
    on the card. Bitwise :func:`k_grouped_gemm` on the unflattened operands.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(f'output dtype {out_dtype}: f32 or bf16 only')
    if use_plain(a, b, c, sfa, sfb):
        return k_grouped_gemm_flat_plain(a, b, ks, m, n, c, sfa, sfb, out_dtype)
    ks = [int(kg) for kg in ks]
    num_groups, total_k = len(ks), sum(ks)
    bad = [kg for kg in ks if kg % _COL_ALIGN]
    if bad:
        raise ValueError(f'the flat k-grouped kernel reads each group in place through a '
                         f'tensor map whose row stride is whole 16 bytes: every depth must be '
                         f'a multiple of {_COL_ALIGN}, got {bad}')
    fp8 = torch.float8_e4m3fn
    check_operand(a, 'a', fp8, tuple(a.shape))
    check_operand(b, 'b', fp8, tuple(b.shape))
    if a.numel() != m * total_k or b.numel() != n * total_k:
        raise ValueError(f'a and b hold {a.numel()} and {b.numel()} elements, expected '
                         f'm * sum(ks) = {m * total_k} and n * sum(ks) = {n * total_k}')
    nsf = sum(ceil_div(kg, _GRAN_K) for kg in ks)
    check_operand(sfa, 'sfa', torch.float32, (nsf, m))
    check_operand(sfb, 'sfb', torch.float32, (nsf, n))
    if c is not None:
        check_operand(c, 'c', torch.float32, (num_groups, m, n))
    if min(num_groups, m, n) == 0 or n % 2:
        raise ValueError(f'the kernel takes non-empty outputs and even n; '
                         f'got G={num_groups}, m={m}, n={n}')
    sf_rows = [ceil_div(kg, _GRAN_K) for kg in ks]
    meta = torch.tensor([ks, [sum(sf_rows[:g]) for g in range(num_groups)]], dtype=torch.int32)
    sizes, sf_starts = (t.contiguous() for t in meta.to(a.device).unbind(0))
    cfg = get_sm90_config(m, n, num_groups, out_dtype.itemsize, num_sms=get_num_sms(a.device),
                          k_grouped=True)
    d = torch.empty((num_groups, m, n), dtype=out_dtype, device=a.device)
    maps = torch.empty(2 * num_groups * _MAP_BYTES, dtype=torch.uint8, device=a.device)
    host_ks = (ctypes.c_int * num_groups)(*ks)
    sfa4, sfb4 = _rows_of_4(sfa), _rows_of_4(sfb)
    code = _flat_entry()(a.data_ptr(), b.data_ptr(), sfa4.data_ptr(), sfb4.data_ptr(),
                         c.data_ptr() if c is not None else None, host_ks, sizes.data_ptr(),
                         sf_starts.data_ptr(), maps.data_ptr(), d.data_ptr(), num_groups, m, n,
                         sfa4.shape[1], sfb4.shape[1], cfg.block_m, cfg.num_stages, cfg.num_sms,
                         int(out_dtype == torch.float32),
                         torch.cuda.current_stream(a.device).cuda_stream)
    build.check(build.load('k_grouped'), code, 'k_grouped_gemm_flat')
    global flat_launches
    flat_launches += 1
    return d
