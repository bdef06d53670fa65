"""Dense GEMM with block scales, every form the JAX package's dense kernel
takes: the wrapper of the CUDA kernels, their plain PyTorch version and
their launch counts.

Replaces: deepgemm_tpu/kernels/dense.py:_build_dense_gemm (``pl.pallas_call``
at dense.py:291), with kernels/common.py:promote_block:
  * the NT, NN, TN and TT layouts (A [m, k] or [k, m], B [n, k] or [k, n]);
  * C accumulation: c added once to the finished f32 sum (dense.py:267-276);
  * the 'promote' strategy (the exact f32 promotion per 128-deep k block)
    and the 'dequant' strategy (dense.py:248-255: power-of-two scales
    folded into bf16 operands, one full-depth f32 sum);
  * planar FP4 B decoded inside the kernel (decode_fp4_planar_block,
    dense.py:142-163), 'promote' with B's (1, 128) scales;
  * a bf16 operand beside an e4m3 one (a packed FP4 operand at a scale
    granularity of 32 or 64, folded into bf16 by the op layer, as JAX folds
    it), or two of them;
  * a bf16 or an f32 output.
Kernels, both on the Hopper mainloop of csrc/gemm_sm90.cuh (wgmma + TMA,
warp-specialised, persistent): csrc/dense.cu (e4m3 under 'promote', planar
FP4 B) and csrc/dense_dequant.cu (the forms on bf16 products: 'dequant', the
bf16 operands).
Bound on the H100: a 4096^3 product does 2*4096^3 operations on 32 MiB of
fp8 input, ~2000 operations a byte, so the fp8 tensor-core rate bounds it
(the forms on bf16 products: the bf16 rate); at m = 128 the weights' bytes
weigh as much. The kernels stream 128-deep k blocks by TMA into wgmma: the
e4m3 'promote' kernel promotes each block's f32 partial with its scales in
registers; the bf16-product kernel widens an e4m3 A into wgmma's register
operand and an e4m3 B into a bf16 tile in shared memory, each times its
scale under 'dequant'. An MN-major e4m3 operand is a k-major copy made here
(wgmma reads e4m3 k-major only), so every layout is bitwise the NT kernel on
transposed copies; the scales go k-first (a row per block, copied in bulk a
stage; the C entries lay them out in a pre-pass).
"""

import ctypes
from typing import Optional

import torch

from ..heuristics.configs import get_sm90_config
from ..runtime import build
from ..runtime.config import get_num_sms
from ..utils.math import _dequantize_from_fp4_e2m1, align, ceil_div, unpack_fp4_planar
from .common import (check_operand, f32_products, k_major_relayout, promote_block, sfb_shift,
                     use_plain)

# Kernel launches since the counts were last set to 0: all forms, and per
# form (see :func:`form_of`).
launches = 0
form_launches = {}

STRATEGIES = ('promote', 'dequant')
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_E4M3 = torch.float8_e4m3fn


def _fp8_entry():
    fn = build.load('dense').dgt_dense_fp8_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bf16_mma_entry():
    fn = build.load('dense_dequant').dgt_dense_gemm_bf16_mma
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def form_of(a: torch.Tensor, b: torch.Tensor, a_mn: bool = False, b_mn: bool = False,
            strategy: str = 'promote', fp4_b: bool = False, c=None) -> str:
    """The name a launch is counted under: the scale step ('bf16' for two
    bf16 operands), the layout (nt, nn, tn, tt: A k-major or not, then B),
    'fp4' for planar FP4 B, 'mixed' for one bf16 operand, '+c' with c."""
    layout = ('t' if a_mn else 'n') + ('n' if b_mn else 't')
    bf16 = (a.dtype == torch.bfloat16) + (b.dtype == torch.bfloat16)
    name = f'bf16_{layout}' if bf16 == 2 else f'{strategy}_{layout}'
    if fp4_b:
        name += '_fp4'
    elif bf16 == 1:
        name += '_mixed'
    return name + ('+c' if c is not None else '')


def _k_major(x: torch.Tensor, mn: bool) -> torch.Tensor:
    return x.t().contiguous() if mn else x


def _k_major_e4m3(x: torch.Tensor, mn: bool) -> torch.Tensor:
    """An MN-major e4m3 operand [k, rows] as a k-major copy [rows, k] (the
    transposing gather of csrc/relayout.cuh with the identity for its source
    rows: each byte read once and written once; counted as
    common.relayout_launches['dense']); a k-major one as it is."""
    if not mn:
        return x
    return k_major_relayout(x, torch.arange(x.shape[0], dtype=torch.int32, device=x.device),
                            'dense')


def _decode_planar(b: torch.Tensor) -> torch.Tensor:
    """Planar FP4 B [n, k/2] -> its e4m3 codes [n, k] (e2m1 is exact in e4m3)."""
    return _dequantize_from_fp4_e2m1(unpack_fp4_planar(b)).to(_E4M3)


def _expand_sf(sf: torch.Tensor, gran_rows: int, rows: int, k: int) -> torch.Tensor:
    """[ceil(rows/gran_rows), ceil(k/128)] scales -> one per element [rows, k]."""
    return sf.repeat_interleave(gran_rows, dim=0)[:rows].repeat_interleave(128, dim=1)[:, :k]


def dense_gemm_plain(a: torch.Tensor, b: torch.Tensor, sfa: Optional[torch.Tensor] = None,
                     sfb: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None,
                     gran_n: int = 128, out_dtype: torch.dtype = torch.bfloat16,
                     a_mn: bool = False, b_mn: bool = False, strategy: str = 'promote',
                     fp4_b: bool = False) -> torch.Tensor:
    """The kernels' function in plain PyTorch (see :func:`dense_gemm`):
    'promote' is :func:`promote_block` (a bf16 operand's unit scale not
    multiplied); 'dequant' widens each e4m3 operand to bf16 times its scale
    rounded to bf16, then one f32 product over the whole depth; c is added
    to the f32 sum before the output's rounding."""
    a_k, b_k = _k_major(a, a_mn), _k_major(b, b_mn)
    if fp4_b:
        b_k = _decode_planar(b_k)
    m, k = a_k.shape
    n = b_k.shape[0]
    with f32_products():
        if a_k.dtype == b_k.dtype == torch.bfloat16:
            total = torch.matmul(a_k.float(), b_k.float().t())
        elif strategy == 'promote':
            total = promote_block(a_k, b_k, sfa, sfb, gran_n)
        else:
            a_s = a_k if sfa is None else (
                a_k.to(torch.bfloat16) * _expand_sf(sfa, 1, m, k).to(torch.bfloat16))
            b_s = b_k if sfb is None else (
                b_k.to(torch.bfloat16) * _expand_sf(sfb, gran_n, n, k).to(torch.bfloat16))
            total = torch.matmul(a_s.float(), b_s.float().t())
    if c is not None:
        total = total + c.float()
    return total.to(out_dtype)


def dense_fp8_gemm_nt_plain(a: torch.Tensor, b: torch.Tensor, sfa: torch.Tensor,
                            sfb: torch.Tensor, gran_n: int = 128,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`dense_gemm_plain` of the NT e4m3 form under 'promote'."""
    return promote_block(a, b, sfa, sfb, gran_n).to(out_dtype)


def dense_gemm(a: torch.Tensor, b: torch.Tensor, sfa: Optional[torch.Tensor] = None,
               sfb: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None,
               gran_n: int = 128, out_dtype: torch.dtype = torch.bfloat16,
               a_mn: bool = False, b_mn: bool = False, strategy: str = 'promote',
               fp4_b: bool = False) -> torch.Tensor:
    """d[m, n] = a @ b^T (+ c) in ``out_dtype`` (bf16 or f32).

    ``a`` is [m, k] (``a_mn``: [k, m]) and ``b`` [n, k] (``b_mn``: [k, n];
    ``fp4_b``: planar FP4 int8 [n, k/2], k % 256 == 0), each e4m3 with f32
    scales (``sfa`` [m, ceil(k/128)], ``sfb`` [ceil(n/gran_n), ceil(k/128)])
    or bf16 with none (a folded FP4 operand: unit scales). ``strategy``
    'promote' or 'dequant' (see the module notes); two bf16 operands are
    unscaled. ``c`` [m, n] f32 or None. An MN-major operand is e4m3 and its
    rows are whole 16-byte chunks (m or n % 16 == 0).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(f'output dtype {out_dtype}: bf16 or f32 only')
    if strategy not in STRATEGIES:
        raise ValueError(f'strategy {strategy!r}: one of {STRATEGIES}')
    if use_plain(a, b, sfa, sfb, c):
        return dense_gemm_plain(a, b, sfa, sfb, c, gran_n, out_dtype, a_mn, b_mn, strategy, fp4_b)
    a_bf16, b_bf16 = a.dtype == torch.bfloat16, b.dtype == torch.bfloat16
    if fp4_b:
        b_dtype, elem_b = torch.int8, 1
        if a_mn or b_mn or a_bf16 or strategy != 'promote':
            raise ValueError('planar FP4 B takes k-major e4m3 A under promote')
    else:
        b_dtype, elem_b = (torch.bfloat16, 2) if b_bf16 else (_E4M3, 1)
    a_dtype, elem_a = (torch.bfloat16, 2) if a_bf16 else (_E4M3, 1)
    if (a_bf16 or b_bf16) and (a_mn or b_mn):
        raise ValueError('a bf16 operand takes k-major operands only')
    m, k = (a.shape[1], a.shape[0]) if a_mn else tuple(a.shape)
    n = b.shape[1] if b_mn else b.shape[0]
    ksf = ceil_div(k, 128)
    check_operand(a, 'a', a_dtype, (k, m) if a_mn else (m, k))
    b_shape = (k, n) if b_mn else (n, k // 2) if fp4_b else (n, k)
    check_operand(b, 'b', b_dtype, b_shape)
    if a_bf16 != (sfa is None) or b_bf16 != (sfb is None):
        raise ValueError('an e4m3 operand takes f32 scales, a bf16 operand none')
    if sfa is not None:
        check_operand(sfa, 'sfa', torch.float32, (m, ksf))
    if sfb is not None:
        check_operand(sfb, 'sfb', torch.float32, (ceil_div(n, gran_n), ksf))
    if c is not None:
        check_operand(c, 'c', torch.float32, (m, n))
    if min(m, n, k) == 0 or k % 16 or n % 2:
        raise ValueError(f'the kernel takes non-empty shapes, k % 16 == 0 and '
                         f'even n; got m={m}, n={n}, k={k}')
    if (a_mn and m * elem_a % 16) or (b_mn and n * elem_b % 16):
        raise ValueError(f'an MN-major operand\'s rows must be whole 16-byte chunks; '
                         f'got m={m}, n={n}')
    if fp4_b and k % 256:
        raise ValueError(f'planar FP4 B takes k % 256 == 0 (a packed group is 256 codes); '
                         f'got k={k}')
    shift = sfb_shift(gran_n)
    d = torch.empty((m, n), dtype=out_dtype, device=a.device)
    out_f32 = int(out_dtype == torch.float32)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    num_sms = get_num_sms(a.device)
    a_k, b_k = _k_major_e4m3(a, a_mn), _k_major_e4m3(b, b_mn)
    # the scales' k-first copies, which the entries write in a pre-pass
    sfa_ld = 0 if sfa is None else align(m, 4)
    sfb_ld = 0 if sfb is None else align(sfb.shape[0], 4)
    scratch = torch.empty(ksf * (sfa_ld + sfb_ld), dtype=torch.float32, device=a.device)
    ptrs = (a_k.data_ptr(), b_k.data_ptr(), None if sfa is None else sfa.data_ptr(),
            None if sfb is None else sfb.data_ptr(), scratch.data_ptr(),
            None if c is None else c.data_ptr(), d.data_ptr())
    if not (a_bf16 or b_bf16) and strategy == 'promote':
        lib = 'dense'
        cfg = get_sm90_config(m, n, 1, out_dtype.itemsize, num_sms=num_sms)
        code = _fp8_entry()(*ptrs, m, n, k, sfa_ld, sfb_ld, shift, cfg.block_m, cfg.num_stages,
                            cfg.num_sms, out_f32, int(fp4_b), stream)
    else:
        lib = 'dense_dequant'
        # two bf16 operands: the dense kernel's unscaled form; else widened
        kind = dict(elem=2) if a_bf16 and b_bf16 else dict(widen=(elem_a, elem_b))
        cfg = get_sm90_config(m, n, 1, out_dtype.itemsize, num_sms=num_sms, **kind)
        code = _bf16_mma_entry()(*ptrs, m, n, k, sfa_ld, sfb_ld, shift, cfg.block_m,
                                 cfg.block_n, cfg.num_stages, cfg.num_sms, out_f32, int(a_bf16),
                                 int(b_bf16), int(strategy == 'dequant'), stream)
    build.check(build.load(lib), code, 'dense_gemm')
    global launches
    launches += 1
    form = form_of(a, b, a_mn, b_mn, strategy, fp4_b, c)
    form_launches[form] = form_launches.get(form, 0) + 1
    return d


def dense_fp8_gemm_nt(a: torch.Tensor, b: torch.Tensor, sfa: torch.Tensor,
                      sfb: torch.Tensor, gran_n: int = 128,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`dense_gemm` of the NT e4m3 form under 'promote': a [m, k] and
    b [n, k] e4m3, sfa [m, ceil(k/128)], sfb [ceil(n/gran_n), ceil(k/128)]."""
    return dense_gemm(a, b, sfa, sfb, gran_n=gran_n, out_dtype=out_dtype)
