"""Dense GEMM public API (counterpart of deepgemm_tpu/ops/gemm.py).

``fp8_fp4_gemm_{nt,nn,tn,tt}`` (and the ``fp8_gemm_*`` aliases) take
``(a, sfa)`` and ``(b, sfb)`` pairs and run the hand-written dense kernels
(kernels/dense.py); bare bf16 operands go to ``torch.matmul``, as the JAX
package leaves them to XLA's dot, and so do ``bf16_gemm_*`` and the
``cublaslt_gemm_*`` yardsticks. Layouts, as in JAX: nt a[m, k], b[n, k];
nn a[m, k], b[k, n]; tn a[k, m], b[k, n]; tt a[k, m], b[n, k]; each SF
follows its operand's orientation. ``c`` is added once to the finished f32
sum; ``d`` is only a template of the output dtype (bf16 or f32). Every
function returns its result.

Scales: f32 or packed UE8M0 (int32, 4 exponents a word along k), at a k
granularity of 128 for e4m3 operands. The strategy follows JAX's rule
(ops/gemm.py:208-218): 'dequant' where both operands' scales are powers of
two by type (packed UE8M0, or a folded FP4 operand), else 'promote';
``DGT_SCALE_STRATEGY`` (or ``runtime().force_scale_strategy``) pins it.

A packed FP4 operand (int8, two e2m1 codes a byte along k) is folded as JAX
folds it (deepgemm_tpu/ops/gemm.py:102-175). At a scale granularity of 128
its plain route decodes it to bf16 with the power-of-two scales folded in,
and on the card it runs the e4m3 kernels instead: the e2m1 values are exact
in e4m3 and the scales become one f32 per row and 128-deep k block (gran_n
1), which the promotion applies exactly, so it is the same function. At 32
or 64 the scales vary inside a promotion block: the operand is folded into
bf16 on both devices and runs as the bf16 operand of the mixed kernel forms.
A planar FP4 B (``fp4_layout``) is decoded inside the kernel
('planar_in_kernel'), folded first ('planar_fold'), or either as the arch
table's roofline decides ('planar').
"""

from typing import Optional, Tuple

import torch

from ..heuristics.arch import detect_arch, fp4_inkernel_profitable
from ..kernels.common import f32_products, use_plain
from ..kernels.dense import dense_gemm
from ..runtime.config import runtime
from ..utils.math import ceil_div, decode_fp4_rows, unpack_fp4_planar, unpack_ue8m0_from_int
from .sf_layout import resolve_recipes, transform_sfa, transform_sfb

FP4_LAYOUTS = ('interleaved', 'planar', 'planar_in_kernel', 'planar_fold')
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _split_pair(x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Accept either a bare tensor (bf16) or an (tensor, sf) pair (fp8)."""
    if isinstance(x, (tuple, list)):
        return x[0], x[1]
    return x, None


def _out_dtype_of(d, allowed=(torch.bfloat16,)) -> torch.dtype:
    """The output dtype a ``d`` template (tensor, dtype or None) asks for."""
    dtype = torch.bfloat16 if d is None else getattr(d, 'dtype', d)
    if dtype not in allowed:
        raise NotImplementedError(f'output dtype {dtype} is not ported (ported: {allowed})')
    return dtype


def _derive_fp4_gran(sf: torch.Tensor, k: int) -> int:
    """The FP4 scale granularity that an SF width implies at depth ``k``
    (deepgemm_tpu/ops/gemm.py:_derive_fp4_gran): raises where two
    candidates imply different scale counts (packed int32 SFs at small k)."""
    cands = (128, 64, 32, 16)
    if sf.dtype == torch.int32:         # packed UE8M0: 4 exponents an int32
        matches = [g for g in cands if ceil_div(ceil_div(k, g), 4) == sf.shape[-1]]
    else:
        matches = [g for g in cands if ceil_div(k, g) == sf.shape[-1]]
    if not matches:
        raise ValueError(f'cannot derive FP4 scale granularity from SF width '
                         f'{sf.shape[-1]} at k={k}; pass recipe/recipe_a/recipe_b')
    if len({ceil_div(k, g) for g in matches}) > 1:
        raise ValueError(f'FP4 scale granularity is ambiguous from packed SF width '
                         f'{sf.shape[-1]} at k={k} (candidates {matches}); pass '
                         f'recipe/recipe_a/recipe_b explicitly')
    return matches[0]


def _fold_fp4(v: torch.Tensor, sf: Optional[torch.Tensor], gran: Optional[int],
              to_e4m3: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A packed FP4 operand [rows, k/2] and its scales -> (values, f32
    scales [rows, ceil(k/128)] or None: unit scales). ``to_e4m3`` (the
    card, a granularity of 128): the e4m3 codes with their scales per
    128-deep block; else JAX's bf16 fold, the scales folded in."""
    rows, k = v.shape[0], 2 * v.shape[1]
    if not to_e4m3:
        return decode_fp4_rows(v, sf, gran or 128), None
    codes = decode_fp4_rows(v, None, 128).to(torch.float8_e4m3fn)     # e2m1 is exact in e4m3
    ksf = ceil_div(k, 128)
    if sf is None:
        return codes, torch.ones((rows, ksf), dtype=torch.float32, device=v.device)
    sf = unpack_ue8m0_from_int(sf) if sf.dtype == torch.int32 else sf.float()
    return codes, sf.repeat_interleave(gran // 128, dim=1)[:, :ksf].contiguous()


def _planar_to_interleaved(b: torch.Tensor) -> torch.Tensor:
    """Planar-128 FP4 codes -> the adjacent-pair packing (low nibble: even k)."""
    codes = unpack_fp4_planar(b)
    pairs = codes.reshape(*codes.shape[:-1], codes.shape[-1] // 2, 2)
    return ((pairs[..., 0] & 0x0F) | ((pairs[..., 1] & 0x0F) << 4)).to(torch.int8)


def _dot(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype, c=None) -> torch.Tensor:
    """a [m, k] @ b [k, n] with f32 accumulation (+ c), in ``out_dtype``:
    one ``torch.matmul`` (no hand kernel: JAX uses XLA's dot)."""
    if c is None and out_dtype == a.dtype == b.dtype == torch.bfloat16:
        return torch.matmul(a, b)
    with f32_products():
        r = torch.matmul(a.float(), b.float())
    if c is not None:
        r = r + c.float()
    return r.to(out_dtype)


def _gemm_impl(a, b, d, c, *, a_kmajor: bool, b_kmajor: bool, recipe=None, recipe_a=None,
               recipe_b=None, fp4_layout: str = 'interleaved') -> torch.Tensor:
    if fp4_layout not in FP4_LAYOUTS:
        raise ValueError(f'fp4_layout {fp4_layout!r}: one of {FP4_LAYOUTS}')
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    out_dtype = _out_dtype_of(d, _OUT_DTYPES)

    # planar FP4 B: decoded in the kernel, or folded first (ops/gemm.py:60-101)
    fp4_planar_b = (b_val.dtype == torch.int8 and fp4_layout.startswith('planar')
                    and b_kmajor and a_val.dtype != torch.int8)
    if fp4_planar_b:
        m = a_val.shape[0] if a_kmajor else a_val.shape[1]
        k = 2 * b_val.shape[1]
        if fp4_layout == 'planar':
            fp4_layout = ('planar_in_kernel'
                          if fp4_inkernel_profitable(detect_arch(), m, b_val.shape[0], k)
                          else 'planar_fold')
        if fp4_layout == 'planar_fold':
            b_val = _planar_to_interleaved(b_val)
        else:
            recipe_a, recipe_b = recipe_a or (1, 128), recipe_b or (1, 128)
            assert recipe_b[1] == 128, 'planar FP4 path uses (1, 128) B scales'
            if sfa is None:
                raise ValueError('planar FP4 B in the kernel takes an e4m3 A with its scales')
            n = b_val.shape[0]
            sfa = transform_sfa(sfa, m, k, recipe_a[1], a_kmajor)
            sfb = transform_sfb(sfb, n, k, recipe_b)
            if min(m, n, k) == 0:
                return _early(m, n, out_dtype, c, a_val.device)
            return dense_gemm(a_val, b_val, sfa, sfb, c=_c32(c), gran_n=recipe_b[0],
                              out_dtype=out_dtype, a_mn=not a_kmajor, fp4_b=True)

    # packed FP4 operands: folded (ops/gemm.py:102-175)
    folded_a, folded_b = a_val.dtype == torch.int8, b_val.dtype == torch.int8
    nosf = sfa is None and not folded_a
    if folded_a or folded_b:
        scaled = not nosf
        for folded, kmajor in ((folded_a, a_kmajor), (folded_b, b_kmajor)):
            assert not folded or kmajor, ('packed-FP4 operands must be k-major; repack T '
                                          'layouts with transpose_packed_fp4 first')
        card = not use_plain(a_val, b_val)

        def fold(v, sf, sub_recipe):
            gran = sub_recipe[1] if sub_recipe else (recipe[-1] if recipe else None)
            if sf is not None and gran is None:
                gran = _derive_fp4_gran(sf, 2 * v.shape[1])
            return _fold_fp4(v, sf, gran, to_e4m3=scaled and card and (gran or 128) % 128 == 0)

        if folded_a:
            a_val, sfa = fold(a_val, sfa, recipe_a)
        if folded_b:
            b_val, sfb = fold(b_val, sfb, recipe_b)
        recipe = None
        recipe_a = (1, 128) if folded_a else recipe_a or (1, 128)
        recipe_b = (1, 128) if folded_b else recipe_b or (128, 128)

    m = a_val.shape[0] if a_kmajor else a_val.shape[1]
    k = a_val.shape[1] if a_kmajor else a_val.shape[0]
    n = b_val.shape[0] if b_kmajor else b_val.shape[1]
    if k == 0 or m == 0 or n == 0:
        return _early(m, n, out_dtype, c, a_val.device)
    if nosf:
        # bf16 without scales: XLA's dot in JAX, one torch.matmul here
        return _dot(a_val if a_kmajor else a_val.t(), b_val.t() if b_kmajor else b_val,
                    out_dtype, c)

    recipe_a, recipe_b = resolve_recipes(recipe, recipe_a, recipe_b)
    scaled_a = a_val.dtype == torch.float8_e4m3fn
    scaled_b = b_val.dtype == torch.float8_e4m3fn
    for scaled_x, rec in ((scaled_a, recipe_a), (scaled_b, recipe_b)):
        if scaled_x and rec[1] != 128:
            raise NotImplementedError(f'fp8 scales at gran_k {rec[1]}: only 128 is ported')
    scales_pow2 = ((folded_a or sfa.dtype == torch.int32)
                   and (folded_b or sfb.dtype == torch.int32))
    strategy = runtime().force_scale_strategy or ('dequant' if scales_pow2 else 'promote')
    sfa = transform_sfa(sfa, m, k, 128, a_kmajor) if scaled_a else None
    sfb = transform_sfb(sfb, n, k, recipe_b, b_kmajor) if scaled_b else None
    a_mn, b_mn = not a_kmajor, not b_kmajor
    if not (scaled_a and scaled_b):
        # a bf16 (folded) operand: the mixed forms take k-major operands
        if a_mn:
            a_val, a_mn = a_val.t().contiguous(), False
        if b_mn:
            b_val, b_mn = b_val.t().contiguous(), False
    return dense_gemm(a_val, b_val, sfa, sfb, c=_c32(c), gran_n=recipe_b[0] if scaled_b else 128,
                      out_dtype=out_dtype, a_mn=a_mn, b_mn=b_mn, strategy=strategy)


def _c32(c: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if c is None else c.float().contiguous()


def _early(m, n, out_dtype, c, device) -> torch.Tensor:
    """An empty product: zeros, plus c (ops/gemm.py's early return)."""
    base = torch.zeros((m, n), dtype=out_dtype, device=device)
    return base + c.to(out_dtype) if c is not None else base


def fp8_fp4_gemm_nt(a, b, d=None, c=None, recipe=None, recipe_a=None, recipe_b=None,
                    compiled_dims='nk', disable_ue8m0_cast=False,
                    fp4_layout='interleaved') -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[n, k]^T (+ c) with block scales (fp8 or packed
    FP4 pairs) or plain (bf16 tensors). ``compiled_dims`` and
    ``disable_ue8m0_cast`` are accepted for the API's sake (f32 scales are
    used as they are, as JAX uses them)."""
    del compiled_dims, disable_ue8m0_cast
    return _gemm_impl(a, b, d, c, a_kmajor=True, b_kmajor=True, recipe=recipe,
                      recipe_a=recipe_a, recipe_b=recipe_b, fp4_layout=fp4_layout)


def fp8_fp4_gemm_nn(a, b, d=None, c=None, recipe=None, recipe_a=None, recipe_b=None,
                    compiled_dims='nk', disable_ue8m0_cast=False) -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[k, n] (+ c); SFB ``[ksf, nsf]``."""
    del compiled_dims, disable_ue8m0_cast
    return _gemm_impl(a, b, d, c, a_kmajor=True, b_kmajor=False, recipe=recipe,
                      recipe_a=recipe_a, recipe_b=recipe_b)


def fp8_fp4_gemm_tn(a, b, d=None, c=None, recipe=None, recipe_a=None, recipe_b=None,
                    compiled_dims='nk', disable_ue8m0_cast=False) -> torch.Tensor:
    """d[m, n] = a[k, m]^T @ b[k, n] (+ c); SFA ``[ksf, m]``, SFB ``[ksf, nsf]``."""
    del compiled_dims, disable_ue8m0_cast
    return _gemm_impl(a, b, d, c, a_kmajor=False, b_kmajor=False, recipe=recipe,
                      recipe_a=recipe_a, recipe_b=recipe_b)


def fp8_fp4_gemm_tt(a, b, d=None, c=None, recipe=None, recipe_a=None, recipe_b=None,
                    compiled_dims='nk', disable_ue8m0_cast=False) -> torch.Tensor:
    """d[m, n] = a[k, m]^T @ b[n, k]^T (+ c); SFA ``[ksf, m]``."""
    del compiled_dims, disable_ue8m0_cast
    return _gemm_impl(a, b, d, c, a_kmajor=False, b_kmajor=True, recipe=recipe,
                      recipe_a=recipe_a, recipe_b=recipe_b)


fp8_gemm_nt = fp8_fp4_gemm_nt
fp8_gemm_nn = fp8_fp4_gemm_nn
fp8_gemm_tn = fp8_fp4_gemm_tn
fp8_gemm_tt = fp8_fp4_gemm_tt


def fp8_gemm_nt_skip_head_mid(a, b, d=None, head_splits=None, c=None, recipe=None,
                              recipe_a=None, recipe_b=None, compiled_dims='nk',
                              disable_ue8m0_cast=False) -> torch.Tensor:
    """The NT GEMM whose per-head output columns are placed around a zero
    middle: [m, H * (left + right)] becomes [m, H * (left + mid + right)]
    (deepgemm_tpu/ops/gemm.py:323-347); ``c`` is the narrow [m, H (l + r)]
    accumulator, as JAX's. The dense kernel writes the narrow result, then
    each head's columns are copied into place."""
    del compiled_dims, disable_ue8m0_cast
    left, mid, right = head_splits
    narrow = fp8_fp4_gemm_nt(a, b, d, c, recipe, recipe_a, recipe_b)
    m, n = narrow.shape
    assert n % (left + right) == 0, (n, head_splits)
    heads = narrow.view(m, n // (left + right), left + right)
    out = narrow.new_zeros((m, heads.shape[1], left + mid + right))
    out[:, :, :left] = heads[:, :, :left]
    out[:, :, left + mid:] = heads[:, :, left:]
    return out.view(m, -1)


def bf16_gemm_nt(a, b, d=None, c=None, compiled_dims='nk') -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[n, k]^T (+ c) in bf16 or f32 with f32
    accumulation (``torch.matmul``; no hand kernel, as the JAX package uses
    XLA's dot)."""
    del compiled_dims
    return _dot(a, b.t(), _out_dtype_of(d, _OUT_DTYPES), c)


def bf16_gemm_nn(a, b, d=None, c=None, compiled_dims='nk') -> torch.Tensor:
    """d = a[m, k] @ b[k, n] (+ c), as :func:`bf16_gemm_nt`."""
    del compiled_dims
    return _dot(a, b, _out_dtype_of(d, _OUT_DTYPES), c)


def bf16_gemm_tn(a, b, d=None, c=None, compiled_dims='nk') -> torch.Tensor:
    """d = a[k, m]^T @ b[k, n] (+ c), as :func:`bf16_gemm_nt`."""
    del compiled_dims
    return _dot(a.t(), b, _out_dtype_of(d, _OUT_DTYPES), c)


def bf16_gemm_tt(a, b, d=None, c=None, compiled_dims='nk') -> torch.Tensor:
    """d = a[k, m]^T @ b[n, k]^T (+ c), as :func:`bf16_gemm_nt`."""
    del compiled_dims
    return _dot(a.t(), b.t(), _out_dtype_of(d, _OUT_DTYPES), c)


# The vendor yardstick (deepgemm_tpu/ops/gemm.py:284-320, the reference's
# cuBLASLt baseline): one torch.matmul each, cuBLAS on the card.

def cublaslt_gemm_nt(a, b, d=None, c=None) -> torch.Tensor:
    return _dot(a, b.t(), _out_dtype_of(d, _OUT_DTYPES), c)


def cublaslt_gemm_nn(a, b, d=None, c=None) -> torch.Tensor:
    return _dot(a, b, _out_dtype_of(d, _OUT_DTYPES), c)


def cublaslt_gemm_tn(a, b, d=None, c=None) -> torch.Tensor:
    return _dot(a.t(), b, _out_dtype_of(d, _OUT_DTYPES), c)


def cublaslt_gemm_tt(a, b, d=None, c=None) -> torch.Tensor:
    return _dot(a.t(), b.t(), _out_dtype_of(d, _OUT_DTYPES), c)


cublaslt_gemm = cublaslt_gemm_nt
