"""Dense GEMM public API (counterpart of deepgemm_tpu/ops/gemm.py), NT layout.

``fp8_gemm_nt`` takes ``(a, sfa)`` and ``(b, sfb)`` pairs of e4m3 operands
and f32 scales and runs the hand-written dense kernel with the exact f32
promotion, into bf16 or (with an f32 ``d`` template, as the FP8 wgrad asks)
f32. Bare bf16 operands go to ``torch.matmul``, as the JAX package leaves
them to XLA. Every function returns its result; ``d`` is only a dtype
template.

A packed FP4 operand (int8, two e2m1 codes a byte along k, with UE8M0
scales) is folded as JAX folds it (deepgemm_tpu/ops/gemm.py:102-175): its
plain route decodes it to bf16 with the power-of-two scales folded in. On
the card it runs the e4m3 dense kernel instead: the e2m1 values are exact in
e4m3 and the scales become one f32 per row and 128-deep k block (gran_n 1),
which the promotion applies exactly, so it is the same function. A scale
granularity finer than 128 varies inside one promotion block: it raises on
both devices.

Still to be ported: the NN/TN/TT layouts, C accumulation, packed-UE8M0
scales of fp8 operands (the 'dequant' strategy) and the planar FP4 layout.
"""

from typing import Optional, Tuple

import torch

from ..kernels.common import use_plain
from ..kernels.dense import dense_fp8_gemm_nt
from ..utils.math import ceil_div, decode_fp4_rows, unpack_ue8m0_from_int
from .sf_layout import resolve_recipes, transform_sfa, transform_sfb


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


def _fold_fp4(v: torch.Tensor, sf: Optional[torch.Tensor], sub_recipe, scaled: bool,
              to_e4m3: bool):
    """A packed FP4 operand [rows, k/2] and its scales -> (values, f32
    scales [rows, ceil(k/128)] or None). ``to_e4m3``: e4m3 codes and the
    scales per 128-deep block (the kernel's route); else JAX's bf16 fold
    with unit scales (None where the product is unscaled bf16)."""
    rows, k = v.shape[0], 2 * v.shape[1]
    ksf = ceil_div(k, 128)
    gran = None
    if sf is not None:
        gran = sub_recipe[-1] if sub_recipe else _derive_fp4_gran(sf, k)
        if scaled and gran % 128:
            raise NotImplementedError(
                f'FP4 scale granularity {gran} varies inside a 128-deep promotion block; '
                f'only multiples of 128 are ported')
    if not to_e4m3:
        ones = torch.ones((rows, ksf), dtype=torch.float32, device=v.device)
        return decode_fp4_rows(v, sf, gran), ones if scaled else None
    codes = decode_fp4_rows(v, None, gran).to(torch.float8_e4m3fn)     # e2m1 is exact in e4m3
    if sf is None:
        return codes, torch.ones((rows, ksf), dtype=torch.float32, device=v.device)
    sf = unpack_ue8m0_from_int(sf) if sf.dtype == torch.int32 else sf.float()
    return codes, sf.repeat_interleave(gran // 128, dim=1)[:, :ksf].contiguous()


def fp8_fp4_gemm_nt(a, b, d=None, c=None, recipe=None, recipe_a=None,
                    recipe_b=None) -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[n, k]^T with block scales (fp8 or packed FP4
    pairs) or plain (bf16 tensors)."""
    if c is not None:
        raise NotImplementedError('C accumulation is not ported yet')
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    fp4_a, fp4_b = a_val.dtype == torch.int8, b_val.dtype == torch.int8
    if fp4_a or fp4_b:
        scaled = sfa is not None or fp4_a
        to_e4m3 = scaled and not use_plain(a_val, b_val)
        if fp4_a:
            a_val, sfa = _fold_fp4(a_val, sfa, recipe_a or recipe, scaled, to_e4m3)
        if fp4_b:
            b_val, sfb = _fold_fp4(b_val, sfb, recipe_b or recipe, scaled, to_e4m3)
        recipe = None
        recipe_a = (1, 128) if fp4_a else recipe_a or (1, 128)
        recipe_b = (1, 128) if fp4_b else recipe_b or (128, 128)
    m, k = a_val.shape
    n = b_val.shape[0]
    out_dtype = _out_dtype_of(d, (torch.bfloat16, torch.float32))
    if k == 0 or m == 0 or n == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a_val.device)
    if sfa is None:
        return bf16_gemm_nt(a_val, b_val, out_dtype)

    recipe_a, recipe_b = resolve_recipes(recipe, recipe_a, recipe_b)
    if recipe_a[1] != 128 or recipe_b[1] != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {recipe_a}, {recipe_b})')
    sfa = transform_sfa(sfa, m, k, recipe_a[1])
    sfb = transform_sfb(sfb, n, k, recipe_b)
    return dense_fp8_gemm_nt(a_val, b_val, sfa, sfb, gran_n=recipe_b[0], out_dtype=out_dtype)


fp8_gemm_nt = fp8_fp4_gemm_nt


def fp8_gemm_nt_skip_head_mid(a, b, d=None, head_splits=None, c=None, recipe=None,
                              recipe_a=None, recipe_b=None, compiled_dims='nk',
                              disable_ue8m0_cast=False) -> torch.Tensor:
    """The NT GEMM whose per-head output columns are placed around a zero
    middle: [m, H * (left + right)] becomes [m, H * (left + mid + right)]
    (deepgemm_tpu/ops/gemm.py:323-347). The dense kernel writes the narrow
    result, then each head's columns are copied into place."""
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


def bf16_gemm_nt(a: torch.Tensor, b: torch.Tensor, d=None) -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[n, k]^T in bf16 with f32 accumulation
    (``torch.matmul``; no hand kernel, as the JAX package uses XLA's dot)."""
    return torch.matmul(a, b.t()).to(_out_dtype_of(d))
