"""Dense GEMM public API (counterpart of deepgemm_tpu/ops/gemm.py), NT layout.

``fp8_gemm_nt`` takes ``(a, sfa)`` and ``(b, sfb)`` pairs of e4m3 operands
and f32 scales and runs the hand-written dense kernel with the exact f32
promotion, into bf16 or (with an f32 ``d`` template, as the FP8 wgrad asks)
f32. Bare bf16 operands go to ``torch.matmul``, as the JAX package leaves
them to XLA. Every function returns its result; ``d`` is only a dtype
template. Still to be ported: the NN/TN/TT layouts, C accumulation,
packed-UE8M0 scales (the 'dequant' strategy) and FP4 operands.
"""

from typing import Optional, Tuple

import torch

from ..kernels.dense import dense_fp8_gemm_nt
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


def fp8_fp4_gemm_nt(a, b, d=None, c=None, recipe=None, recipe_a=None,
                    recipe_b=None) -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[n, k]^T with block scales (fp8 pairs) or plain
    (bf16 tensors)."""
    if c is not None:
        raise NotImplementedError('C accumulation is not ported yet')
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
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


def bf16_gemm_nt(a: torch.Tensor, b: torch.Tensor, d=None) -> torch.Tensor:
    """d[m, n] = a[m, k] @ b[n, k]^T in bf16 with f32 accumulation
    (``torch.matmul``; no hand kernel, as the JAX package uses XLA's dot)."""
    return torch.matmul(a, b.t()).to(_out_dtype_of(d))
