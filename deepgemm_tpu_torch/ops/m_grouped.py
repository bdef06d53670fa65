"""Masked m-grouped GEMM public API (counterpart of the masked half of
deepgemm_tpu/ops/m_grouped.py).

``a``/``d`` are [G, max_m, .]; only rows < masked_m[g] are meaningful, and
``masked_m`` is never read on the host (CUDA-graph safe decode). The
kernel reads B's block scales ``[G, nsf, ksf]`` as they are, so the JAX
package's ``_grouped_sfb_t`` (a per-n expansion) has no counterpart here.
The contiguous layouts are not ported yet.
"""

import torch

from ..kernels.grouped import masked_gemm
from .gemm import _out_dtype_of, _split_pair
from .sf_layout import _require_f32, resolve_recipes, transform_sfb


def m_grouped_fp8_fp4_gemm_nt_masked(a, b, d=None, masked_m=None, expected_m=None,
                                     recipe=None, recipe_a=None, recipe_b=None
                                     ) -> torch.Tensor:
    """Masked grouped NT GEMM of (e4m3, f32 scale) pairs, or of bare bf16
    tensors. ``expected_m`` is accepted for the API's sake: the port's tile
    chooser does not use it."""
    del expected_m
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    num_groups, _, k = a_val.shape
    n = b_val.shape[1]
    _out_dtype_of(d)
    if sfa is None:
        return masked_gemm(a_val, b_val, masked_m)

    recipe_a, recipe_b = resolve_recipes(recipe, recipe_a, recipe_b)
    if recipe_a[1] != 128 or recipe_b[1] != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {recipe_a}, {recipe_b})')
    _require_f32(sfa, 'sfa')
    sfb = transform_sfb(sfb, n, k, recipe_b, num_groups)
    return masked_gemm(a_val, b_val, masked_m, sfa=sfa.contiguous(), sfb=sfb,
                       gran_n=recipe_b[0])


m_grouped_fp8_gemm_nt_masked = m_grouped_fp8_fp4_gemm_nt_masked


def m_grouped_bf16_gemm_nt_masked(a, b, d=None, masked_m=None, expected_m=None
                                  ) -> torch.Tensor:
    return m_grouped_fp8_fp4_gemm_nt_masked(a, b, d, masked_m, expected_m)
