"""M-grouped GEMM public API (counterpart of deepgemm_tpu/ops/m_grouped.py):
the contiguous layout (NT: B [G, n, k]; NN: B [G, k, n]) and the masked
layout (NT).

Contiguous: ``a`` is [m, k] k-major, the concatenation of per-group row
blocks, each starting on a multiple of the mk alignment (128 unless
``set_mk_alignment_for_contiguous_layout`` says otherwise);
``grouped_layout`` is per-row group ids with -1 padding, or per-group end
rows with ``use_psum_layout``. It stays on the device: the kernel's tile
lookup never reads it on the host.

Masked: ``a``/``d`` are [G, max_m, .]; only rows < masked_m[g] are
meaningful, and ``masked_m`` is never read on the host (CUDA-graph safe
decode).

Scales are f32 or packed UE8M0 (int32, 4 exponents a word along k): SFA
``[m, ksf]``, SFB ``[G, nsf, ksf]`` for a k-major B and ``[G, ksf, nsf]`` for
an MN-major one (packed: k packed along the leading SF dim,
deepgemm_tpu/ops/m_grouped.py:73-91). The kernels read B's block scales
``[G, nsf, ksf]`` as they are, so the JAX package's ``_grouped_sfb_t`` (a
per-n expansion) has no counterpart here. Packed FP4 (int8) operands raise
on both devices: the JAX package's m-grouped ops hand the codes to their
kernels without a fold (deepgemm_tpu/ops/m_grouped.py:166-190), so its
answer is undefined there.
"""

import torch

from .. import envs
from ..kernels.grouped import contiguous_dual_gemm, contiguous_gemm, masked_gemm
from .gemm import _out_dtype_of, _split_pair
from .sf_layout import resolve_recipes, transform_sfa, transform_sfb


def _refuse_packed_fp4(*values: torch.Tensor):
    if any(v.dtype == torch.int8 for v in values):
        raise TypeError('packed FP4 (int8) operands are refused by the m-grouped ops: the JAX '
                        'package computes on the raw e2m1 codes there, so its answer is undefined')


def _contiguous_impl(a, b, d, grouped_layout, b_kmajor, recipe, recipe_a, recipe_b,
                     use_psum_layout, ensure_zero_padding) -> torch.Tensor:
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    _refuse_packed_fp4(a_val, b_val)
    m, k = a_val.shape
    num_groups = b_val.shape[0]
    n = b_val.shape[1] if b_kmajor else b_val.shape[2]
    _out_dtype_of(d)
    if b_kmajor and envs.grouped_dual_b() and m % 256 == 0 and not ensure_zero_padding:
        gemm, kw = contiguous_dual_gemm, dict(use_psum_layout=use_psum_layout)
    else:
        gemm = contiguous_gemm
        kw = dict(use_psum_layout=use_psum_layout, ensure_zero_padding=ensure_zero_padding,
                  b_mn=not b_kmajor)
    if sfa is None:
        return gemm(a_val, b_val, grouped_layout, **kw)

    recipe_a, recipe_b = resolve_recipes(recipe, recipe_a, recipe_b)
    if recipe_a[1] != 128 or recipe_b[1] != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {recipe_a}, {recipe_b})')
    sfa = transform_sfa(sfa, m, k, recipe_a[1])
    sfb = transform_sfb(sfb, n, k, recipe_b, b_kmajor, num_groups)
    return gemm(a_val, b_val, grouped_layout, sfa=sfa, sfb=sfb, gran_n=recipe_b[0], **kw)


def m_grouped_fp8_fp4_gemm_nt_contiguous(a, b, d=None, grouped_layout=None, recipe=None,
                                         recipe_a=None, recipe_b=None, compiled_dims='nk',
                                         disable_ue8m0_cast=False, use_psum_layout=False,
                                         ensure_zero_padding=False) -> torch.Tensor:
    """Contiguous grouped NT GEMM of (e4m3, scale) pairs, or of bare bf16
    tensors: d[m, n] bf16 = a[m, k] @ b[group(m)][n, k]^T. With
    ``ensure_zero_padding`` the rows past their group's end are zero.

    ``DGT_GROUPED_DUAL_B=1`` runs the kernel's dual-B form (the same bits)
    where the shapes allow it, as JAX pins its own: m % 256 == 0 and no zero
    padding. The layout itself is never read on the host."""
    del compiled_dims, disable_ue8m0_cast
    return _contiguous_impl(a, b, d, grouped_layout, True, recipe, recipe_a, recipe_b,
                            use_psum_layout, ensure_zero_padding)


def m_grouped_fp8_fp4_gemm_nn_contiguous(a, b, d=None, grouped_layout=None, recipe=None,
                                         recipe_a=None, recipe_b=None, compiled_dims='nk',
                                         disable_ue8m0_cast=False, use_psum_layout=False,
                                         ensure_zero_padding=False) -> torch.Tensor:
    """The NN form: d[m, n] bf16 = a[m, k] @ b[group(m)][k, n], B MN-major
    [G, k, n] with SFB [G, ksf, nsf]; bitwise the NT form on
    ``b.transpose(1, 2)`` on the card (the kernel transposes each stage in
    shared memory)."""
    del compiled_dims, disable_ue8m0_cast
    return _contiguous_impl(a, b, d, grouped_layout, False, recipe, recipe_a, recipe_b,
                            use_psum_layout, ensure_zero_padding)


def m_grouped_bf16_gemm_nt_contiguous(a, b, d=None, grouped_layout=None, compiled_dims='nk',
                                      use_psum_layout=False, ensure_zero_padding=False
                                      ) -> torch.Tensor:
    return m_grouped_fp8_fp4_gemm_nt_contiguous(
        a, b, d, grouped_layout, compiled_dims=compiled_dims,
        use_psum_layout=use_psum_layout, ensure_zero_padding=ensure_zero_padding)


def m_grouped_bf16_gemm_nn_contiguous(a, b, d=None, grouped_layout=None, compiled_dims='nk',
                                      use_psum_layout=False, ensure_zero_padding=False
                                      ) -> torch.Tensor:
    return m_grouped_fp8_fp4_gemm_nn_contiguous(
        a, b, d, grouped_layout, compiled_dims=compiled_dims,
        use_psum_layout=use_psum_layout, ensure_zero_padding=ensure_zero_padding)


m_grouped_fp8_gemm_nt_contiguous = m_grouped_fp8_fp4_gemm_nt_contiguous
m_grouped_fp8_gemm_nn_contiguous = m_grouped_fp8_fp4_gemm_nn_contiguous


def m_grouped_fp8_fp4_gemm_nt_masked(a, b, d=None, masked_m=None, expected_m=None,
                                     recipe=None, recipe_a=None, recipe_b=None
                                     ) -> torch.Tensor:
    """Masked grouped NT GEMM of (e4m3, f32 scale) pairs, or of bare bf16
    tensors. ``expected_m`` is accepted for the API's sake: the port's tile
    chooser does not use it."""
    del expected_m
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    _refuse_packed_fp4(a_val, b_val)
    num_groups, _, k = a_val.shape
    n = b_val.shape[1]
    _out_dtype_of(d)
    if sfa is None:
        return masked_gemm(a_val, b_val, masked_m)

    recipe_a, recipe_b = resolve_recipes(recipe, recipe_a, recipe_b)
    if recipe_a[1] != 128 or recipe_b[1] != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {recipe_a}, {recipe_b})')
    sfa = transform_sfa(sfa.reshape(-1, sfa.shape[-1]), num_groups * a_val.shape[1], k, 128)
    sfb = transform_sfb(sfb, n, k, recipe_b, True, num_groups)
    return masked_gemm(a_val, b_val, masked_m, sfa=sfa.view(num_groups, a_val.shape[1], -1),
                       sfb=sfb, gran_n=recipe_b[0])


m_grouped_fp8_gemm_nt_masked = m_grouped_fp8_fp4_gemm_nt_masked


def m_grouped_bf16_gemm_nt_masked(a, b, d=None, masked_m=None, expected_m=None
                                  ) -> torch.Tensor:
    return m_grouped_fp8_fp4_gemm_nt_masked(a, b, d, masked_m, expected_m)
