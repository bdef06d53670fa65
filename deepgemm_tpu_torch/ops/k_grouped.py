"""K-grouped GEMM public API, the MoE weight gradient (counterpart of
deepgemm_tpu/ops/k_grouped.py), TN layout.

``a`` [total_k, m] and ``b`` [total_k, n] (MN-major); the output is
``[G, m, n]`` float32, ``d[g] = c[g] + a_g^T @ b_g`` with FP32 accumulation
from ``c`` (zero when ``c`` is None). ``d`` is only a dtype template: f32
by default, bf16 on request, which rounds the same f32 sum once (what the
FP8 autograd wants, without a [G, m, n] f32 tensor).

The NT form ``k_grouped_fp8_gemm_nt_contiguous`` takes each group's segments
k-major and flattened (a[m x k_g] one after another), with host ``ks``; its
kernel reads them in place (kernels/k_grouped.py).
"""

from typing import Optional, Sequence

import torch

from ..kernels.k_grouped import k_grouped_gemm, k_grouped_gemm_flat, unflatten_k_major
from ..utils.math import ceil_div
from .gemm import _out_dtype_of, _split_pair

def _layout_and_groups(a_val, ks, grouped_layout, c):
    """(grouped_layout on the operands' device, number of groups)."""
    if c is not None:
        num_groups = c.shape[0]
    else:
        num_groups = len(ks) if ks is not None else grouped_layout.shape[0]
    if grouped_layout is None:
        assert ks is not None, 'pass ks or grouped_layout'
        grouped_layout = torch.tensor(list(ks), dtype=torch.int32, device=a_val.device)
    return grouped_layout, num_groups


def _out_dtype(d) -> torch.dtype:
    return torch.float32 if d is None else _out_dtype_of(d, (torch.float32, torch.bfloat16))


def k_grouped_fp8_gemm_tn_contiguous(a, b, d=None, ks: Optional[Sequence[int]] = None,
                                     grouped_layout=None, c=None, recipe=(1, 1, 128),
                                     compiled_dims='mn', use_psum_layout=False
                                     ) -> torch.Tensor:
    """d[g] = c[g] + a_g^T @ b_g with per-channel (1 x gran_k) f32 scales on
    both operands, k-first and compacted per group: ``sfa`` [nsf_total, m],
    ``sfb`` [nsf_total, n]. ``ks`` (host list of group depths) or
    ``grouped_layout`` (device tensor: depths, or psum end rows with
    ``use_psum_layout``) gives the groups."""
    del compiled_dims
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    gran_k = recipe[2] if recipe is not None else 128
    if gran_k != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {gran_k})')
    grouped_layout, num_groups = _layout_and_groups(a_val, ks, grouped_layout, c)
    assert grouped_layout.numel() == num_groups, (grouped_layout.shape, num_groups)
    for sf, name in ((sfa, 'sfa'), (sfb, 'sfb')):
        if sf.dtype != torch.float32:
            raise NotImplementedError(f'{name}: only f32 scales are ported (got {sf.dtype})')
    if ks is not None:
        # Loud shape gate (deepgemm_tpu/ops/k_grouped.py:47-58): a
        # transposed SF would otherwise compute garbage silently.
        nsf_expect = sum(ceil_div(int(kg), gran_k) for kg in ks)
        m_dim, n_dim = a_val.shape[1], b_val.shape[1]
        assert tuple(sfa.shape) == (nsf_expect, m_dim), \
            f'sfa must be k-first [nsf_total={nsf_expect}, m={m_dim}], got {tuple(sfa.shape)}'
        assert tuple(sfb.shape) == (nsf_expect, n_dim), \
            f'sfb must be k-first [nsf_total={nsf_expect}, n={n_dim}], got {tuple(sfb.shape)}'
    return k_grouped_gemm(a_val, b_val, grouped_layout, c, sfa.contiguous(), sfb.contiguous(),
                          use_psum_layout=use_psum_layout, out_dtype=_out_dtype(d))


def k_grouped_fp8_gemm_nt_contiguous(a, b, d=None, ks: Optional[Sequence[int]] = None,
                                     grouped_layout=None, c=None, recipe=(1, 1, 128),
                                     compiled_dims='mn', use_psum_layout=False) -> torch.Tensor:
    """The flattened k-major form (deepgemm_tpu/ops/k_grouped.py:66-96):
    group g's A and B segments are [m, k_g] and [n, k_g] k-major, flattened
    one after another; ``sfa`` [m, nsf_total] and ``sfb`` [n, nsf_total]
    (the TN form's scales transposed). m and n come from ``c`` or the ``d``
    template [G, m, n]. The host ``ks`` is required, as in JAX. With
    ``use_psum_layout`` the segments are unflattened and the TN form runs,
    as JAX runs it; else the flat kernel reads them in place."""
    del compiled_dims
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    assert ks is not None, 'flattened k-major layout requires host-side ks'
    if c is not None:
        m, n = c.shape[1], c.shape[2]
    else:
        assert d is not None, 'pass c or a d shape template'
        m, n = d.shape[1], d.shape[2]
    gran_k = recipe[2] if recipe is not None else 128
    if gran_k != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {gran_k})')
    for sf, name in ((sfa, 'sfa'), (sfb, 'sfb')):
        if sf.dtype != torch.float32:
            raise NotImplementedError(f'{name}: only f32 scales are ported (got {sf.dtype})')
    sfa_t, sfb_t = sfa.t().contiguous(), sfb.t().contiguous()
    if use_psum_layout:
        return k_grouped_fp8_gemm_tn_contiguous(
            (unflatten_k_major(a_val, ks, m), sfa_t), (unflatten_k_major(b_val, ks, n), sfb_t),
            d, ks, grouped_layout, c, recipe, use_psum_layout=True)
    nsf_expect = sum(ceil_div(int(kg), gran_k) for kg in ks)
    assert tuple(sfa_t.shape) == (nsf_expect, m) and tuple(sfb_t.shape) == (nsf_expect, n), \
        f'sfa / sfb must be [m, nsf_total={nsf_expect}] / [n, nsf_total], got ' \
        f'{tuple(sfa.shape)} / {tuple(sfb.shape)}'
    return k_grouped_gemm_flat(a_val, b_val, ks, m, n, c, sfa_t, sfb_t, out_dtype=_out_dtype(d))


def k_grouped_bf16_gemm_tn_contiguous(a, b, d=None, ks: Optional[Sequence[int]] = None,
                                      grouped_layout=None, c=None, compiled_dims='mn',
                                      use_psum_layout=False) -> torch.Tensor:
    """d[g] = c[g] + a_g^T @ b_g for bf16 operands, f32 accumulation."""
    del compiled_dims
    grouped_layout, num_groups = _layout_and_groups(a, ks, grouped_layout, c)
    assert grouped_layout.numel() == num_groups, (grouped_layout.shape, num_groups)
    return k_grouped_gemm(a, b, grouped_layout, c, use_psum_layout=use_psum_layout,
                          out_dtype=_out_dtype(d))
