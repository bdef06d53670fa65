"""Differentiable FP8 matmuls (counterpart of deepgemm_tpu/ops/autograd.py):
``torch.autograd.Function``s that mirror the JAX custom VJPs step for step,
with the same casts, transposes and output dtypes.

``fp8_matmul`` / ``fp8_dense``: the forward runs the FP8 dense kernel
(activations per-token 1x128, weights per-block 128x128), dgrad the same
kernel against the transposed weights, wgrad the FP8 1D1D product with
per-channel scales along the token contraction into an f32 output.

``fp8_grouped_matmul``: the forward and dgrad run the contiguous grouped
kernel, the wgrad the k-grouped kernel. Where the JAX op builds a
[G, n, k] f32 zero ``c`` and an f32 ``dw`` that it casts to bf16 at once
(autograd.py:154-157), this one asks the k-grouped kernel for a bf16
output with no ``c``: the same f32 sums rounded once, the same bits,
without two [G, n, k] f32 tensors (30 GB each at DeepSeek-V3's L1).

Quantization happens inside the ops, so callers differentiate ordinary
bf16 tensors; the quantizer's rounding passes gradients straight through.
Each op saves its bf16 inputs and quantizes again in the backward, as the
JAX residuals (x, w) ask.
"""

import torch

from ..utils.math import (per_block_cast_to_fp8, per_channel_cast_to_fp8,
                          per_token_cast_to_fp8, quantize_experts)
from .gemm import fp8_gemm_nt
from .k_grouped import k_grouped_fp8_gemm_tn_contiguous
from .m_grouped import m_grouped_fp8_gemm_nt_contiguous

_BF16 = torch.bfloat16


class _FP8Matmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        xq = per_token_cast_to_fp8(x.to(_BF16), use_ue8m0=False)
        wq = per_block_cast_to_fp8(w.to(_BF16), use_ue8m0=False)
        return fp8_gemm_nt(xq, wq)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(_BF16)
        # dgrad: dx [m, k] = g [m, n] @ w [n, k], FP8 NT against w^T
        gq = per_token_cast_to_fp8(g, use_ue8m0=False)
        wtq = per_block_cast_to_fp8(w.t().to(_BF16), use_ue8m0=False)
        dx = fp8_gemm_nt(gq, wtq)
        # wgrad: dw [n, k] = g^T [n, m] @ x [m, k], contraction over tokens
        # m with per-channel (1x128 along m) scales on both sides, f32 out
        gtq = per_token_cast_to_fp8(g.t(), use_ue8m0=False)
        xtq = per_token_cast_to_fp8(x.to(_BF16).t(), use_ue8m0=False)
        dw32 = fp8_gemm_nt(gtq, xtq, d=torch.float32, recipe=(1, 1, 128))
        return dx.to(x.dtype), dw32.to(w.dtype)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d [m, n] = x [m, k] @ w [n, k]^T through FP8 quantization (bf16 in
    and out, differentiable in x and w)."""
    return _FP8Matmul.apply(x, w)


def fp8_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense layer over any leading dims: x [..., k] @ w [n, k]^T."""
    lead = x.shape[:-1]
    out = fp8_matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[0])


def _live(ids: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t with the rows of padding ids (-1) set to zero."""
    return torch.where(ids[:, None] >= 0, t, torch.zeros((), dtype=t.dtype, device=t.device))


class _FP8GroupedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, ids):
        ctx.save_for_backward(x, w, ids)
        xq = per_token_cast_to_fp8(x.to(_BF16), use_ue8m0=False)
        wq = quantize_experts(w.to(_BF16))
        d = m_grouped_fp8_gemm_nt_contiguous(xq, wq, grouped_layout=ids)
        return _live(ids, d)

    @staticmethod
    def backward(ctx, g):
        x, w, ids = ctx.saved_tensors
        num_groups = w.shape[0]
        g = _live(ids, g).to(_BF16)
        # dgrad: dx_i = g_i @ w[ids_i], grouped NT against w^T [G, k, n]
        gq = per_token_cast_to_fp8(g, use_ue8m0=False)
        wtq = quantize_experts(w.to(_BF16), transpose=True)
        dx = _live(ids, m_grouped_fp8_gemm_nt_contiguous(gq, wtq, grouped_layout=ids))
        del gq, wtq
        # wgrad: dw[e] = sum over rows of group e of g_i (x) x_i, the
        # k-grouped TN kernel with the token dim as the grouped contraction.
        # Group sizes from the layout: padding rows attach to the group
        # before them (their g rows are zero above).
        carried = torch.cummax(ids.long(), dim=0).values.clamp(min=0)
        sizes = torch.bincount(carried, minlength=num_groups).int()
        gq2 = per_channel_cast_to_fp8(g, use_ue8m0=False)
        xq2 = per_channel_cast_to_fp8(x.to(_BF16), use_ue8m0=False)
        dw = k_grouped_fp8_gemm_tn_contiguous(gq2, xq2, d=_BF16, grouped_layout=sizes)
        return dx.to(x.dtype), dw.to(w.dtype), None


def fp8_grouped_matmul(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """d [m, n] = x [m, k] @ w[ids] [n, k]^T through FP8 (bf16 in and out,
    differentiable in x and w).

    ``ids`` [m] int32 is the contiguous grouped layout: per-row expert ids,
    -1 for padding rows, group starts on multiples of the 128-row mk
    alignment (the wgrad's per-channel scales take 128 rows of one group at
    a time). Padding rows give zero output and add nothing to dw."""
    return _FP8GroupedMatmul.apply(x, w, ids)
