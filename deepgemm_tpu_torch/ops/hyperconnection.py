"""HyperConnection API (counterpart of deepgemm_tpu/ops/hyperconnection.py):
``tf32_hc_prenorm_gemm(a, b, d, sqr_sum, num_splits)``, the f32 GEMM
``d = a @ b^T`` (a bf16, b f32) that also returns the per-row RMSNorm
statistic ``sum(a^2)``, optionally split over k into ``num_splits``
partials whose sum is the whole result. Both forms run the hand-written
kernel (kernels/hc_prenorm.py); JAX's split form is XLA, the same function.
"""

from typing import Optional, Tuple

import torch

from ..kernels.hc_prenorm import hc_prenorm_gemm


def tf32_hc_prenorm_gemm(a: torch.Tensor, b: torch.Tensor, d=None, sqr_sum=None,
                         num_splits: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(d, sqr_sum)``: [m, n] / [m] f32, or [S, m, n] / [S, m]
    with ``num_splits`` (partials over contiguous k chunks of ceil(k/S);
    callers sum over dim 0). ``d`` and ``sqr_sum`` are accepted for the
    API's sake: every function returns its result."""
    del d, sqr_sum
    assert a.dtype == torch.bfloat16 and b.dtype == torch.float32, (a.dtype, b.dtype)
    m = a.shape[0]
    n = b.shape[0]
    if m == 0:
        lead = () if num_splits is None else (num_splits,)
        return (torch.zeros((*lead, 0, n), dtype=torch.float32, device=a.device),
                torch.zeros((*lead, 0), dtype=torch.float32, device=a.device))
    d_s, sqr_s = hc_prenorm_gemm(a, b, 1 if num_splits is None else num_splits)
    if num_splits is None:
        return d_s[0], sqr_s[0]
    return d_s, sqr_s
