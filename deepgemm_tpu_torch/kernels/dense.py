"""Dense FP8 NT GEMM with f32 scales: the wrapper of the CUDA kernel, its
plain PyTorch version and its launch count.

Replaces: deepgemm_tpu/kernels/dense.py:_build_dense_gemm (``pl.pallas_call``
at dense.py:291), NT layout, 'promote' scale strategy, bf16 or f32 output
(the FP8 wgrad's f32 output, deepgemm_tpu/ops/autograd.py:70-72).
Kernel: csrc/dense.cu on the mainloop of csrc/gemm_mainloop.cuh.
Bound on the H100: a 4096^3 product does 2*4096^3 operations on 32 MiB of
fp8 input, ~2000 operations a byte, so the fp8 tensor-core rate bounds it;
at m = 128 the weights' bytes weigh as much. The design streams 128-deep k
slices through a 4-stage cp.async ring into mma.sync e4m3 tiles and applies
the scales per slice in registers; it reaches a fraction of the wgmma rate,
which a later kernel earns.
"""

import ctypes

import torch

from ..heuristics.configs import get_gemm_config
from ..runtime import build
from ..runtime.config import get_num_sms
from ..utils.math import ceil_div
from .common import check_operand, promote_block, sfb_shift, use_plain

# Kernel launches since the count was last set to 0.
launches = 0


def _entry():
    fn = build.load('dense').dgt_dense_fp8_gemm_nt
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_OUT_DTYPES = (torch.bfloat16, torch.float32)


def dense_fp8_gemm_nt_plain(a: torch.Tensor, b: torch.Tensor, sfa: torch.Tensor,
                            sfb: torch.Tensor, gran_n: int = 128,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``promote(a, b)`` in
    ``out_dtype``."""
    return promote_block(a, b, sfa, sfb, gran_n).to(out_dtype)


def dense_fp8_gemm_nt(a: torch.Tensor, b: torch.Tensor, sfa: torch.Tensor,
                      sfb: torch.Tensor, gran_n: int = 128,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """d[m, n] = promote(a [m, k] e4m3, b [n, k] e4m3) with f32 scales
    sfa [m, ceil(k/128)] and sfb [ceil(n/gran_n), ceil(k/128)] (one scale
    per gran_n rows of b and 128-deep k block), in ``out_dtype`` (bf16 or
    f32: the same f32 sum, rounded or not).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(f'output dtype {out_dtype}: bf16 or f32 only')
    if use_plain(a, b, sfa, sfb):
        return dense_fp8_gemm_nt_plain(a, b, sfa, sfb, gran_n, out_dtype)
    m, k = a.shape
    n = b.shape[0]
    ksf = ceil_div(k, 128)
    shift = sfb_shift(gran_n)
    fp8 = torch.float8_e4m3fn
    check_operand(a, 'a', fp8, (m, k))
    check_operand(b, 'b', fp8, (n, k))
    check_operand(sfa, 'sfa', torch.float32, (m, ksf))
    check_operand(sfb, 'sfb', torch.float32, (ceil_div(n, gran_n), ksf))
    if min(m, n, k) == 0 or k % 16 or n % 2:
        raise ValueError(f'the kernel takes non-empty shapes, k % 16 == 0 and '
                         f'even n; got m={m}, n={n}, k={k}')
    cfg = get_gemm_config(m, n, 1, num_sms=get_num_sms(a.device))
    d = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _entry()
    code = fn(a.data_ptr(), b.data_ptr(), sfa.data_ptr(), sfb.data_ptr(),
              d.data_ptr(), m, n, k, shift, cfg.block_n, int(out_dtype == torch.float32),
              torch.cuda.current_stream(a.device).cuda_stream)
    build.check(build.load('dense'), code, 'dense_fp8_gemm_nt')
    global launches
    launches += 1
    return d
