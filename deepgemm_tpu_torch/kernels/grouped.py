"""Masked m-grouped NT GEMM (MoE expert GEMM), bf16 or scaled FP8: the
wrapper of the CUDA kernel, its plain PyTorch version and its launch counts.

Replaces: deepgemm_tpu/kernels/grouped.py:_build_masked (``pl.pallas_call``
at grouped.py:576).
Kernel: csrc/masked.cu on the mainloop of csrc/gemm_mainloop.cuh, one
instantiation for bf16 and one for e4m3 with the f32 promotion.
Bound on the H100: the model's expert GEMMs have max_m = 40 rows per expert
against 4096 x 7168 (or 7168 x 2048) weights, ~80 operations per weight
byte, so streaming every expert's weights once from HBM bounds them. The
grid has one block per (n-tile, m-tile, expert): 8192 blocks at the L1
shape, enough to keep every SM's 4-stage cp.async ring full of weight
bytes; m-tiles at or past ``masked_m[g]`` exit before loading anything.
``masked_m`` is read on the device only, so no call syncs the host.
"""

import ctypes
from typing import Optional

import torch

from ..heuristics.configs import get_gemm_config
from ..runtime import build
from ..runtime.config import get_num_sms
from ..utils.math import ceil_div
from .common import check_operand, promote_block, sfb_shift, use_plain

# Kernel launches per instantiation since the counts were last set to 0.
launches = {'bf16': 0, 'fp8': 0}

# Upcast at most this many bytes of f32 weights at once in the plain version
# (all 256 experts of a DeepSeek-V3 layer at once would take 30 GB).
_PLAIN_CHUNK_BYTES = 1 << 31


def _entry():
    fn = build.load('masked').dgt_masked_gemm_nt
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def masked_gemm_plain(a: torch.Tensor, b: torch.Tensor, masked_m: torch.Tensor,
                      sfa: Optional[torch.Tensor] = None,
                      sfb: Optional[torch.Tensor] = None, gran_n: int = 128) -> torch.Tensor:
    """The kernel's function in plain PyTorch. Every row is computed; rows at
    or past ``masked_m[g]`` are unspecified in the contract, so
    ``masked_m`` is not read (no host sync)."""
    del masked_m
    num_groups, max_m, k = a.shape
    n = b.shape[1]
    d = torch.empty((num_groups, max_m, n), dtype=torch.bfloat16, device=a.device)
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, n * k * 4))
    for g0 in range(0, num_groups, chunk):
        sl = slice(g0, g0 + chunk)
        if sfa is None:
            part = torch.matmul(a[sl].float(), b[sl].float().transpose(1, 2))
        else:
            part = promote_block(a[sl], b[sl], sfa[sl], sfb[sl], gran_n)
        d[sl] = part.to(torch.bfloat16)
    return d


def masked_gemm(a: torch.Tensor, b: torch.Tensor, masked_m: torch.Tensor,
                sfa: Optional[torch.Tensor] = None,
                sfb: Optional[torch.Tensor] = None, gran_n: int = 128) -> torch.Tensor:
    """d[g, :masked_m[g]] = a[g] @ b[g]^T, bf16 out.

    ``a`` [G, max_m, k] and ``b`` [G, n, k] are both bf16 (no scales) or both
    e4m3 with f32 scales ``sfa`` [G, max_m, ceil(k/128)] and ``sfb``
    [G, ceil(n/gran_n), ceil(k/128)] (the promotion). ``masked_m`` [G] int32
    lies on the operands' device. Rows at or past ``masked_m[g]`` are
    unspecified.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if use_plain(a, b, masked_m, sfa, sfb):
        return masked_gemm_plain(a, b, masked_m, sfa, sfb, gran_n)
    num_groups, max_m, k = a.shape
    n = b.shape[1]
    is_fp8 = a.dtype == torch.float8_e4m3fn
    dtype = torch.float8_e4m3fn if is_fp8 else torch.bfloat16
    shift = sfb_shift(gran_n)
    check_operand(a, 'a', dtype, (num_groups, max_m, k))
    check_operand(b, 'b', dtype, (num_groups, n, k))
    check_operand(masked_m, 'masked_m', torch.int32, (num_groups,))
    if is_fp8:
        if sfa is None or sfb is None:
            raise ValueError('fp8 operands need sfa and sfb')
        ksf = ceil_div(k, 128)
        check_operand(sfa, 'sfa', torch.float32, (num_groups, max_m, ksf))
        check_operand(sfb, 'sfb', torch.float32, (num_groups, ceil_div(n, gran_n), ksf))
    elif sfa is not None or sfb is not None:
        raise ValueError('scales go with e4m3 operands only')
    if min(num_groups, max_m, n, k) == 0 or k % 16 or n % 2:
        raise ValueError(f'the kernel takes non-empty shapes, k % 16 == 0 and '
                         f'even n; got G={num_groups}, max_m={max_m}, n={n}, k={k}')
    cfg = get_gemm_config(max_m, n, num_groups, num_sms=get_num_sms(a.device))
    d = torch.empty((num_groups, max_m, n), dtype=torch.bfloat16, device=a.device)
    fn = _entry()
    code = fn(a.data_ptr(), b.data_ptr(),
              sfa.data_ptr() if is_fp8 else None,
              sfb.data_ptr() if is_fp8 else None,
              masked_m.data_ptr(), d.data_ptr(),
              num_groups, max_m, n, k, int(is_fp8), shift, cfg.block_n,
              torch.cuda.current_stream(a.device).cuda_stream)
    build.check(build.load('masked'), code, 'masked_gemm')
    launches['fp8' if is_fp8 else 'bf16'] += 1
    return d
