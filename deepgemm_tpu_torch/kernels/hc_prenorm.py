"""The HyperConnection prenorm GEMM: the wrapper of the CUDA kernel, its
plain PyTorch version and its launch count.

Replaces: deepgemm_tpu/kernels/hc_prenorm.py:_build_hc_prenorm
(``pl.pallas_call`` at hc_prenorm.py:89), and the split form that JAX
leaves to XLA (deepgemm_tpu/ops/hyperconnection.py:34-47): one launch writes
every split's partials.
Kernel: csrc/hc_prenorm.cu, TF32 ``mma.sync`` (a bf16 a is exact in TF32; b
rounds) with the square sum of a taken from the same shared-memory stage.
Bound on the H100: at the mHC shape (m = 4096, k = 4 x 7168 = 28672, n = 24)
the kernel must read 234.9 MB of a, 2.75 MB of b and write 0.39 MB of d,
about 0.071 ms at 3.35 TB/s, while its 5.6 GFLOP take about 0.011 ms at
TF32's ~495 TFLOP/s: a's bytes bound it, so a is read once and the n-tile
is wide enough (32) that the mHC's 24 columns take one. At decode sizes
(m = 64) the splits give the grid its blocks.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..runtime import build
from ..utils.math import ceil_div
from .common import check_operand, f32_products, use_plain

# Kernel launches since the count was last set to 0.
launches = 0


def _entry():
    fn = build.load('hc_prenorm').dgt_hc_prenorm_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def hc_prenorm_gemm_plain(a: torch.Tensor, b: torch.Tensor, num_splits: int = 1):
    """The kernel's function in plain PyTorch: per split s over the k chunk
    [s * ceil(k/S), (s + 1) * ceil(k/S)), the f32 product (TF32 off) and the
    f32 square sum of a. Returns (d [S, m, n], sqr_sum [S, m])."""
    m, k = a.shape
    n = b.shape[0]
    chunk = ceil_div(k, num_splits)
    pad = num_splits * chunk - k
    a_s = F.pad(a.float(), (0, pad)).view(m, num_splits, chunk).transpose(0, 1)
    b_s = F.pad(b.float(), (0, pad)).view(n, num_splits, chunk).transpose(0, 1)
    with f32_products():
        d = torch.bmm(a_s, b_s.transpose(1, 2))
    return d, (a_s * a_s).sum(-1)


def hc_prenorm_gemm(a: torch.Tensor, b: torch.Tensor, num_splits: int = 1):
    """(d [S, m, n] f32, sqr_sum [S, m] f32) for a bf16 [m, k] and b f32
    [n, k]: per split, ``a @ b^T`` and ``sum(a^2)`` over its chunk of k
    (S = ``num_splits``; chunks of ceil(k/S), the last ones short or empty).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if use_plain(a, b):
        return hc_prenorm_gemm_plain(a, b, num_splits)
    m, k = a.shape
    n = b.shape[0]
    check_operand(a, 'a', torch.bfloat16, (m, k))
    check_operand(b, 'b', torch.float32, (n, k))
    if min(m, n, k) == 0 or k % 8 or num_splits < 1:
        raise ValueError(f'the kernel takes non-empty shapes with k % 8 == 0 and at least '
                         f'one split; got m={m}, n={n}, k={k}, splits={num_splits}')
    d = torch.empty((num_splits, m, n), dtype=torch.float32, device=a.device)
    sqr = torch.empty((num_splits, m), dtype=torch.float32, device=a.device)
    code = _entry()(a.data_ptr(), b.data_ptr(), d.data_ptr(), sqr.data_ptr(), m, n, k,
                    num_splits, ceil_div(k, num_splits),
                    torch.cuda.current_stream(a.device).cuda_stream)
    build.check(build.load('hc_prenorm'), code, 'hc_prenorm_gemm')
    global launches
    launches += 1
    return d, sqr
