"""Attention over the rows the indexer selected (serving decode and the
prefill consumer): the wrapper of the CUDA kernel, its plain PyTorch
version and its launch count.

Per row and head, ``softmax(scale * q . k_sel^T over the valid t) . v_sel``
in f32; a row with no valid t gives 0. Masking is by select: an invalid t
contributes nothing, so a NaN or Inf in an unselected cache row cannot
reach the output (the JAX kernel adds -inf instead, sparse_attn.py:94).

Replaces: deepgemm_tpu/kernels/sparse_attn.py:_build (``pl.pallas_call`` at
sparse_attn.py:104). Kernel: csrc/sparse_attn.cu, one warp per (row,
head), CUDA-core f32 over bf16 loads with an online softmax. Bound on the
H100: the bytes of k_sel and v_sel, read once.

The JAX module's ``DGT_SPARSE_ATTN`` switch (the kernel, XLA einsums, or
a VMEM-budget choice between them) has no counterpart: CUDA tensors always
take the kernel, which raises for a shape outside its contract.

Not ported yet: the gather-fused kernel, sparse_attn.py:_build_paged
(``pl.pallas_call`` at sparse_attn.py:274, ``DGT_SPARSE_GATHER=pallas``);
it is the next slice of the port (ROADMAP.md, Queue 1).
"""

import ctypes

import torch

from ..runtime import build
from .common import use_plain

# Kernel launches since the count was last set to 0.
launches = 0

HEAD_DIMS = (64, 128, 256)      # what csrc/sparse_attn.cu is instantiated for
_PLAIN_CHUNK = 1 << 28          # f32 elements of k or v per step of the plain version


def _entry():
    lib = build.load('sparse_attn')
    fn = lib.dgt_sparse_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def fused_eligible(topk: int, num_heads: int, head_dim: int) -> bool:
    """The CUDA kernel's shape contract: any topk and head count, head_dim
    64, 128 or 256 (one warp's lanes split d evenly into 4, 8 or 16 bytes).
    The plain version is held to the same contract."""
    return topk >= 1 and num_heads >= 1 and head_dim in HEAD_DIMS


def _check(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor, valid: torch.Tensor):
    rows, h, d = q.shape
    t = k_sel.shape[1]
    for name, x in (('q', q), ('k_sel', k_sel), ('v_sel', v_sel)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f'{name}: dtype {x.dtype}, the kernel takes bf16')
    if tuple(k_sel.shape) != (rows, t, h, d) or tuple(v_sel.shape) != (rows, t, h, d):
        raise ValueError(f'k_sel/v_sel: shapes {tuple(k_sel.shape)}, {tuple(v_sel.shape)}, '
                         f'expected [{rows}, topk, {h}, {d}]')
    if valid.dtype != torch.bool or tuple(valid.shape) != (rows, t):
        raise ValueError(f'valid: {valid.dtype} {tuple(valid.shape)}, expected bool [{rows}, {t}]')
    if not fused_eligible(t, h, d):
        raise ValueError(f'the kernel takes head_dim in {HEAD_DIMS}, got {d}')


def gathered_attention_plain(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor,
                             valid: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the JAX kernel writes it:
    f32 scores, the max over the valid t, exp, the sum, p / sum, p . v; a
    row with no valid t gives 0. A few rows at a time."""
    rows, t, h, d = k_sel.shape
    out = torch.empty_like(q)
    step = max(1, _PLAIN_CHUNK // max(1, t * h * d))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        ok = valid[r0:r1, None, :]                                       # [n, 1, t]
        s = torch.einsum('nhd,nthd->nht', q[r0:r1].float(), k_sel[r0:r1].float()) * scale
        m = torch.where(ok, s, float('-inf')).amax(-1, keepdim=True).clamp(min=-3.0e38)
        p = torch.where(ok, torch.exp(s - m), 0.0)
        den = p.sum(-1, keepdim=True)
        p = p / torch.where(den > 0, den, 1.0)
        v = torch.where(valid[r0:r1, :, None, None], v_sel[r0:r1].float(), 0.0)
        out[r0:r1] = torch.einsum('nht,nthd->nhd', p, v).to(q.dtype)
    return out


def gathered_attention(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor,
                       valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q [rows, h, d] bf16; k_sel/v_sel [rows, topk, h, d] bf16; valid
    [rows, topk] bool. Returns [rows, h, d] bf16; a row with no valid t gives
    0. CPU tensors take the plain version, CUDA tensors launch the kernel or
    raise."""
    _check(q, k_sel, v_sel, valid)
    if use_plain(q, k_sel, v_sel, valid) or q.shape[0] == 0:
        return gathered_attention_plain(q, k_sel, v_sel, valid, scale)
    rows, t, h, d = k_sel.shape
    q, k_sel, v_sel = q.contiguous(), k_sel.contiguous(), v_sel.contiguous()
    ok = valid.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    lib, fn = _entry()
    code = fn(q.data_ptr(), k_sel.data_ptr(), v_sel.data_ptr(), ok.data_ptr(), out.data_ptr(),
              rows, t, h, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'gathered_attention')
    global launches
    launches += 1
    return out
