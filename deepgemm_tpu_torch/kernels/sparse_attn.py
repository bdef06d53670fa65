"""Attention over the rows the indexer selected (serving decode and the
prefill consumer): the wrappers of the two CUDA entries, their plain
PyTorch versions and their launch counts.

Per row and head, ``softmax(scale * q . k_sel^T over the valid t) . v_sel``
in f32; a row with no valid t gives 0. Masking is by select: an invalid t
contributes nothing, so a NaN or Inf in an unselected cache row cannot
reach the output (the JAX kernel adds -inf instead, sparse_attn.py:94).

Replaces:
  * :func:`gathered_attention`, over rows already gathered into k_sel/v_sel:
    deepgemm_tpu/kernels/sparse_attn.py:_build (``pl.pallas_call`` at
    sparse_attn.py:104);
  * :func:`sparse_attention_paged`, the gather-fused form that reads the
    selected rows in place from the flat cache views through ``tok``:
    sparse_attn.py:_build_paged (``pl.pallas_call`` at sparse_attn.py:274,
    the decode's ``DGT_SPARSE_GATHER=pallas``).
Kernel: csrc/sparse_attn.cu, two entries on one body: a block per (row,
head group), one producer warp copying each valid position's k and v rows
into a shared-memory ring with 1-D bulk async copies, consumer warps in
CUDA-core f32 with an online softmax; the entries differ only in the
address the producer computes, so on the same rows they give the same bits.
Bound on the H100: the bytes of the valid selected k and v rows, read once;
the gather-fused entry saves the gather's write and re-read of them.

The JAX module's ``DGT_SPARSE_ATTN`` switch (the kernel, XLA einsums, or
a VMEM-budget choice between them) has no counterpart: CUDA tensors always
take the kernel, which raises for a shape outside its contract. Nor does
JAX's quiet drop of the gather-fused form to the gathered one outside its
TPU lane contract (``paged_eligible``): both entries take the same shapes.
"""

import ctypes

import torch

from ..runtime import build
from .common import use_plain

# Kernel launches since the counts were last set to 0: gathered_attention's
# and sparse_attention_paged's.
launches = 0
paged_launches = 0

HEAD_DIMS = (64, 128, 256)      # what csrc/sparse_attn.cu is instantiated for
_PLAIN_CHUNK = 1 << 28          # f32 elements of k or v per step of the plain version


def _entry(paged: bool = False):
    lib = build.load('sparse_attn')
    if paged:
        fn = lib.dgt_sparse_attention_paged
        argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    else:
        fn = lib.dgt_sparse_attention
        argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def fused_eligible(topk: int, num_heads: int, head_dim: int) -> bool:
    """The CUDA kernel's shape contract, both entries: any topk and head
    count, head_dim 64, 128 or 256 (d / 8 lanes hold a row, 16 bytes each).
    The plain versions are held to the same contract."""
    return topk >= 1 and num_heads >= 1 and head_dim in HEAD_DIMS


def _check_aligned(**tensors):
    """The kernel copies and loads rows 16 bytes at a time: the paged
    entry's cache views, which are never copied, must start on a 16-byte
    boundary."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f'{name}: the kernel takes 16-byte aligned rows, got an offset of '
                             f'{x.data_ptr() % 16} bytes')


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous from a 16-byte aligned base: a copy where its view
    starts off one (as the MQA logits wrapper does)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    q, k_sel, v_sel = _aligned(q), _aligned(k_sel), _aligned(v_sel)
    ok = valid.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    lib, fn = _entry()
    code = fn(q.data_ptr(), k_sel.data_ptr(), v_sel.data_ptr(), ok.data_ptr(), out.data_ptr(),
              rows, t, h, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'gathered_attention')
    global launches
    launches += 1
    return out


def _check_paged(q: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
                 tok: torch.Tensor, valid: torch.Tensor, out_dtype):
    rows, h, d = q.shape
    for name, x in (('q', q), ('k_rows', k_rows), ('v_rows', v_rows)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f'{name}: dtype {x.dtype}, the kernel takes bf16')
    if out_dtype not in (None, torch.bfloat16):
        raise TypeError(f'out_dtype {out_dtype}: the kernel writes bf16')
    if k_rows.dim() != 3 or tuple(k_rows.shape[1:]) != (h, d) or k_rows.shape[0] < 1 \
            or k_rows.shape != v_rows.shape:
        raise ValueError(f'k_rows/v_rows: shapes {tuple(k_rows.shape)}, {tuple(v_rows.shape)}, '
                         f'expected [N >= 1, {h}, {d}]')
    if tok.dim() != 2 or tok.shape[0] != rows or tok.dtype.is_floating_point:
        raise ValueError(f'tok: {tok.dtype} {tuple(tok.shape)}, expected integer [{rows}, topk]')
    if valid.dtype != torch.bool or valid.shape != tok.shape:
        raise ValueError(f'valid: {valid.dtype} {tuple(valid.shape)}, expected bool '
                         f'{list(tok.shape)}')
    if not fused_eligible(tok.shape[1], h, d):
        raise ValueError(f'the kernel takes head_dim in {HEAD_DIMS}, got {d}')


def sparse_attention_paged_plain(q: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
                                 tok: torch.Tensor, valid: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """The gather-fused kernel's function in plain PyTorch: tok clipped to
    [0, N), the rows taken with a flat ``index_select``, then
    :func:`gathered_attention_plain`'s arithmetic; a few rows at a time."""
    rows, h, d = q.shape
    t = tok.shape[1]
    flat = tok.long().clamp(0, k_rows.shape[0] - 1)
    out = torch.empty_like(q)
    step = max(1, _PLAIN_CHUNK // max(1, t * h * d))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        idx = flat[r0:r1].reshape(-1)
        k_sel = k_rows.index_select(0, idx).view(r1 - r0, t, h, d)
        v_sel = v_rows.index_select(0, idx).view(r1 - r0, t, h, d)
        out[r0:r1] = gathered_attention_plain(q[r0:r1], k_sel, v_sel, valid[r0:r1], scale)
    return out


def sparse_attention_paged(q: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
                           tok: torch.Tensor, valid: torch.Tensor, scale: float,
                           out_dtype=None) -> torch.Tensor:
    """Gather-fused attention over rows selected from the cache. q [rows, h,
    d] bf16; k_rows/v_rows [N, h, d] bf16, the flat views of the pages
    (``k_pages.view(-1, h, d)``: no copy); tok [rows, topk] int flat row
    indices, clipped to [0, N) (an invalid entry may point anywhere); valid
    [rows, topk] bool. Returns [rows, h, d] bf16 (``out_dtype`` None or
    bf16); a row with no valid t gives 0. The same function as
    ``index_select`` + :func:`gathered_attention`, with the same bits on the
    card. CPU tensors take the plain version, CUDA tensors launch the kernel
    or raise; the cache views are never copied (a non-contiguous one
    raises)."""
    _check_paged(q, k_rows, v_rows, tok, valid, out_dtype)
    if use_plain(q, k_rows, v_rows, tok, valid) or q.shape[0] == 0:
        return sparse_attention_paged_plain(q, k_rows, v_rows, tok, valid, scale)
    if not (k_rows.is_contiguous() and v_rows.is_contiguous()):
        raise ValueError('k_rows/v_rows: the cache views must be contiguous (no copy is made)')
    rows, h, d = q.shape
    q = _aligned(q)
    tok = tok.to(torch.int32).contiguous()
    ok = valid.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    _check_aligned(k_rows=k_rows, v_rows=v_rows)
    lib, fn = _entry(paged=True)
    code = fn(q.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(), tok.data_ptr(), ok.data_ptr(),
              out.data_ptr(), rows, tok.shape[1], h, d, k_rows.shape[0], float(scale),
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, 'sparse_attention_paged')
    global paged_launches
    paged_launches += 1
    return out
