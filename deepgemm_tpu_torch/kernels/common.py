"""What the kernels' wrappers share: the choice between a kernel and its
plain PyTorch version, the operand checks, the launch counts, the plain
form of the exact FP8 promotion step (deepgemm_tpu/kernels/common.py:27-52),
and the k-major relayout that the Hopper mainloop's wrappers run before it
(csrc/relayout.cuh).
The counterpart of the cross-rank entry barrier (common.py:89,
``ici_entry_barrier``) is device code: csrc/comm.cuh."""

import contextlib
import ctypes
import threading
from typing import Optional, Sequence

import torch

from ..runtime import build
from ..runtime.config import get_mk_alignment_for_contiguous_layout
from ..utils.math import ceil_div

# How many plain_versions contexts are open (process-wide, all threads).
_plain_on_cuda = 0
# The ranks of a mesh launch from several threads: launch counts and the
# depth above change under this lock.
COUNT_LOCK = threading.Lock()


# Launches of the k-major relayout since the counts were last set to 0, by
# the library whose copy ran: 'dense' (an MN-major operand of the dense
# kernel) or 'k_grouped' (the FP8 k-grouped kernel's TN operands).
relayout_launches = {'dense': 0, 'k_grouped': 0}


def count_launch(counts: dict, key: str) -> None:
    """``counts[key] += 1`` under :data:`COUNT_LOCK`."""
    with COUNT_LOCK:
        counts[key] += 1


@contextlib.contextmanager
def plain_versions():
    """While open, every wrapper runs its kernel's plain PyTorch version on
    CUDA tensors too, and launches nothing. For holding a kernel against its
    plain version on the card (``chip_smoke.py``, the GPU tests); nothing
    else opens it, and it never opens by itself: a kernel that fails to
    build or launch raises. It holds for every thread, the ranks of a mesh
    included: open it around ``Mesh.map``, not inside a rank's function,
    where it would reach the other ranks' calls too."""
    global _plain_on_cuda
    with COUNT_LOCK:
        _plain_on_cuda += 1
    try:
        yield
    finally:
        with COUNT_LOCK:
            _plain_on_cuda -= 1


@contextlib.contextmanager
def f32_products():
    """While open, f32 matrix products on a CUDA card run in full f32 (TF32
    off), whatever the caller set: for plain versions whose products take
    f32 operands that TF32 would round."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def use_plain(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, or any tensors inside :func:`plain_versions`
    (the plain version runs); False for CUDA tensors (the kernel launches).
    All tensors must share one device; any other device raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f'operands on several devices: {sorted(map(str, devices))}')
    dev = devices.pop()
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {dev}')
    return dev.type == 'cpu' or _plain_on_cuda > 0


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: Sequence[int]):
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor of
    ``shape``: what the CUDA kernels take."""
    if t.dtype != dtype:
        raise TypeError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'{name}: data must be 16-byte aligned')


def select_rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]`` along dim 0, for e4m3 tensors too (through a byte view)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).index_select(0, index).view(t.dtype)
    return t.index_select(0, index)


def psum_group_starts(ends: torch.Tensor) -> torch.Tensor:
    """First row of each group of a psum layout (per-group end rows): the
    previous group's end aligned up to the mk alignment (128 unless
    ``set_mk_alignment_for_contiguous_layout`` or ``DGT_MK_ALIGNMENT`` says
    otherwise), 0 for the first group. A group whose start passes its end
    is empty."""
    align = get_mk_alignment_for_contiguous_layout()
    prev = torch.cat([ends.new_zeros(1), ends[:-1]])
    starts = (prev + align - 1) // align * align
    starts[0] = 0
    return starts


def sfb_shift(gran_n: int) -> int:
    """log2 of SFB's row granularity, as the kernels take it (a power of
    two: 1 per channel, 128 per block)."""
    if gran_n < 1 or gran_n & (gran_n - 1):
        raise ValueError(f'gran_n must be a power of two, got {gran_n}')
    return gran_n.bit_length() - 1


def promote_block(a: torch.Tensor, b: torch.Tensor, sfa: Optional[torch.Tensor],
                  sfb: Optional[torch.Tensor], gran_n: int = 128,
                  gran_k: int = 128) -> torch.Tensor:
    """f32 ``sum_s (a_s @ b_s^T) * sfb[s] (per column) * sfa[s] (per row)``
    over the 128-deep k sub-blocks ``s``, in that multiply order.

    ``a`` [..., m, k] and ``b`` [..., n, k] are e4m3 (or any float type);
    ``sfa`` is [..., m, ksf] (None: ``a`` is unscaled, as the mega block's
    bf16 act or a folded FP4 operand), ``sfb`` [..., ceil(n/gran_n), ksf]
    (one scale per ``gran_n`` rows of ``b``; None: unscaled). The products
    run in f32 on upcast operands, which is exact for e4m3 inputs; on a CUDA
    card TF32 must be off (``torch.backends.cuda.matmul.allow_tf32`` is
    False by default)."""
    n, k = b.shape[-2:]
    total = None
    for s in range(ceil_div(k, gran_k)):
        a_s = a[..., s * gran_k:(s + 1) * gran_k].float()
        b_s = b[..., s * gran_k:(s + 1) * gran_k].float()
        term = torch.matmul(a_s, b_s.transpose(-1, -2))
        if sfb is not None:
            term = term * sfb[..., s].repeat_interleave(gran_n, dim=-1)[..., None, :n]
        if sfa is not None:
            term = term * sfa[..., :, s:s + 1]
        total = term if total is None else total + term
    return total


def k_major_relayout_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The relayout kernel's function in plain PyTorch: out[d, c] =
    x[src[c], d], zero where src[c] < 0. One row gather, one mask, one
    transposing copy."""
    raw = x.view(torch.uint8) if x.element_size() == 1 else x.view(torch.int16)
    if x.shape[0] == 0:
        return torch.zeros((x.shape[1], src.numel()), dtype=x.dtype, device=x.device)
    gathered = raw.index_select(0, src.long().clamp(min=0))
    gathered.masked_fill_((src < 0)[:, None], 0)
    return gathered.t().contiguous().view(x.dtype)


def k_major_relayout(x: torch.Tensor, src: torch.Tensor, lib: str) -> torch.Tensor:
    """out [dim, ldk] with out[d, c] = x[src[c], d] (zero where src[c] < 0)
    for an e4m3 x [rows, dim] and src int32 [ldk], ldk % 16 == 0: one
    transposing gather, each byte read once and written once (with src the
    identity, a transposing copy). ``lib`` ('dense' or 'k_grouped') is the
    library whose copy of csrc/relayout.cuh runs and the key it counts
    under. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if use_plain(x, src):
        return k_major_relayout_plain(x, src)
    rows, dim = x.shape
    ldk = src.numel()
    check_operand(x, 'x', torch.float8_e4m3fn, (rows, dim))
    check_operand(src, 'src', torch.int32, (ldk,))
    if ldk % 16 or ldk == 0 or dim == 0:
        raise ValueError(f'the relayout takes ldk % 16 == 0 and ldk, dim > 0; got {ldk}, {dim}')
    out = torch.empty((dim, ldk), dtype=x.dtype, device=x.device)
    fn = build.load(lib).dgt_k_major_relayout
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), src.data_ptr(), out.data_ptr(), dim, ldk,
              torch.cuda.current_stream(x.device).cuda_stream)
    build.check(build.load(lib), code, 'k_major_relayout')
    count_launch(relayout_launches, lib)
    return out
