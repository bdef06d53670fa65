"""The fused MoE expert block at one rank (the mega kernel's D=1 form): the
wrapper of the CUDA kernel, its plain PyTorch version, its launch count,
the weight pack and the shape check.

Replaces: deepgemm_tpu/kernels/fused_moe.py:_mega_kernel_local
(``pl.pallas_call`` at fused_moe.py:690, ``_mega_local_call``), with the
arithmetic of ``_promote_dot``, ``_silu``, ``_l1_epilogue`` and
``_decode_fp4_chunk`` (fused_moe.py:204-340), and ``fused_mega_moe`` for
one rank (fused_moe.py:984-1114).
Kernel: csrc/mega_local.cu. One block owns one expert and 48 of its slot
rows: the L1 tiles (128 gate and 128 up columns), SwiGLU with clamp and
the row's top-k weight (and the per-128 fp8 requant when act is fp8) into
a scratch in device memory that only that block reads, then the L2 tiles
streaming act back beside the weights. Bound on the H100: each expert's
weights are streamed once (~44 MB fp8 at DeepSeek-V3 widths against 40
slot rows), so bytes bound it.

Not ported (ROADMAP.md, the multi-GPU tier, kernel #14): the D > 1 kernel
(``send_x`` with more than one slab), ``force_general`` and wave pools
(``pool > 1``, ``DGT_MEGA_POOL``); they raise.
"""

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .. import envs
from ..heuristics.arch import H100_SXM
from ..runtime import build
from ..utils.math import _dequantize_from_fp4_e2m1, per_token_cast_to_fp8, unpack_fp4_planar
from .common import check_operand, promote_block, use_plain

# Kernel launches per instance since the counts were last set to 0.
launches = {'bf16': 0, 'fp8': 0, 'fp8_act_fp8': 0, 'fp4': 0, 'fp4_act_fp8': 0}

TILE = 128              # the kernel's L1 (gate and up each) and L2 tile width
GRAN_K = 128
_MULTI_GPU = ('ROADMAP.md, the multi-GPU tier (kernel #14, kernels/fused_moe.py:_mega_kernel '
              'of the JAX package)')
# Upcast at most this many bytes of f32 weights at once in the plain version.
_PLAIN_CHUNK_BYTES = 1 << 31


def _entry():
    fn = build.load('mega_local').dgt_mega_local
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


ROWS = 48               # slot rows per block


def smem_bytes(inter: int) -> int:
    """Shared memory of one block (csrc/mega_local.cu:smem_bytes): the
    4-stage cp.async ring of 48 x rows and 256 weight rows, 144 bytes each,
    then the act scales, the amax partials of 8 warps and the row weights."""
    ring = 4 * (ROWS + 2 * TILE) * 144
    return ring + ROWS * (inter // 128) * 4 + 8 * ROWS * 4 + ROWS * 4


def resolve_act_fp8(act_fp8: Optional[bool] = None) -> bool:
    """The act type between L1 and L2 (scaled mode): ``DGT_MEGA_ACT_FP8``
    ('1' fp8, anything else bf16) wins, then the argument, then bf16 (the
    JAX package's default: no requant)."""
    env = envs.mega_act_fp8()
    if env is not None:
        return env == '1'
    return bool(act_fp8) if act_fp8 is not None else False


def check_shape(hidden: int, inter: int, *, w_fp4: bool = False) -> None:
    """Raise unless the kernel takes these widths. In the place of JAX's
    VMEM-budgeted ``pick_mega_tiles`` there is one tile, 128 wide for L1
    (gate and up each) and L2, so JAX's divisor contract (``inter % bn1 ==
    0``, ``hidden % bh2 == 0``, ``bn1 % 128 == 0`` when scaled) is that both
    widths are multiples of 128 (256 for planar FP4, which packs 256-code
    groups), and a block's ring, act scales and row weights must fit the
    H100's 227 KB."""
    quantum = 2 * TILE if w_fp4 else TILE
    if inter % quantum or hidden % quantum:
        raise ValueError(f'hidden {hidden} and intermediate {inter} must be multiples of {quantum}')
    need = smem_bytes(inter)
    if need > H100_SXM.smem_per_block:
        raise ValueError(f'intermediate {inter}: a block needs {need} bytes of shared memory, '
                         f'above the {H100_SXM.smem_per_block} an H100 block may use')


@dataclasses.dataclass
class MegaPackedWeights:
    """The mega block's weights made ready once, at load time (the analog of
    JAX's ``MegaPackedWeights``; the tile layout is each package's own).
    The kernel pairs gate and up rows by address, so the layout is the
    canonical one, ``w1`` [E, 2I, H] gate rows first and ``w2`` [E, H, I]
    (planar FP4: k halved), made contiguous with f32 block scales, its
    widths checked and the act type fixed."""
    w1: torch.Tensor
    w2: torch.Tensor
    w1_sf: Optional[torch.Tensor]     # [E, 2I/128, H/128] f32, or None (bf16)
    w2_sf: Optional[torch.Tensor]     # [E, H/128, I/128] f32, or None
    w_fp4: bool = False
    act_fp8: bool = False


def pack_mega_weights(w1: torch.Tensor, w2: torch.Tensor, w1_sf=None, w2_sf=None, *,
                      num_devices: int = 1, w_packed_fp4: bool = False,
                      act_fp8: Optional[bool] = None) -> MegaPackedWeights:
    """Pack the mega block's weights once. ``w_packed_fp4``: ``w1`` [E, 2I,
    H/2] and ``w2`` [E, H, I/2] are planar-128 FP4 codes (int8,
    utils/math.pack_fp4_planar) with their 128x128 block scales, decoded in
    the kernel."""
    if num_devices != 1:
        raise NotImplementedError(f'pack_mega_weights for {num_devices} ranks: {_MULTI_GPU}')
    if w_packed_fp4:
        assert w1.dtype == torch.int8 and w2.dtype == torch.int8, (w1.dtype, w2.dtype)
        assert w1_sf is not None, 'packed-FP4 mega weights require SF'
        e_local, two_i, wk1 = w1.shape
        hidden, inter = 2 * wk1, two_i // 2
        assert w2.shape == (e_local, hidden, inter // 2), (w2.shape,)
    else:
        e_local, two_i, hidden = w1.shape
        inter = two_i // 2
        assert w2.shape == (e_local, hidden, inter), (w2.shape,)
    check_shape(hidden, inter, w_fp4=w_packed_fp4)
    f32 = lambda t: None if t is None else t.float().contiguous()
    return MegaPackedWeights(w1=w1.contiguous(), w2=w2.contiguous(), w1_sf=f32(w1_sf),
                             w2_sf=f32(w2_sf), w_fp4=w_packed_fp4,
                             act_fp8=resolve_act_fp8(act_fp8))


def decode_fp4_planar(w: torch.Tensor) -> torch.Tensor:
    """Planar-128 FP4 codes [.., k/2] int8 -> e4m3 [.., k], exact."""
    return _dequantize_from_fp4_e2m1(unpack_fp4_planar(w)).to(torch.float8_e4m3fn)


def _silu(x: torch.Tensor, tanh_form: bool) -> torch.Tensor:
    if tanh_form:
        return x * (0.5 * torch.tanh(0.5 * x) + 0.5)
    return F.silu(x)


def mega_local_plain(x, xsf, rw, w1, w1_sf, w2, w2_sf, *, w_fp4=False, act_fp8=False,
                     silu_tanh=False, clamp=256.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, a few experts at a time:
    L1 (the f32 promotion for scaled operands), the epilogue of the
    instance, L2; y [E, cap, H] bf16."""
    e_count, cap, hidden = x.shape
    inter = w1.shape[1] // 2
    scaled = xsf is not None
    act_bf16 = scaled and not act_fp8
    y = torch.empty((e_count, cap, hidden), dtype=torch.bfloat16, device=x.device)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (3 * inter * hidden * 4))
    for e0 in range(0, e_count, chunk):
        sl = slice(e0, e0 + chunk)
        w1c, w2c = w1[sl], w2[sl]
        if w_fp4:
            w1c, w2c = decode_fp4_planar(w1c), decode_fp4_planar(w2c)
        if scaled:
            gu = promote_block(x[sl], w1c, xsf[sl], w1_sf[sl])
        else:
            gu = torch.matmul(x[sl].float(), w1c.float().transpose(1, 2))
        gate, up = gu[..., :inter], gu[..., inter:]
        if not act_bf16:
            gate, up = gate.bfloat16().float(), up.bfloat16().float()
        act = (_silu(gate, silu_tanh) * up).clamp(-clamp, clamp) * rw[sl][..., None]
        act = act.to(torch.bfloat16)
        if not scaled:
            out = torch.matmul(act.float(), w2c.float().transpose(1, 2))
        elif act_fp8:
            n = act.shape[0]
            aq, asf = per_token_cast_to_fp8(act.reshape(-1, inter), use_ue8m0=False)
            out = promote_block(aq.view(n, cap, inter), w2c, asf.view(n, cap, -1), w2_sf[sl])
        else:
            out = promote_block(act, w2c, None, w2_sf[sl])
        y[sl] = out.to(torch.bfloat16)
    return y


def mega_local(x: torch.Tensor, xsf: Optional[torch.Tensor], rw: torch.Tensor,
               w1: torch.Tensor, w1_sf: Optional[torch.Tensor], w2: torch.Tensor,
               w2_sf: Optional[torch.Tensor], *, w_fp4: bool = False, act_fp8: bool = False,
               silu_tanh: bool = False, clamp: float = 256.0) -> torch.Tensor:
    """y [E, cap, H] bf16 of the fused expert block.

    ``x`` [E, cap, H]: e4m3 with ``xsf`` [E, cap, H/128] f32 and weights
    ``w1`` [E, 2I, H], ``w2`` [E, H, I] e4m3 (or planar FP4 int8 with ``w_fp4``:
    k halved) with block scales ``w1_sf`` [E, 2I/128, H/128] and ``w2_sf``
    [E, H/128, I/128]; or all bf16 without scales. ``rw`` [E, cap] f32 row
    weights. ``act_fp8`` (scaled only) requantizes act per 128 columns;
    ``silu_tanh`` picks silu's form.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    kw = dict(w_fp4=w_fp4, act_fp8=act_fp8, silu_tanh=silu_tanh, clamp=clamp)
    if use_plain(x, xsf, rw, w1, w1_sf, w2, w2_sf):
        return mega_local_plain(x, xsf, rw, w1, w1_sf, w2, w2_sf, **kw)
    e_count, cap, hidden = x.shape
    inter = w1.shape[1] // 2
    scaled = xsf is not None
    if not scaled and (w_fp4 or act_fp8):
        raise ValueError('FP4 weights and fp8 act go with scaled (e4m3) operands')
    check_shape(hidden, inter, w_fp4=w_fp4)
    wk = 2 if w_fp4 else 1
    x_type = torch.float8_e4m3fn if scaled else torch.bfloat16
    w_type = torch.int8 if w_fp4 else x_type
    check_operand(x, 'x', x_type, (e_count, cap, hidden))
    check_operand(rw, 'rw', torch.float32, (e_count, cap))
    check_operand(w1, 'w1', w_type, (e_count, 2 * inter, hidden // wk))
    check_operand(w2, 'w2', w_type, (e_count, hidden, inter // wk))
    if scaled:
        if w1_sf is None or w2_sf is None:
            raise ValueError('scaled operands need w1_sf and w2_sf')
        check_operand(xsf, 'xsf', torch.float32, (e_count, cap, hidden // GRAN_K))
        check_operand(w1_sf, 'w1_sf', torch.float32, (e_count, 2 * inter // 128, hidden // 128))
        check_operand(w2_sf, 'w2_sf', torch.float32, (e_count, hidden // 128, inter // 128))
    elif w1_sf is not None or w2_sf is not None:
        raise ValueError('scales go with e4m3 operands only')
    if min(e_count, cap) == 0:
        raise ValueError(f'the kernel takes non-empty shapes; got E={e_count}, cap={cap}')
    y = torch.empty((e_count, cap, hidden), dtype=torch.bfloat16, device=x.device)
    # the act scratch: each block writes and reads back its own rows only
    act = torch.empty(e_count * cap * inter * (1 if act_fp8 else 2), dtype=torch.uint8,
                      device=x.device)
    kind = 2 if w_fp4 else int(scaled)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _entry()(x.data_ptr(), ptr(xsf), rw.data_ptr(), w1.data_ptr(), ptr(w1_sf),
                    w2.data_ptr(), ptr(w2_sf), act.data_ptr(), y.data_ptr(), e_count, cap,
                    hidden, inter,
                    kind, int(act_fp8), int(silu_tanh), float(clamp),
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(build.load('mega_local'), code, 'mega_local')
    launches[instance_name(scaled, w_fp4, act_fp8)] += 1
    return y


def instance_name(scaled: bool, w_fp4: bool, act_fp8: bool) -> str:
    """The key of :data:`launches` for one instance."""
    if not scaled:
        return 'bf16'
    return ('fp4' if w_fp4 else 'fp8') + ('_act_fp8' if act_fp8 else '')


def fused_mega_moe(send_x: torch.Tensor, rw_steps: torch.Tensor,
                   w1: Optional[torch.Tensor] = None, w2: Optional[torch.Tensor] = None, *,
                   send_sf: Optional[torch.Tensor] = None, w1_sf=None, w2_sf=None,
                   clamp: float = 256.0, packed: Optional[MegaPackedWeights] = None,
                   force_general: bool = False, pool: int = 0,
                   act_fp8: Optional[bool] = None) -> torch.Tensor:
    """The fused mega MoE expert block at one rank (JAX's ``fused_mega_moe``
    with D = 1, without the axis name).

    ``send_x`` [1, E, cap, H] (bf16, or e4m3 with per-token ``send_sf``
    [1, E, cap, >= H/128] f32), ``rw_steps`` [1, E, cap] f32; weights raw
    (``w1`` [E, 2I, H] gate rows first, ``w2`` [E, H, I], fp8 with 128x128
    block scales or bf16, packed in the call) or ``packed``
    (:func:`pack_mega_weights`, whose act type wins). Returns ``combine``
    [1, E, cap, H] bf16."""
    d_dim, e_local, _, hidden = send_x.shape
    if d_dim != 1 or force_general or pool > 1:
        raise NotImplementedError(
            f'fused_mega_moe with {d_dim} ranks, force_general={force_general}, '
            f'pool={pool}: only the one-rank kernel is ported; the rest is {_MULTI_GPU}')
    scaled = send_sf is not None
    if packed is None:
        packed = pack_mega_weights(w1, w2, w1_sf, w2_sf, act_fp8=act_fp8)
    assert scaled == (packed.w1_sf is not None), 'the weights\' SF presence must match send_sf'
    assert packed.w1.shape[0] == e_local, (packed.w1.shape, e_local)
    act_fp8 = scaled and packed.act_fp8
    xsf = None
    if scaled:
        xsf = send_sf[0, ..., :hidden // GRAN_K].float().contiguous()
    # silu's form is the instance's, as in JAX's _l1_epilogue: tanh with bf16 act
    y = mega_local(send_x[0].contiguous(), xsf, rw_steps[0].float().contiguous(), packed.w1,
                   packed.w1_sf, packed.w2, packed.w2_sf, w_fp4=packed.w_fp4, act_fp8=act_fp8,
                   silu_tanh=scaled and not act_fp8, clamp=clamp)
    return y[None]
