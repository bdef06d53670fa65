"""The fused MoE kernels: the expert block at one rank (the mega kernel's
D=1 form), the general expert-parallel mega kernel and the fused dispatch +
L1 GEMM; each wrapper with its plain PyTorch version and its launch count,
the weight pack, the wave-pool and tile rules and the shape check.

Replaces: deepgemm_tpu/kernels/fused_moe.py:_mega_kernel_local
(``pl.pallas_call`` at fused_moe.py:690, ``_mega_local_call``), with the
arithmetic of ``_promote_dot``, ``_silu``, ``_l1_epilogue`` and
``_decode_fp4_chunk`` (fused_moe.py:204-340), and ``fused_mega_moe`` for
one rank (fused_moe.py:984-1114).
Kernel: csrc/mega_local.cu on csrc/mega_sm90.cuh (wgmma + TMA, a producer
warp, a widening warp and two consumer warpgroups, persistent). An item is
an expert and 40 of its slot rows (wgmma's N; the weights on its M),
gathered once into the block's scratch: the L1 tiles (128 gate and 128 up
columns), SwiGLU with clamp and the row's top-k weight (and the per-128 fp8
requant when act is fp8) into the scratch, then the L2 tiles streaming act
back beside the weights. Bound on the H100: each item streams its expert's
weights once (~44 MB fp8 at DeepSeek-V3 widths against 40 slot rows), so
bytes bound it.

Over a mesh of D ranks (parallel/dist.py), inside ``Mesh.map``:
- ``fused_mega_moe`` with D > 1 (or ``force_general``) replaces
  ``_mega_kernel`` (``pl.pallas_call`` at fused_moe.py:1198): one launch a
  rank of csrc/mega_ep.cu dispatches every slab to its rank, runs the
  expert block (the one-rank kernel's body, csrc/mega_sm90.cuh) on each
  tile of 40 of a local expert's received rows of nonzero row weight across
  the slabs (:func:`live_rows`; a row of weight 0 is stored as +0, what the
  block gives it), and stores each result row into its source rank's
  combine buffer. Its plain version is the mesh's host all-to-all around
  the one-rank block's plain version.
- ``fused_dispatch_gemm`` replaces ``_kernel`` (``pl.pallas_call`` at
  fused_moe.py:185): the dispatch's one-sided pushes into an expert-major
  receive region, then the masked kernel's Hopper body (csrc/gemm_sm90.cuh
  ``widen_body``) over each local expert's D x cap received rows as one
  group, its row tiles spanning slabs, each item waiting only for the slabs
  it reads; bitwise the masked kernel on ``recv``.
"""

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .. import envs
from ..heuristics.arch import H100_SXM
from ..heuristics.configs import get_sm90_config
from ..parallel import dist
from ..runtime import build
from ..utils.math import (_dequantize_from_fp4_e2m1, align, per_token_cast_to_fp8,
                          unpack_fp4_planar)
from .common import check_operand, count_launch, promote_block, use_plain
from .grouped import masked_gemm_plain

# Kernel launches per instance since the counts were last set to 0: the
# one-rank block, the general (expert-parallel) kernel, the fused dispatch
# + L1 GEMM.
launches = {'bf16': 0, 'fp8': 0, 'fp8_act_fp8': 0, 'fp4': 0, 'fp4_act_fp8': 0}
ep_launches = dict(launches)
dispatch_launches = {'bf16': 0, 'fp8': 0}

TILE = 128              # the kernel's L1 (gate and up each) and L2 tile width
GRAN_K = 128
# Upcast at most this many bytes of f32 weights at once in the plain version.
_PLAIN_CHUNK_BYTES = 1 << 31


def _entry():
    fn = build.load('mega_local').dgt_mega_local
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


ROWS = 40               # token rows of an item (wgmma's N)
STAGES = 3              # the ring


def _align1024(v: int) -> int:
    return (v + 1023) // 1024 * 1024


def smem_bytes(inter: int) -> int:
    """Shared memory of one block (csrc/mega_sm90.cuh:smem_bytes): the
    3-stage ring (256 weight rows, a 16-bit token tile of two boxes of 40
    rows, the box where e4m3 rows land, their scales; 128 bytes of k a row),
    the amax partials of 8 warps (two sets), row weights, result rows,
    barriers, then act's scales [40, I/128], whose room every instance
    keeps."""
    stage = _align1024(256 * 128 + 3 * ROWS * 128 + 256)
    fixed = (1024 + STAGES * stage + 2 * 8 * ROWS * 4 + ROWS * 4 + ROWS * 8
             + (3 * STAGES + 2) * 8)
    return fixed + ROWS * (inter // 128) * 4


def scratch_bytes(rows: int, hidden: int, inter: int, *, scaled: bool, act_fp8: bool) -> int:
    """The kernels' scratch for ``rows`` token rows (:data:`ROWS` a block;
    csrc/mega_sm90.cuh:scratch_bytes): act [rows, I] (bf16, e4m3 with fp8
    act), the gathered rows [rows, H] (e4m3, bf16 unscaled) and their
    scales k-first."""
    return rows * ((1 if act_fp8 else 2) * inter + (1 if scaled else 2) * hidden
                   + 4 * (hidden // 128))


def items(num_experts: int, cap: int) -> int:
    """The one-rank kernel's work items: each expert's ``cap`` slot rows in
    tiles of :data:`ROWS`, each streaming the expert's weights once (the
    general kernel's are :func:`live_rows`')."""
    return num_experts * -(-cap // ROWS)


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
    VMEM-budgeted ``pick_mega_tiles`` there is one tile, 128 columns of gate
    and of up for L1, 256 output columns for L2 (the last one cut at
    ``hidden``), so JAX's divisor contract (``inter % bn1 == 0``, ``hidden %
    bh2 == 0``, ``bn1 % 128 == 0`` when scaled) is that both widths are
    multiples of 128 (256 for planar FP4, which packs 256-code groups), and
    a block's ring and act scales must fit the H100's 227 KB (intermediate
    up to 64640)."""
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
    pool: int = 1            # the general kernel's wave pool (pick_wave_pool)


def pack_mega_weights(w1: torch.Tensor, w2: torch.Tensor, w1_sf=None, w2_sf=None, *,
                      cap: int = 0, x_dtype: torch.dtype = torch.float8_e4m3fn,
                      num_devices: int = 1, w_packed_fp4: bool = False,
                      act_fp8: Optional[bool] = None) -> MegaPackedWeights:
    """Pack the mega block's weights once. ``w_packed_fp4``: ``w1`` [E, 2I,
    H/2] and ``w2`` [E, H, I/2] are planar-128 FP4 codes (int8,
    utils/math.pack_fp4_planar) with their 128x128 block scales, decoded in
    the kernel. For ``num_devices`` > 1 the wave pool is chosen for the
    later calls' slot capacity ``cap`` and token type ``x_dtype``, as JAX
    does."""
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
    act_fp8 = resolve_act_fp8(act_fp8)
    pool = 1
    if num_devices > 1:
        if cap <= 0:
            raise ValueError('pack_mega_weights for several ranks needs cap, the slot capacity '
                             'the wave pool is chosen for')
        pool = pick_wave_pool(num_devices, cap, hidden, inter,
                              xb=torch.empty((), dtype=x_dtype).element_size(),
                              wb=w1.element_size(), scaled=w1_sf is not None, act_fp8=act_fp8)
    f32 = lambda t: None if t is None else t.float().contiguous()
    return MegaPackedWeights(w1=w1.contiguous(), w2=w2.contiguous(), w1_sf=f32(w1_sf),
                             w2_sf=f32(w2_sf), w_fp4=w_packed_fp4, act_fp8=act_fp8, pool=pool)


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
    # the scratch: ROWS rows a block (one block an SM at most), each block
    # writing and reading back its own rows only
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(items(e_count, cap), sms)
    act = torch.empty(scratch_bytes(blocks * ROWS, hidden, inter, scaled=scaled,
                                    act_fp8=act_fp8), dtype=torch.uint8, device=x.device)
    kind = 2 if w_fp4 else int(scaled)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _entry()(x.data_ptr(), ptr(xsf), rw.data_ptr(), w1.data_ptr(), ptr(w1_sf),
                    w2.data_ptr(), ptr(w2_sf), act.data_ptr(), y.data_ptr(), e_count, cap,
                    hidden, inter,
                    kind, int(act_fp8), int(silu_tanh), float(clamp),
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(build.load('mega_local'), code, 'mega_local')
    count_launch(launches, instance_name(scaled, w_fp4, act_fp8))
    return y


def instance_name(scaled: bool, w_fp4: bool, act_fp8: bool) -> str:
    """The key of :data:`launches` for one instance."""
    if not scaled:
        return 'bf16'
    return ('fp4' if w_fp4 else 'fp8') + ('_act_fp8' if act_fp8 else '')




# ---- the wave pool and the tile rule of the general kernel -----------------

def _mega_vmem_bytes(b1: int, b2: int, *, hidden: int, inter: int, rows: int, xb: int, wb: int,
                     scaled: bool, gran_k: int, local: bool, act_fp8: bool = True) -> int:
    """JAX's working-set model of a mega tile pair (fused_moe.py:825-843):
    weight tiles at ``b1`` / ``b2`` double-buffered, ``rows`` token rows of
    x, act and y, and their scales."""
    e = (2 * b1 * hidden * wb) * 2
    e += (b2 * inter * wb) * 2
    e += rows * hidden * xb * (2 if local else 1)
    e += rows * inter * (1 if scaled and act_fp8 else 2)
    e += 2 * rows * b2 * 2
    if scaled:
        ksf1 = ((hidden // gran_k + 127) // 128) * 128
        e += rows * ksf1 * 4 * (2 if local else 1) \
            + ((inter // gran_k) * rows * 4 if act_fp8 else 0)
        e += 2 * (hidden // gran_k) * b1 * 4 * 2
        e += (inter // gran_k) * b2 * 4 * 2
    return e


def pick_mega_tiles(hidden: int, inter: int, cap: int, *, xb: int, wb: int, scaled: bool,
                    gran_k: int = 128, block_n: int = 0, block_h: int = 0, budget: int = 0,
                    local: bool = False, pool: int = 1, act_fp8: bool = True):
    """JAX's (bn1, bh2) rule (fused_moe.py:846-930): the widest divisor tiles
    whose working set at ``pool * cap`` rows fits the budget, powers of two
    first. The CUDA kernels have one tile, 128 wide (``check_shape``); the
    rule is kept as the model :func:`pick_wave_pool` sizes a pool with.
    (JAX's ``DGT_MEGA_TILES`` pin is not carried over.)"""
    if block_n <= 0:
        block_n = 256
    if block_h <= 0:
        block_h = 1024 if local else 256
    if budget <= 0:
        budget = 15 * 1024 * 1024 if local else 10 * 1024 * 1024 + 512 * 1024
    bn1 = block_n if inter % block_n == 0 else inter
    bh2 = block_h if hidden % block_h == 0 else hidden
    if scaled:
        assert bn1 % gran_k == 0, bn1

    def est(b1, b2):
        return _mega_vmem_bytes(b1, b2, hidden=hidden, inter=inter, rows=pool * cap, xb=xb,
                                wb=wb, scaled=scaled, gran_k=gran_k, local=local,
                                act_fp8=act_fp8)

    def shrink_div(cur, total, quantum):
        p2 = 1 << (cur - 1).bit_length() - 1          # largest power of two below cur
        while p2 >= quantum:
            if p2 % quantum == 0 and total % p2 == 0:
                return p2
            p2 //= 2
        for cand in range(cur - quantum, quantum - 1, -quantum):
            if total % cand == 0:
                return cand
        return None

    q1 = gran_k if scaled else 128
    while est(bn1, bh2) > budget:
        s1 = shrink_div(bn1, inter, q1) if bn1 % q1 == 0 else None
        s2 = shrink_div(bh2, hidden, 128) if bh2 % 128 == 0 else None
        if s1 is not None and (s2 is None or bn1 * 2 * hidden >= bh2 * inter):
            bn1 = s1
        elif s2 is not None:
            bh2 = s2
        else:
            break
    assert inter % bn1 == 0 and hidden % bh2 == 0, (bn1, bh2, inter, hidden)
    return bn1, bh2


def pick_wave_pool(num_devices: int, cap: int, hidden: int, inter: int, *, xb: int, wb: int,
                   scaled: bool, gran_k: int = 128, block_n: int = 0, block_h: int = 0,
                   act_fp8: bool = True) -> int:
    """The general kernel's wave pool P (fused_moe.py:933-981, JAX's rule):
    the largest of 4 and 2 that divides D, keeps ``P * cap`` within 1024
    rows and keeps the pooled working set within budget; else 1.
    ``DGT_MEGA_POOL`` pins it. The CUDA kernel takes and validates it, but
    its items are tiles of an expert's received rows across every slab, so
    every pool gives the same launch and the same bits."""
    pin = envs.mega_pool()
    if pin:
        p = int(pin)
        if p < 1 or num_devices % p:
            raise ValueError(f'DGT_MEGA_POOL={pin}: a divisor of the rank count {num_devices}')
        return p
    budget = 9 * 1024 * 1024
    for p in (4, 2):
        if p > num_devices or num_devices % p or p * cap > 1024:
            continue
        bn1, bh2 = pick_mega_tiles(hidden, inter, cap, xb=xb, wb=wb, scaled=scaled,
                                   gran_k=gran_k, block_n=block_n, block_h=block_h, local=False,
                                   pool=p, act_fp8=act_fp8)
        if _mega_vmem_bytes(bn1, bh2, hidden=hidden, inter=inter, rows=p * cap, xb=xb, wb=wb,
                            scaled=scaled, gran_k=gran_k, local=False,
                            act_fp8=act_fp8) <= budget:
            return p
    return 1


# ---- the general (expert-parallel) mega kernel ------------------------------

def _ep_lib():
    lib = build.load('mega_ep')
    if lib.dgt_mega_ep.argtypes is None:
        lib.dgt_mega_ep.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_longlong] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_void_p, ctypes.c_void_p])
        lib.dgt_mega_ep.restype = ctypes.c_int
        lib.dgt_dispatch_gemm.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong]
            + [ctypes.c_int] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
        lib.dgt_dispatch_gemm.restype = ctypes.c_int
    return lib


def _slab_layout(d_dim: int, e_local: int, cap: int, hidden: int, xb: int, scaled: bool):
    """Byte layout of a receive buffer: D token slots, then D scale slots,
    each 128-byte aligned (no cache line holds bytes of two slabs). Returns
    (x_stride, sf_stride, sf_region, end)."""
    x_stride = align(e_local * cap * hidden * xb, 128)
    sf_stride = align(e_local * cap * (hidden // GRAN_K) * 4, 128) if scaled else 0
    sf_region = d_dim * x_stride
    return x_stride, sf_stride, sf_region, sf_region + d_dim * sf_stride


def live_rows(rw_steps: torch.Tensor):
    """The general kernel's items from the row weights [D, E, cap] (step
    order): the rows of weight 0 are left out (stored as +0, what the block
    gives them). Returns (order [E, D cap] int32: each local expert's
    received rows q = step cap + slot, those of nonzero weight first, both
    in step order; counts [E] int32 of those; prefix [E + 1] int32: each
    expert's first item, a tile of :data:`ROWS` of its live rows, the total
    last)."""
    d_dim, e_local, cap = rw_steps.shape
    live = (rw_steps != 0).permute(1, 0, 2).reshape(e_local, d_dim * cap)
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    counts = live.sum(1, dtype=torch.int32)
    prefix = torch.zeros(e_local + 1, dtype=torch.int32, device=rw_steps.device)
    prefix[1:] = torch.cumsum((counts + ROWS - 1) // ROWS, 0)
    return order, counts, prefix


def _my_rank(axis_name: str) -> int:
    return dist.axis_index(axis_name) if dist.in_mesh() else 0


def _a2a(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return dist.all_to_all(x, axis_name) if dist.in_mesh() else x


def mega_ep_plain(send_x, send_sf, rw_steps, w1, w1_sf, w2, w2_sf, *, pool=1, w_fp4=False,
                  act_fp8=False, silu_tanh=False, clamp=256.0, axis_name='ep') -> torch.Tensor:
    """The general kernel's function: the dispatch all-to-all, the one-rank
    block on each step's slab (step s: the slab from rank (my - s) mod D,
    with row weights ``rw_steps[s]``), the combine all-to-all. ``pool``
    moves no bit."""
    del pool
    d_dim = send_x.shape[0]
    my = _my_rank(axis_name)
    recv = _a2a(send_x, axis_name)
    recv_sf = None if send_sf is None else _a2a(send_sf, axis_name)
    ystage = torch.empty(send_x.shape, dtype=torch.bfloat16, device=send_x.device)
    for s in range(d_dim):
        src = (my - s) % d_dim
        ystage[src] = mega_local_plain(recv[src], None if recv_sf is None else recv_sf[src],
                                       rw_steps[s], w1, w1_sf, w2, w2_sf, w_fp4=w_fp4,
                                       act_fp8=act_fp8, silu_tanh=silu_tanh, clamp=clamp)
    return _a2a(ystage, axis_name)


def mega_ep(send_x: torch.Tensor, send_sf: Optional[torch.Tensor], rw_steps: torch.Tensor,
            w1: torch.Tensor, w1_sf: Optional[torch.Tensor], w2: torch.Tensor,
            w2_sf: Optional[torch.Tensor], *, pool: int = 1, w_fp4: bool = False,
            act_fp8: bool = False, silu_tanh: bool = False, clamp: float = 256.0,
            axis_name: str = 'ep') -> torch.Tensor:
    """combine [D, E, cap, H] bf16 of the general mega kernel, inside
    ``Mesh.map``: combine[d, e] is what rank d computed for the tokens this
    rank sent to its expert e. ``send_x`` [D, E, cap, H] (e4m3 with
    ``send_sf`` [D, E, cap, H/128] f32, or bf16), ``rw_steps`` [D, E, cap]
    f32 in step order, weights as :func:`mega_local` takes them.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    kw = dict(pool=pool, w_fp4=w_fp4, act_fp8=act_fp8, silu_tanh=silu_tanh, clamp=clamp,
              axis_name=axis_name)
    if use_plain(send_x, send_sf, rw_steps, w1, w1_sf, w2, w2_sf):
        return mega_ep_plain(send_x, send_sf, rw_steps, w1, w1_sf, w2, w2_sf, **kw)
    mesh, rank = dist.current()
    d_dim, e_local, cap, hidden = send_x.shape
    if d_dim != mesh.size or dist.axis_size(axis_name) != d_dim:
        raise NotImplementedError(f'the mega kernel spans the whole mesh ({mesh.size} ranks); '
                                  f'send_x has {d_dim} slabs')
    if pool < 1 or d_dim % pool:
        raise ValueError(f'pool {pool}: a divisor of the rank count {d_dim}')
    inter = w1.shape[1] // 2
    scaled = send_sf is not None
    if not scaled and (w_fp4 or act_fp8):
        raise ValueError('FP4 weights and fp8 act go with scaled (e4m3) operands')
    check_shape(hidden, inter, w_fp4=w_fp4)
    wk = 2 if w_fp4 else 1
    x_type = torch.float8_e4m3fn if scaled else torch.bfloat16
    w_type = torch.int8 if w_fp4 else x_type
    check_operand(send_x, 'send_x', x_type, (d_dim, e_local, cap, hidden))
    check_operand(rw_steps, 'rw_steps', torch.float32, (d_dim, e_local, cap))
    check_operand(w1, 'w1', w_type, (e_local, 2 * inter, hidden // wk))
    check_operand(w2, 'w2', w_type, (e_local, hidden, inter // wk))
    if scaled:
        if w1_sf is None or w2_sf is None:
            raise ValueError('scaled operands need w1_sf and w2_sf')
        check_operand(send_sf, 'send_sf', torch.float32, (d_dim, e_local, cap, hidden // GRAN_K))
        check_operand(w1_sf, 'w1_sf', torch.float32, (e_local, 2 * inter // 128, hidden // 128))
        check_operand(w2_sf, 'w2_sf', torch.float32, (e_local, hidden // 128, inter // 128))
    elif w1_sf is not None or w2_sf is not None:
        raise ValueError('scales go with e4m3 operands only')
    if min(e_local, cap) == 0:
        raise ValueError(f'the kernel takes non-empty shapes; got E={e_local}, cap={cap}')
    x_stride, sf_stride, sf_region, end = _slab_layout(d_dim, e_local, cap, hidden,
                                                       send_x.element_size(), scaled)
    y_region = align(end, 128)
    y_bytes = d_dim * e_local * cap * hidden * 2
    buf = dist.symmetric('mega', y_region + y_bytes)
    blocks = mesh.comm_blocks()
    act = torch.empty(scratch_bytes(blocks * ROWS, hidden, inter, scaled=scaled,
                                    act_fp8=act_fp8), dtype=torch.uint8, device=send_x.device)
    order, counts, prefix = live_rows(rw_steps)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _ep_lib()
    from ..parallel.collectives import launch_spinning
    launch_spinning(lib, 'mega_ep', buf, lambda *comm: lib.dgt_mega_ep(
        send_x.data_ptr(), ptr(send_sf), rw_steps.data_ptr(), w1.data_ptr(), ptr(w1_sf),
        w2.data_ptr(), ptr(w2_sf), act.data_ptr(), order.data_ptr(), counts.data_ptr(),
        prefix.data_ptr(), e_local, cap, hidden, inter, pool,
        2 if w_fp4 else int(scaled), int(act_fp8), int(silu_tanh), float(clamp), x_stride,
        sf_stride, sf_region, y_region, *comm))
    count_launch(ep_launches, instance_name(scaled, w_fp4, act_fp8))
    # the combine region outlives the call: the next call may store into it
    # once this rank has entered that call
    return buf.data[y_region:y_region + y_bytes].view(torch.bfloat16) \
        .view(d_dim, e_local, cap, hidden).clone()


def fused_mega_moe(send_x: torch.Tensor, rw_steps: torch.Tensor,
                   w1: Optional[torch.Tensor] = None, w2: Optional[torch.Tensor] = None,
                   axis_name: str = 'ep', *, send_sf: Optional[torch.Tensor] = None,
                   w1_sf=None, w2_sf=None, clamp: float = 256.0,
                   packed: Optional[MegaPackedWeights] = None, force_general: bool = False,
                   pool: int = 0, act_fp8: Optional[bool] = None) -> torch.Tensor:
    """The fused mega MoE (JAX's ``fused_mega_moe``): inside ``Mesh.map``
    over ``axis_name`` for D ranks, or outside a mesh at one rank.

    ``send_x`` [D, E, cap, H]: slab d holds the tokens this rank routes to
    rank d (bf16, or e4m3 with per-token ``send_sf`` [D, E, cap, >= H/128]
    f32); ``rw_steps`` [D, E, cap] f32 in processing-step order (step s:
    the tokens from rank (my - s) mod D); weights raw (``w1`` [E, 2I, H]
    gate rows first, ``w2`` [E, H, I], fp8 with 128x128 block scales or
    bf16, packed in the call) or ``packed`` (:func:`pack_mega_weights`,
    whose act type and pool win; a different ``pool`` raises). Returns
    ``combine`` [D, E, cap, H] bf16, combine[d, e] being rank d's results
    for the tokens this rank sent to (d, e): the layout of the unfused
    path's reverse all-to-all.

    At one rank without ``force_general`` the one-rank kernel runs; else
    the general kernel; ``pool`` (``pick_wave_pool``, ``DGT_MEGA_POOL``) is
    JAX's wave pool, validated and kept: it moves no bit."""
    d_dim, e_local, cap, hidden = send_x.shape
    num_devices = dist.axis_size(axis_name) if dist.in_mesh() else 1
    if d_dim != num_devices:
        raise ValueError(f'send_x has {d_dim} slabs for {num_devices} ranks')
    scaled = send_sf is not None
    if packed is None:
        packed = pack_mega_weights(w1, w2, w1_sf, w2_sf, cap=cap, x_dtype=send_x.dtype,
                                   num_devices=num_devices, act_fp8=act_fp8)
        pool = pool if pool > 0 else packed.pool
    else:
        if pool > 0 and pool != packed.pool:
            raise ValueError(f'pool {pool}: the weights were packed for pool {packed.pool}')
        pool = packed.pool
    if d_dim % pool:
        raise ValueError(f'pool {pool}: a divisor of the rank count {d_dim}')
    assert scaled == (packed.w1_sf is not None), 'the weights\' SF presence must match send_sf'
    assert packed.w1.shape[0] == e_local, (packed.w1.shape, e_local)
    act_fp8 = scaled and packed.act_fp8
    xsf = None
    if scaled:
        xsf = send_sf[..., :hidden // GRAN_K].float().contiguous()
    # silu's form is the instance's, as in JAX's _l1_epilogue: tanh with bf16 act
    kw = dict(w_fp4=packed.w_fp4, act_fp8=act_fp8, silu_tanh=scaled and not act_fp8,
              clamp=clamp)
    weights = (packed.w1, packed.w1_sf, packed.w2, packed.w2_sf)
    if num_devices == 1 and not force_general:
        y = mega_local(send_x[0].contiguous(), None if xsf is None else xsf[0],
                       rw_steps[0].float().contiguous(), *weights[:2], *weights[2:], **kw)
        return y[None]
    return mega_ep(send_x.contiguous(), xsf, rw_steps.float().contiguous(), *weights, pool=pool,
                   axis_name=axis_name, **kw)


# ---- the fused dispatch + L1 GEMM -------------------------------------------

def dispatch_gemm_plain(send_x, w, send_sf=None, w_sf=None, axis_name='ep'):
    """The kernel's function: the all-to-all, then the masked kernel's plain
    version on every slab. Returns (out [E, D, cap, N] bf16, recv)."""
    d_dim, e_local, cap, hidden = send_x.shape
    recv = _a2a(send_x, axis_name)
    a = recv.transpose(0, 1).reshape(e_local, d_dim * cap, hidden)
    sfa = None
    if send_sf is not None:
        sfa = _a2a(send_sf, axis_name).transpose(0, 1).reshape(e_local, d_dim * cap, -1)
    out = masked_gemm_plain(a, w, None, sfa=sfa, sfb=w_sf)
    return out.view(e_local, d_dim, cap, w.shape[1]), recv


def fused_dispatch_gemm(send_x: torch.Tensor, w: torch.Tensor, axis_name: str = 'ep',
                        block_n: int = 256, collective_id: int = 7,
                        send_sf: Optional[torch.Tensor] = None,
                        w_sf: Optional[torch.Tensor] = None):
    """Fused dispatch + L1 expert GEMM (JAX's ``fused_dispatch_gemm``),
    inside ``Mesh.map`` over ``axis_name`` (or outside a mesh at one rank).

    ``send_x`` [D, E, cap, H]: slab d holds the tokens this rank routes to
    rank d; ``w`` [E, N, H]. FP8: ``send_x`` e4m3 with per-token
    ``send_sf`` [D, E, cap, >= H/128] f32 (pushed beside the tokens) and
    ``w_sf`` [E, N/128, H/128] f32. Returns (out [E, D, cap, N] bf16 in
    source-rank order, out[e, src] = recv[src, e] . w[e]^T; recv [D, E,
    cap, H], the tokens received). ``block_n`` and ``collective_id`` are
    JAX's tiling and barrier names; the kernel's tile is 128 wide (64 or
    128 rows, :func:`get_sm90_config`) and its buffer the mesh's
    'dispatch'."""
    del block_n, collective_id
    d_dim, e_local, cap, hidden = send_x.shape
    num_devices = dist.axis_size(axis_name) if dist.in_mesh() else 1
    if d_dim != num_devices:
        raise ValueError(f'send_x has {d_dim} slabs for {num_devices} ranks')
    scaled = send_sf is not None
    if scaled:
        send_sf = send_sf[..., :hidden // GRAN_K].float().contiguous()
        w_sf = w_sf.float().contiguous()
    if use_plain(send_x, w, send_sf, w_sf):
        return dispatch_gemm_plain(send_x, w, send_sf, w_sf, axis_name)
    mesh, rank = dist.current()
    if d_dim != mesh.size:
        raise NotImplementedError(f'the dispatch kernel spans the whole mesh ({mesh.size} '
                                  f'ranks); send_x has {d_dim} slabs')
    n = w.shape[1]
    if hidden % 128 or n % 128:
        raise ValueError(f'hidden {hidden} and N {n} must be multiples of 128')
    x_type = torch.float8_e4m3fn if scaled else torch.bfloat16
    send_x = send_x.contiguous()
    check_operand(send_x, 'send_x', x_type, (d_dim, e_local, cap, hidden))
    check_operand(w, 'w', x_type, (e_local, n, hidden))
    if scaled:
        check_operand(send_sf, 'send_sf', torch.float32, (d_dim, e_local, cap, hidden // 128))
        check_operand(w_sf, 'w_sf', torch.float32, (e_local, n // 128, hidden // 128))
    elif w_sf is not None:
        raise ValueError('w_sf goes with e4m3 operands only')
    if min(e_local, cap) == 0:
        raise ValueError(f'the kernel takes non-empty shapes; got E={e_local}, cap={cap}')
    # the receive region, expert-major: tokens [E, D, cap, H], then their
    # scales k-first [E, H/128, D cap rounded up to 4] (each sender's slab
    # laid out k-first here, [E, H/128, cap], for the push); an expert's D
    # cap received rows are one group of the kernel's A
    rows, ksf, xb = d_dim * cap, hidden // GRAN_K, send_x.element_size()
    sfa_ld, sfb_ld = align(rows, 4), align(n // 128, 4)
    x_bytes = e_local * rows * hidden * xb
    if e_local * cap * hidden * xb >= 1 << 32:
        raise ValueError(f'a slab of {e_local * cap * hidden * xb} bytes: the push copies under '
                         f'2^32 bytes a slab')
    sf_region = align(x_bytes, 128)
    buf = dist.symmetric('dispatch', sf_region + (e_local * ksf * sfa_ld * 4 if scaled else 0))
    send_sf_k = scratch = None
    if scaled:
        send_sf_k = send_sf.transpose(2, 3).contiguous()
        scratch = torch.empty(e_local * ksf * sfb_ld, dtype=torch.float32, device=send_x.device)
    cfg = get_sm90_config(rows, n, e_local, masked=True, elem=xb)
    out = torch.empty((e_local, d_dim, cap, n), dtype=torch.bfloat16, device=send_x.device)
    recv = torch.empty_like(send_x)
    lib = _ep_lib()
    from ..parallel.collectives import launch_spinning
    ptr = lambda t: None if t is None else t.data_ptr()
    launch_spinning(lib, 'dispatch_gemm', buf, lambda *comm: lib.dgt_dispatch_gemm(
        send_x.data_ptr(), ptr(send_sf_k), w.data_ptr(), ptr(w_sf), ptr(scratch), out.data_ptr(),
        buf.data.data_ptr(), e_local, cap, n, hidden, sfa_ld, sfb_ld, sf_region, cfg.block_m,
        cfg.num_stages, *comm))
    count_launch(dispatch_launches, 'fp8' if scaled else 'bf16')
    recv.copy_(buf.data[:x_bytes].view(x_type).view(e_local, d_dim, cap, hidden).transpose(0, 1))
    return out, recv
