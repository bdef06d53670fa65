"""The mega MoE pipeline over the ranks of an expert-parallel mesh.
Counterpart of deepgemm_tpu/parallel/mega.py:111-330; runs inside
``Mesh.map`` over ``axis_name`` (parallel/dist.py), or outside a mesh at
one rank.

'xla' and 'pallas': the chunked pipeline. The per-(rank, expert) slots are
split into ``num_chunks`` chunks (heuristics/mega.py when None); chunk c's
dispatch all-to-alls are issued before chunk c-1's expert GEMMs (masked
kernel, SwiGLU, masked kernel) and its combine all-to-all. 'xla' moves the
chunks by the mesh's host all-to-all (JAX's XLA collective), 'pallas' by
the one-sided all-to-all kernel (parallel/collectives.py, csrc/a2a.cu).
Both move bits verbatim and every slot row's GEMMs depend on that row
alone, so both are bitwise the unfused ``ep_moe_forward``. At one rank
outside a mesh the all-to-alls are the identity and nothing is left for
chunks to hide: 'xla' is ``ep_moe_forward`` itself (``num_chunks`` moves
no bit), and 'pallas', which moves bytes between ranks, needs a mesh.

'fused': each token is quantized once (per token, before the dispatch;
empty slots keep unit scales), the row weights travel by the host
all-to-all permuted to processing-step order, and the fused kernel
(kernels/fused_moe.fused_mega_moe: csrc/mega_local.cu at one rank,
csrc/mega_ep.cu across ranks) runs dispatch, the expert block and the
combine push in one launch a rank. Every path combines in pair order.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from ..heuristics.mega import get_mega_moe_config
from ..kernels.fused_moe import MegaPackedWeights, fused_mega_moe
from ..utils.math import ceil_div, per_token_cast_to_fp8
from . import dist
from .collectives import pallas_all_to_all
from .moe import (MoEConfig, _expert_gemm, combine_pairs, dispatch_indices, ep_moe_forward,
                  ep_size, moe_capacity, scatter_to_slots, swiglu_apply_weight)

# Slot alignment of the per-(rank, expert) capacity (the analog of
# get_token_alignment_for_mega_moe).
TOKEN_ALIGNMENT = 8


def get_token_alignment_for_mega_moe() -> int:
    """Tokens-per-expert counts are padded to this multiple."""
    return TOKEN_ALIGNMENT


def get_ring_limit_for_mega_moe(num_local_experts: int, chunk_rows: int,
                                num_inflight_chunks: int = 2) -> int:
    """Token rows in flight per local expert: the chunk staging buffers the
    pipeline keeps live."""
    return chunk_rows * num_inflight_chunks * num_local_experts


def get_symm_buffer_size_for_mega_moe(
        num_ranks: int, num_experts: int, hidden: int, intermediate: int,
        num_max_tokens_per_rank: int, topk: int, capacity_factor: float = 1.5,
        num_chunks: int = 4, use_fp8: bool = True) -> Tuple[int, dict]:
    """Bytes of the pipeline's staging buffers and their named
    ``(start, end)`` slices, the JAX package's accounting exactly."""
    e_local = num_experts // num_ranks
    cap = moe_capacity(num_max_tokens_per_rank, topk, num_experts, capacity_factor)
    cc = ceil_div(cap, num_chunks)
    x_bytes = 1 if use_fp8 else 2
    sf_bytes = 4 * ceil_div(hidden, 128) if use_fp8 else 0
    slices, offset = {}, 0

    def add(name, nbytes):
        nonlocal offset
        slices[name] = (offset, offset + nbytes)
        offset += nbytes

    add('dispatch_send', 2 * num_ranks * e_local * cc * (hidden * x_bytes + sf_bytes))
    add('dispatch_recv', 2 * num_ranks * e_local * cc * (hidden * x_bytes + sf_bytes))
    add('row_weights', 2 * 2 * num_ranks * e_local * cc * 4)
    add('l1_ring', 2 * e_local * num_ranks * cc * (2 * intermediate) * 4)
    add('combine_send', 2 * num_ranks * e_local * cc * hidden * 2)
    add('combine_recv', 2 * num_ranks * e_local * cc * hidden * 2)
    return offset, slices


@dataclasses.dataclass
class SymmBuffer:
    """The sizing of the staging buffers as an object (the reference's
    ``deep_gemm.mega.SymmBuffer``). ``rendezvous`` inside ``Mesh.map``
    allocates this rank's buffer of ``size`` bytes and its signal pad and
    exchanges the address table with every rank (``symm``: this rank's
    view, parallel/dist.SymmetricBuffer), as the fused mega kernel's buffer
    'mega', which the kernel grows at its first call if it needs more;
    outside a mesh nothing is exchanged and it returns the buffer itself."""
    num_ranks: int
    num_experts: int
    hidden: int
    intermediate: int
    num_max_tokens_per_rank: int
    topk: int
    capacity_factor: float = 1.5
    num_chunks: int = 4
    use_fp8: bool = True

    def __post_init__(self):
        self.size, self.slices = get_symm_buffer_size_for_mega_moe(
            self.num_ranks, self.num_experts, self.hidden, self.intermediate,
            self.num_max_tokens_per_rank, self.topk, self.capacity_factor,
            self.num_chunks, self.use_fp8)

    symm: Optional[dist.SymmetricBuffer] = dataclasses.field(default=None, init=False,
                                                            repr=False)

    def rendezvous(self):
        if dist.in_mesh():
            self.symm = dist.symmetric('mega', self.size)
        return self


def transform_weights_for_mega_moe(w1: torch.Tensor, w1_sf: Optional[torch.Tensor] = None,
                                   gate_up_interleave: Optional[int] = 1):
    """Gate/up rows interleaved at ``gate_up_interleave`` granularity
    ([gate g rows, up g rows, ...]) -> the canonical concat [E, 2I, H],
    gate rows first, with the per-128-row block scales de-interleaved
    likewise (only for g % 128 == 0). ``None`` passes the weights through."""
    if gate_up_interleave is None:
        return w1, w1_sf
    g = gate_up_interleave
    e, i2, h = w1.shape
    inter = i2 // 2
    assert inter % g == 0, (inter, g)
    w1c = w1.reshape(e, inter // g, 2, g, h).transpose(1, 2).reshape(e, i2, h)
    sf = None
    if w1_sf is not None:
        assert g % 128 == 0, 'SF de-interleave requires granularity >= 128'
        gb = g // 128
        eb, nb, kb = w1_sf.shape
        sf = w1_sf.reshape(eb, nb // (2 * gb), 2, gb, kb).transpose(1, 2).reshape(eb, nb, kb)
    return w1c, sf


def _chunk_bounds(cap: int, num_chunks: int):
    """Chunk row ranges [(start, size), ...] covering [0, cap)."""
    cc = ceil_div(cap, num_chunks)
    bounds, start = [], 0
    while start < cap:
        size = min(cc, cap - start)
        bounds.append((start, size))
        start += size
    return bounds


def mega_moe_forward(x: torch.Tensor, topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                     w1, w1_sf, w2, w2_sf, cfg: MoEConfig, *,
                     num_chunks: Optional[int] = None, axis_name: str = 'ep',
                     comm: str = 'xla', packed_weights: Optional[MegaPackedWeights] = None):
    """The mega MoE forward; the contract of ``ep_moe_forward`` (x [T, H]
    bf16, topk_idx [T, K], topk_weights [T, K] f32, this rank's experts'
    w1 and w2 with block scales or bf16) -> (y [T, H] bf16, num_dropped
    [1]). ``comm``: 'xla', 'pallas' or 'fused' (see the module docstring);
    ``packed_weights`` (kernels/fused_moe.pack_mega_weights) in place of
    the weights for 'fused'."""
    if comm not in ('xla', 'pallas', 'fused'):
        raise ValueError(f"comm={comm!r}: 'xla', 'pallas' or 'fused'")
    if num_chunks is not None and num_chunks < 1:
        raise ValueError(f'num_chunks={num_chunks}: None or a positive count')
    in_mesh = dist.in_mesh()
    if comm == 'pallas' and not in_mesh:
        raise ValueError("comm='pallas' moves bytes between the ranks of a mesh: call it inside "
                         'Mesh.map (a mesh of one rank will do)')
    if comm == 'xla' and not in_mesh:
        return ep_moe_forward(x, topk_idx, topk_weights, w1, w1_sf, w2, w2_sf, cfg)

    t_count, hidden = x.shape
    k = topk_idx.shape[1]
    num_experts = cfg.num_experts
    ep = ep_size(axis_name)
    e_local = num_experts // ep
    cap = moe_capacity(t_count, k, num_experts, cfg.capacity_factor)
    expert, slot, kept, num_dropped = dispatch_indices(topk_idx, num_experts, cap)
    pair_w = topk_weights.reshape(-1).float()

    def a2a(v):
        if comm == 'pallas':
            return pallas_all_to_all(v, axis_name)
        return dist.all_to_all(v, axis_name) if ep > 1 else v

    if comm == 'fused':
        scaled = w1_sf is not None or (packed_weights is not None
                                       and packed_weights.w1_sf is not None)
        if scaled:
            xq, xsf = per_token_cast_to_fp8(x, use_ue8m0=False)
            send, send_w = scatter_to_slots(xq.view(torch.uint8), pair_w, expert, slot, kept,
                                            num_experts, cap, k)
            send = send.view(torch.float8_e4m3fn)
            # empty slots keep unit scales: their zero rows contribute nothing
            send_sf, _ = scatter_to_slots(xsf, pair_w, expert, slot, kept, num_experts, cap, k,
                                          fill_x=1.0)
            send_sf = send_sf.view(ep, e_local, cap, -1)
        else:
            send, send_w = scatter_to_slots(x, pair_w, expert, slot, kept, num_experts, cap, k)
            send_sf = None
        rw = a2a(send_w.view(ep, e_local, cap))
        if ep > 1:
            # the row weights in processing-step order: step s holds rank (my - s)'s
            my = dist.axis_index(axis_name)
            rw = rw[[(my - s) % ep for s in range(ep)]]
        combine = fused_mega_moe(send.view(ep, e_local, cap, hidden), rw, w1, w2, axis_name,
                                 send_sf=send_sf, w1_sf=w1_sf, w2_sf=w2_sf,
                                 packed=packed_weights)
        # combine[d, e]: rank d's results for the tokens sent to (d, e), the
        # layout of the unfused path's reverse all-to-all
        return (combine_pairs(combine.view(num_experts, cap, hidden), expert, slot, kept,
                              t_count, k), num_dropped.reshape(1))

    if num_chunks is None:
        num_chunks = get_mega_moe_config(t_count, hidden, cfg.intermediate, num_experts, ep, k,
                                         cap, use_fp8=w1_sf is not None).num_chunks
    send_x, send_w = scatter_to_slots(x, pair_w, expert, slot, kept, num_experts, cap, k)
    send_x = send_x.view(ep, e_local, cap, hidden)
    send_w = send_w.view(ep, e_local, cap)
    bounds = _chunk_bounds(cap, num_chunks)

    def dispatch(start, size):
        return (a2a(send_x[:, :, start:start + size].contiguous()),
                a2a(send_w[:, :, start:start + size].contiguous()))

    def expert_and_combine(rx, rw, size):
        rows = ep * size
        a1 = rx.transpose(0, 1).reshape(e_local, rows, hidden)
        row_w = rw.transpose(0, 1).reshape(e_local, rows)
        gate_up = _expert_gemm(a1, w1, w1_sf, cfg)
        act = swiglu_apply_weight(gate_up, row_w).to(torch.bfloat16)
        y_exp = _expert_gemm(act, w2, w2_sf, cfg)
        return a2a(y_exp.view(e_local, ep, size, hidden).transpose(0, 1).contiguous())

    # chunk c's dispatch is issued before chunk c-1's expert GEMMs
    y_chunks = []
    pending = dispatch(*bounds[0])
    for c in range(1, len(bounds)):
        nxt = dispatch(*bounds[c])
        y_chunks.append(expert_and_combine(*pending, bounds[c - 1][1]))
        pending = nxt
    y_chunks.append(expert_and_combine(*pending, bounds[-1][1]))
    y_slots = torch.cat(y_chunks, dim=2)                   # [ep, E_local, cap, H]
    return (combine_pairs(y_slots.view(num_experts, cap, hidden), expert, slot, kept, t_count,
                          k), num_dropped.reshape(1))


def fp8_fp4_mega_moe(x, topk_idx, topk_weights, w1, w1_sf, w2, w2_sf, cfg: MoEConfig, *,
                     num_chunks: Optional[int] = None, axis_name: str = 'ep'):
    """FP8 mega MoE (the reference's ``fp8_fp4_mega_moe``): FP8 weights with
    128x128 block scales."""
    assert w1_sf is not None and w2_sf is not None
    return mega_moe_forward(x, topk_idx, topk_weights, w1, w1_sf, w2, w2_sf, cfg,
                            num_chunks=num_chunks, axis_name=axis_name)


def bf16_mega_moe(x, topk_idx, topk_weights, w1, w2, cfg: MoEConfig, *,
                  num_chunks: Optional[int] = None, axis_name: str = 'ep'):
    """BF16 mega MoE (the reference's ``bf16_mega_moe``)."""
    return mega_moe_forward(x, topk_idx, topk_weights, w1, None, w2, None, cfg,
                            num_chunks=num_chunks, axis_name=axis_name)
