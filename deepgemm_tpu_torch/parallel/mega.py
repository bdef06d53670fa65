"""Mega MoE at one rank: the unfused expert pipeline ('xla') and the fused
expert-block kernel ('fused'). Counterpart of deepgemm_tpu/parallel/mega.py.

At one rank the all-to-alls of the JAX pipeline are the identity and
nothing is left for its chunks to hide: every slot row's GEMMs depend on
that row alone, so the chunked loop gives the bits of one pass, and 'xla'
is ``ep_moe_forward`` (the masked kernel, SwiGLU, the masked kernel).
``num_chunks`` is checked and has no other effect here; the chunked loop
and its policy come with the all-to-alls (ROADMAP.md, the multi-GPU tier).
'fused' quantizes each token once (per token, before the dispatch; empty
slots keep unit scales), runs the whole expert block in one launch of
csrc/mega_local.cu and combines in pair order, as ``ep_moe_forward`` does.

``comm='pallas'`` (the one-sided all-to-all, kernel #15) and more than one
rank are the multi-GPU tier of ROADMAP.md; they raise.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.fused_moe import MegaPackedWeights, fused_mega_moe
from ..utils.math import ceil_div, per_token_cast_to_fp8
from .moe import (MoEConfig, combine_pairs, ep_dispatch_indices, ep_moe_forward, moe_capacity,
                  scatter_to_slots)

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
    ``deep_gemm.mega.SymmBuffer``); at one rank nothing is exchanged, so
    ``rendezvous`` returns the buffer itself."""
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

    def rendezvous(self):
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


def mega_moe_forward(x: torch.Tensor, topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                     w1, w1_sf, w2, w2_sf, cfg: MoEConfig, *,
                     num_chunks: Optional[int] = None, comm: str = 'xla',
                     packed_weights: Optional[MegaPackedWeights] = None):
    """The mega MoE forward at one rank; the contract of ``ep_moe_forward``
    (x [T, H] bf16, topk_idx [T, K], topk_weights [T, K] f32, per-expert w1
    and w2 with block scales or bf16) -> (y [T, H] bf16, num_dropped [1]).

    'xla': ``ep_moe_forward`` (``num_chunks``, None or positive, moves no
    bit at one rank). 'fused': the fused expert-block kernel, FP8 tokens
    cast per token before the dispatch; ``packed_weights``
    (kernels/fused_moe.pack_mega_weights) in place of the weights."""
    if comm not in ('xla', 'fused'):
        raise NotImplementedError(
            f"comm={comm!r}: 'pallas' is the one-sided all-to-all, ROADMAP.md's multi-GPU "
            "tier (kernel #15, parallel/collectives.py:_a2a_call of the JAX package)")
    if num_chunks is not None and num_chunks < 1:
        raise ValueError(f'num_chunks={num_chunks}: None or a positive count')
    if comm == 'xla':
        return ep_moe_forward(x, topk_idx, topk_weights, w1, w1_sf, w2, w2_sf, cfg)

    t_count = x.shape[0]
    k = topk_idx.shape[1]
    num_experts = cfg.num_experts
    cap = moe_capacity(t_count, k, num_experts, cfg.capacity_factor)
    _, local, slot, kept, num_dropped = ep_dispatch_indices(topk_idx, num_experts,
                                                            num_experts, cap)
    pair_w = topk_weights.reshape(-1).float()
    scaled = w1_sf is not None or (packed_weights is not None
                                   and packed_weights.w1_sf is not None)
    if scaled:
        xq, xsf = per_token_cast_to_fp8(x, use_ue8m0=False)
        send_q, rw = scatter_to_slots(xq.view(torch.uint8), pair_w, local, slot, kept,
                                      num_experts, cap, k)
        # empty slots keep unit scales: their zero rows contribute nothing
        send_sf, _ = scatter_to_slots(xsf, pair_w, local, slot, kept, num_experts, cap, k,
                                      fill_x=1.0)
        combine = fused_mega_moe(send_q.view(torch.float8_e4m3fn)[None], rw[None], w1, w2,
                                 send_sf=send_sf[None], w1_sf=w1_sf, w2_sf=w2_sf,
                                 packed=packed_weights)
    else:
        send_x, rw = scatter_to_slots(x, pair_w, local, slot, kept, num_experts, cap, k)
        combine = fused_mega_moe(send_x[None], rw[None], w1, w2, packed=packed_weights)
    return combine_pairs(combine[0], local, slot, kept, t_count, k), num_dropped.reshape(1)


def fp8_fp4_mega_moe(x, topk_idx, topk_weights, w1, w1_sf, w2, w2_sf, cfg: MoEConfig, *,
                     num_chunks: Optional[int] = None):
    """FP8 mega MoE (the reference's ``fp8_fp4_mega_moe``): FP8 weights with
    128x128 block scales."""
    assert w1_sf is not None and w2_sf is not None
    return mega_moe_forward(x, topk_idx, topk_weights, w1, w1_sf, w2, w2_sf, cfg,
                            num_chunks=num_chunks)


def bf16_mega_moe(x, topk_idx, topk_weights, w1, w2, cfg: MoEConfig, *,
                  num_chunks: Optional[int] = None):
    """BF16 mega MoE (the reference's ``bf16_mega_moe``)."""
    return mega_moe_forward(x, topk_idx, topk_weights, w1, None, w2, None, cfg,
                            num_chunks=num_chunks)
