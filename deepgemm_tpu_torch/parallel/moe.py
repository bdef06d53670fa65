"""Expert-parallel MoE layer: dispatch -> expert GEMMs -> combine.
Counterpart of deepgemm_tpu/parallel/moe.py:36-237.

Tokens are scattered into per-(rank, expert) capacity slots ``[ep,
E_local, cap, H]`` (``[E, cap, H]``: rank r owns experts r * E_local ..);
pairs past an expert's capacity are dropped, as in the static-shape JAX
plan. Inside ``Mesh.map`` over ``axis_name`` (parallel/dist.py) the slots
travel by the mesh's all-to-all (JAX's XLA collective), each rank runs its
local experts on the ep * cap rows it received, and the results travel
back by the reverse all-to-all. At one rank (outside a mesh, or a mesh
axis of 1) the all-to-alls are the identity and are skipped, so the bits
are those of the one-rank path. Nothing here syncs the host. At one rank
dispatch, SwiGLU and combine are differentiable, for the training step.
"""

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.grouped import masked_gemm
from ..ops.autograd import fp8_grouped_matmul
from ..utils.math import align, ceil_div, per_token_cast_to_fp8
from . import dist


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    hidden: int
    intermediate: int
    topk: int
    capacity_factor: float = 1.5
    use_fp8: bool = True
    # True: the expert GEMMs go through the masked kernel (inference), whose
    # wrapper takes its plain version for CPU tensors. False: the
    # differentiable path, a bf16 einsum in f32, as the JAX package's XLA
    # path. (Holding the kernels against their plain versions on the card
    # is kernels.common.plain_versions's job, not this flag's.)
    use_kernels: bool = True
    # FP8 training: the expert GEMMs go through the differentiable grouped
    # op (ops/autograd.fp8_grouped_matmul: contiguous grouped kernel forward
    # and dgrad, k-grouped kernel wgrad) on bf16 weights.
    fp8_training: bool = False


def swiglu_apply_weight(gate_up: torch.Tensor, row_weights: torch.Tensor,
                        clamp: float = 256.0) -> torch.Tensor:
    """SwiGLU + clamp + per-row (top-k) weight, in f32."""
    inter = gate_up.shape[-1] // 2
    gate = gate_up[..., :inter].float()
    up = gate_up[..., inter:].float()
    act = (F.silu(gate) * up).clamp(-clamp, clamp)
    return act * row_weights[..., None]


def swiglu_apply_weight_to_fp8(gate_up: torch.Tensor, row_weights: torch.Tensor,
                               gran_k: int = 128):
    """SwiGLU + weight, then the per-token FP8 requant of the bf16 result:
    the unfused form of the mega block's act-fp8 epilogue. Returns (e4m3
    [..., I], f32 scales [..., I / gran_k])."""
    act = swiglu_apply_weight(gate_up, row_weights)
    shape = act.shape
    q, sf = per_token_cast_to_fp8(act.reshape(-1, shape[-1]).to(torch.bfloat16),
                                  use_ue8m0=False, gran_k=gran_k)
    return q.reshape(shape), sf.reshape(*shape[:-1], -1)


def moe_capacity(num_tokens: int, topk: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert slot capacity, aligned for the grouped kernels."""
    return align(int(ceil_div(num_tokens * topk, num_experts)
                     * capacity_factor) + 1, 8)


def dispatch_indices(topk_idx: torch.Tensor, num_experts: int, capacity: int):
    """Static-shape dispatch plan: for each (token, k) pair, its expert and
    its slot among the pairs of that expert (in pair order). Returns
    (expert, slot, kept, num_dropped); slots >= capacity are dropped."""
    expert = topk_idx.reshape(-1).long()                       # [T*K]
    order = torch.argsort(expert, stable=True)
    inv = torch.argsort(order, stable=True)
    sorted_e = expert[order]
    ids = torch.arange(num_experts, device=expert.device)
    group_start = torch.searchsorted(sorted_e, ids)
    slot_sorted = torch.arange(expert.numel(), device=expert.device) - group_start[sorted_e]
    slot = slot_sorted[inv]
    kept = slot < capacity
    return expert, slot, kept, (~kept).sum()


def ep_dispatch_indices(topk_idx: torch.Tensor, num_experts: int, e_local: int,
                        capacity: int):
    """The plan as the JAX package's ``dispatch_indices`` gives it
    (deepgemm_tpu/parallel/moe.py:89-110): (rank, local expert, slot, kept,
    num_dropped) of each pair. At one rank (``e_local == num_experts``) the
    rank is 0 and the local expert the expert."""
    expert, slot, kept, num_dropped = dispatch_indices(topk_idx, num_experts, capacity)
    return expert // e_local, expert % e_local, slot, kept, num_dropped


def ep_size(axis_name: str = 'ep') -> int:
    """Ranks along ``axis_name`` inside ``Mesh.map``; 1 outside a mesh."""
    return dist.axis_size(axis_name) if dist.in_mesh() else 1


def local_expert_recv_stats(topk_idx: torch.Tensor, cfg: MoEConfig,
                            axis_name: str = 'ep') -> torch.Tensor:
    """This step's routed-pair count of each LOCAL expert, int32 [E_local]
    (the JAX package's ``local_expert_recv_stats``), summed over the source
    ranks by ``psum``: capacity drops included, as the mega kernel's receive
    accounting counts them."""
    counts = torch.bincount(topk_idx.reshape(-1).long(),
                            minlength=cfg.num_experts).to(torch.int32)
    ep = ep_size(axis_name)
    if ep == 1:
        return counts
    total = dist.psum(counts.view(ep, cfg.num_experts // ep), axis_name)
    return total[dist.axis_index(axis_name)]


def scatter_to_slots(x: torch.Tensor, pair_w: torch.Tensor, expert: torch.Tensor,
                     slot: torch.Tensor, kept: torch.Tensor, num_experts: int, cap: int,
                     k: int, fill_x: float = 0.0):
    """Each kept pair's row of ``x`` [T, W] (token t owns pairs t*k ..
    t*k+k-1) and its weight into [E, cap, W] and [E, cap]; empty slots hold
    rows of ``fill_x`` and weight 0. Dropped pairs land on an extra last
    row that the prefix view leaves out (the JAX scatter's mode='drop')."""
    t_count, width = x.shape
    pair_t = torch.arange(t_count, device=x.device).repeat_interleave(k)
    dest = torch.where(kept, expert * cap + slot, num_experts * cap)
    rows = x.new_full((num_experts * cap + 1, width), fill_x)
    rows.index_put_((dest,), x[pair_t])
    row_w = torch.zeros(num_experts * cap + 1, dtype=pair_w.dtype, device=x.device)
    row_w.index_put_((dest,), pair_w)
    return (rows[:num_experts * cap].view(num_experts, cap, width),
            row_w[:num_experts * cap].view(num_experts, cap))


def combine_pairs(y_exp: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                  kept: torch.Tensor, t_count: int, k: int) -> torch.Tensor:
    """Weighted rows [E, cap, H] back to their tokens, bf16 [T, H]. The JAX
    scatter-add is a sum over k, taken here in pair order in f32 without
    atomics: the same inputs give the same bits on every run (a changed
    last bit can flip a later layer's expert choice)."""
    cap, hidden = y_exp.shape[1:]
    y_pairs = y_exp[expert, slot.clamp(0, cap - 1)]
    y_pairs = torch.where(kept[:, None], y_pairs, torch.zeros_like(y_pairs))
    y_pairs = y_pairs.view(t_count, k, hidden).float()
    out = torch.zeros((t_count, hidden), dtype=torch.float32, device=y_exp.device)
    for j in range(k):
        out += y_pairs[:, j]
    return out.to(torch.bfloat16)


def ep_moe_forward(x: torch.Tensor, topk_idx: torch.Tensor,
                   topk_weights: torch.Tensor, w1, w1_sf, w2, w2_sf,
                   cfg: MoEConfig, axis_name: str = 'ep'):
    """x [T, H] bf16 (this rank's tokens); topk_idx [T, K] global expert
    ids; topk_weights [T, K] f32; w1 [E_local, 2I, H], w2 [E_local, H, I]
    (e4m3 with [E_local, ., .] block scales, or bf16 with sf None), this
    rank's experts. Returns (y [T, H] bf16, num_dropped [1])."""
    t_count, hidden = x.shape
    k = topk_idx.shape[1]
    ep = ep_size(axis_name)
    e_local = cfg.num_experts // ep
    cap = moe_capacity(t_count, k, cfg.num_experts, cfg.capacity_factor)
    expert, slot, kept, num_dropped = dispatch_indices(topk_idx, cfg.num_experts, cap)
    send_x, send_w = scatter_to_slots(x, topk_weights.reshape(-1).float(), expert, slot, kept,
                                      cfg.num_experts, cap, k)
    if ep == 1:
        a1, row_w = send_x, send_w
    else:
        # [ep, E_local, cap, .] slots by destination -> by source
        recv_x = dist.all_to_all(send_x.view(ep, e_local, cap, hidden), axis_name)
        recv_w = dist.all_to_all(send_w.view(ep, e_local, cap), axis_name)
        a1 = recv_x.transpose(0, 1).reshape(e_local, ep * cap, hidden)
        row_w = recv_w.transpose(0, 1).reshape(e_local, ep * cap)
    gate_up = _expert_gemm(a1, w1, w1_sf, cfg)                   # [E_local, ep*cap, 2I]
    act = swiglu_apply_weight(gate_up, row_w).to(torch.bfloat16)
    y_exp = _expert_gemm(act, w2, w2_sf, cfg)                    # [E_local, ep*cap, H]
    if ep > 1:
        back = y_exp.view(e_local, ep, cap, hidden).transpose(0, 1).contiguous()
        y_exp = dist.all_to_all(back, axis_name).view(cfg.num_experts, cap, hidden)
    return combine_pairs(y_exp, expert, slot, kept, t_count, k), num_dropped.reshape(1)


def _expert_gemm(a_bf16: torch.Tensor, w: torch.Tensor, w_sf, cfg: MoEConfig
                 ) -> torch.Tensor:
    """Per-expert GEMM [E, R, K] @ [E, N, K]^T -> [E, R, N] bf16, as the JAX
    package's _expert_gemm (deepgemm_tpu/parallel/moe.py:186-219).

    bf16 weights (``w_sf`` None): with ``fp8_training`` the differentiable
    FP8 grouped op over equal groups of R rows; with ``use_kernels`` the
    masked kernel with every row live; else the bf16 einsum in f32.
    FP8 weights (``w_sf`` given, the serving path): activations are
    quantized per token and the weights' 128x128 block scales go into the
    masked kernel as they are."""
    e_count, rows, k_dim = a_bf16.shape
    full = lambda: torch.full((e_count,), rows, dtype=torch.int32, device=a_bf16.device)
    if w_sf is None:
        if cfg.fp8_training:
            assert rows % 128 == 0, (
                rows, 'fp8_training needs 128-aligned per-expert row blocks '
                '(pick a capacity with cap % 128 == 0)')
            ids = torch.arange(e_count, dtype=torch.int32,
                               device=a_bf16.device).repeat_interleave(rows)
            out = fp8_grouped_matmul(a_bf16.reshape(e_count * rows, k_dim), w, ids)
            return out.reshape(e_count, rows, -1).to(torch.bfloat16)
        if cfg.use_kernels:
            return masked_gemm(a_bf16, w, full())
        return torch.matmul(a_bf16.float(), w.float().transpose(1, 2)).to(torch.bfloat16)
    aq, asf = per_token_cast_to_fp8(a_bf16.reshape(-1, k_dim), use_ue8m0=False)
    return masked_gemm(aq.view(e_count, rows, k_dim), w, full(),
                       sfa=asf.view(e_count, rows, -1), sfb=w_sf)
