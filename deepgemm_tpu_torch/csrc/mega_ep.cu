// The expert-parallel MoE kernels over the D ranks of a mesh, each a
// persistent launch a rank:
//
//   dispatch + L1 (fused_dispatch_gemm):
//     recv[src] = send_src[my]            (one-sided pushes, the all-to-all)
//     out[e, src] = recv[src, e] . w[e]^T (bf16; e4m3 with the f32 promotion)
//   Replaces deepgemm_tpu/kernels/fused_moe.py:_kernel (pl.pallas_call at
//   fused_moe.py:185, _call; entry fused_dispatch_gemm, :1217).
//
//   the general mega MoE (fused_mega_moe with D > 1, or force_general):
//     dispatch of every slab to its rank, then per local expert and per
//     tile of its received rows the fused block (L1 gate|up, SwiGLU with
//     clamp and the row's top-k weight, fp8 requant when act is fp8, L2),
//     each result row stored straight into its source rank's combine region:
//     combine_src[my, e, slot] = block(recv[src, e, slot])
//   Replaces deepgemm_tpu/kernels/fused_moe.py:_mega_kernel (:343;
//   pl.pallas_call at :1198, fused_mega_moe).
//
// The protocol (entry barrier, epoch signals, bounded spins, sys-scope
// fences) is comm.cuh's. Every block first stores its 1/G share of each
// slab (and its scales) into slot [my] of the slab's rank (its own slot
// first), then fences and signals one arrival at every rank.
//
// Dispatch + L1 runs the masked kernel's body (gemm_sm90.cuh widen_body:
// TMA-fed stages, one producer lane, consumer warpgroups on wgmma over bf16
// products) with every row live. Its receive region is expert-major, tokens [E, D, cap, H]
// and their scales k-first [E, H/128, sfa_ld] (sfa_ld: D x cap rounded up
// to 4; the wrapper lays each slab's scales out k-first before the push),
// so a sender's rows of expert e land as one block of cap rows at row
// my x cap, and expert e's D x cap received rows are one group of a 3-D
// tensor map: a row tile spans slabs, each expert's weights are read once
// per 64 or 128 received rows, and a stage is one TMA load of A, one of B
// and a bulk copy of each side's scales, as in the masked kernel. (Boxes
// of 8 rows through a 4-D map over slab-major slabs ran e4m3 slower than
// bf16 on the H100, with half its bytes: one producer lane issuing 16 A
// boxes and 16 scale copies a stage set the pace.) The items run (expert, column tile, row
// tile), the row tiles of a weight tile on neighbouring blocks, so the
// weight tile is read from L2 after the first. Only the producer lane waits
// for slabs: before an item's first load, for each slab its rows cover not
// seen yet, then a fence.proxy.async (the peers' generic stores, the TMA's
// async reads). Bits: each row's sum is computed as the masked kernel
// computes it, so ``out`` is bitwise the masked kernel on ``recv``.
//
// The mega items run mega_sm90.cuh's body, the one-rank kernel's
// (mega_local.cu), on the expert's received rows whose row weight is not 0
// (live), in processing-step order (step s: the slab from rank (my - s) mod
// D, so the first items compute on this rank's own tokens while the peers'
// slabs are in flight): item (local expert e, tile j) is the live rows j kN
// .. j kN + kN - 1 of expert e (kN = 40), a tile spanning slabs; the
// wrapper lists them (order: each expert's received rows, live first, both
// in step order; counts; prefix: each expert's first item), as rw_steps is
// this rank's own before any slab lands. One consumer thread waits only for
// the slabs its tile's rows read, before the consumers gather them into the
// block's scratch; the tiles of an expert run on neighbouring blocks, so
// the expert's weights are streamed ceil(live rows / kN) times, each tile
// after the first from L2. A row of weight 0 is stored as +0 and not
// computed: for finite weights the block gives it +0 too (the clamp keeps
// silu(g) up finite, times 0 is +-0, and sums that start at +0 stay +0). A
// row's result depends on that row alone (its column of every wgmma), so
// every slab's rows come out bitwise the one-rank kernel on the same rows,
// and force_general at D = 1 is bitwise the one-rank kernel. A wave pool
// (pick_wave_pool, JAX's rule for the TPU kernel's VMEM) no longer groups
// the work: the tiles run over every slab, so every pool gives the same
// launch and the same bits; the entry validates it and keeps it in the
// interface.
//
// Co-residency: a rank's blocks spin on its peers' blocks, so every rank's
// grid must be on the card at once. G is the card's SMs shared out between
// the ranks on it (16 a rank for 8 ranks on one H100, 132 for a card of
// its own) at one block an SM; the launch checks that one block fits an
// SM. The spin timeout turns any mistake here into an error.
//
// What bounds it on the H100: dispatch + L1 streams each local expert's
// weights from HBM once (bytes; its wgmma rows are the received rows
// rounded up to the tile); the mega items stream an expert's weights once
// per 40 live received rows, from HBM for the first tile and from L2 for
// its neighbours, with the wgmma work of every live row at the bf16 rate
// (the operations bound them where the weights come from L2).

#include "comm.cuh"
#include "gemm_sm90.cuh"
#include "mega_sm90.cuh"

namespace dgt {
namespace ep {

using comm::Peers;

// This block's share of slab dst of ``send`` (slab bytes each) into slot
// [my] of rank dst's receive region at ``region`` (slot stride ``stride``),
// for every dst, this rank's own slot first.
__device__ __forceinline__ void push_slabs(const Peers& c, const uint8_t* send, int64_t slab,
                                           int64_t stride, int64_t region) {
    for (int p = 0; p < c.size; ++p) {
        const int dst = (c.rank + p) % c.size;
        comm::copy_part<false>(c.data(dst) + region + c.rank * stride, send + dst * slab, slab,
                               blockIdx.x, gridDim.x);
    }
}

// This block's share of `rows` rows of `row_bytes` bytes from src (rows
// src_ld bytes apart) to dst (rows dst_ld bytes apart), in 16-byte words
// where every address and stride allows, else 4-byte words, else bytes
// (the words of one copy fewer than 2^32).
__device__ __forceinline__ void copy_rows(uint8_t* dst, int64_t dst_ld, const uint8_t* src,
                                          int64_t src_ld, int rows, int64_t row_bytes) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)
                          | static_cast<uintptr_t>(dst_ld) | static_cast<uintptr_t>(src_ld)
                          | static_cast<uintptr_t>(row_bytes);
    auto run = [&](auto word) {
        using T = decltype(word);
        const uint32_t per_row = static_cast<uint32_t>(row_bytes / sizeof(T));
        const uint32_t n = static_cast<uint32_t>(rows) * per_row;
        const uint32_t per = (n + gridDim.x - 1) / gridDim.x;
        const uint32_t lo = per * blockIdx.x, hi = lo + per < n ? lo + per : n;
        for (uint32_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
            const uint32_t r = i / per_row, w = i - r * per_row;
            reinterpret_cast<T*>(dst + r * dst_ld)[w] =
                reinterpret_cast<const T*>(src + r * src_ld)[w];
        }
    };
    if ((align & 15) == 0) run(uint4{});
    else if ((align & 3) == 0) run(0u);
    else run(static_cast<unsigned char>(0));
}

struct DispatchArgs {
    sm90::Args p;            // the GEMM over the received rows (gemm_sm90.cuh)
    const uint8_t* send;     // [D, E, cap, H] e4m3 or bf16
    const uint8_t* send_sf;  // [D, E, H/128, cap] f32 k-first, or null (bf16)
    int experts, cap, ksf;
    int64_t row_bytes, sf_region;   // bytes
    Peers c;
};

// The producer lane's wait for the slabs an item's rows read (rows m0 on of
// an expert's D x cap: slab r / cap holds row r): rank src's blocks have
// all signalled their stores of this call. The stores were generic, the
// loads that read them are TMA's (the async proxy): a proxy fence between.
struct SlabWait {
    const Peers& c;
    int cap;
    unsigned long long landed;   // a bit a slab
    __device__ __forceinline__ void operator()(int m0, int rows) {
        for (int src = m0 / cap; src <= (m0 + rows - 1) / cap; ++src) {
            if ((landed >> src) & 1ull) continue;
            comm::spin_until(c, comm::kArrive, src, c.epoch * gridDim.x);
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            landed |= 1ull << src;
        }
    }
};

template <int kBM, sm90::Operand kAB>
using DispatchPlan = sm90::MaskedPlan<kBM, __nv_bfloat16, kAB>;

template <int kBM, sm90::Operand kAB>
__global__ void __launch_bounds__((DispatchPlan<kBM, kAB>::kThreads), 1)
dispatch_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_d, const DispatchArgs a) {
    const Peers& c = a.c;
    const int D = c.size, E = a.experts, cap = a.cap;
    // every thread pushes, before the producer warpgroup gives up its
    // registers: slab dst's expert e to rows [my cap, my cap + cap) of
    // expert e at rank dst, its scales to the same columns of each k row
    comm::entry_barrier(c);
    for (int p = 0; p < D; ++p) {
        const int dst = (c.rank + p) % D;
        const int64_t slab_bytes = static_cast<int64_t>(cap) * a.row_bytes;
        copy_rows(c.data(dst) + c.rank * slab_bytes, D * slab_bytes, a.send + dst * E * slab_bytes,
                  slab_bytes, E, slab_bytes);
        if (a.send_sf != nullptr)
            copy_rows(c.data(dst) + a.sf_region + c.rank * cap * 4, a.p.sfa_ld * 4,
                      a.send_sf + static_cast<int64_t>(dst) * E * a.ksf * cap * 4, cap * 4,
                      E * a.ksf, cap * 4);
    }
    comm::signal_all(c, comm::kArrive);
    SlabWait wait{c, cap, 0ull};
    using sm90::Items;
    sm90::widen_body<kBM, sm90::kDenseBN, __nv_bfloat16, kAB, kAB, false, Items::kByWeight>(
        map_a, map_b, map_d, a.p, nullptr, wait);
}

// The general kernel's rows: item t of local expert e (prefix[e] <= t <
// prefix[e + 1]) is its live rows (t - prefix[e]) kN .. in step order; live
// row k is received row q = order[e][k] (step q / cap, slot q % cap, from
// rank (my - step) mod D), read from this rank's receive slots and stored
// into the source rank's combine region.
struct EpRows {
    Peers c;
    const float* rw_steps;     // [D, E, cap] f32, step order
    const int* order;
    const int* counts;
    const int* prefix;
    int64_t x_row_bytes, x_stride, sf_stride, sf_region, y_region;
    int experts, cap, hidden;
    struct State {
        unsigned long long landed = 0;   // a bit a source rank
    };
    __device__ __forceinline__ int items() const { return __ldg(prefix + experts); }
    __device__ __forceinline__ mega::Item item(int t) const {
        int lo = 0, hi = experts;          // prefix[lo] <= t < prefix[hi]
        while (hi - lo > 1) {
            const int mid = (lo + hi) / 2;
            if (__ldg(prefix + mid) <= t) lo = mid;
            else hi = mid;
        }
        const int r0 = (t - __ldg(prefix + lo)) * mega::kN;
        return {lo, r0, min(mega::kN, __ldg(counts + lo) - r0)};
    }
    __device__ __forceinline__ int q_of(const mega::Item& it, int n) const {
        return __ldg(order + static_cast<int64_t>(it.e) * c.size * cap + it.r0 + n);
    }
    __device__ __forceinline__ int src_of(int step) const {
        return (c.rank - step + c.size) % c.size;
    }
    // one consumer thread: rank src's blocks have all signalled their stores
    // of this call, for each slab between the item's first and last rows'
    // (in step order); the consumers' barrier after it orders their reads
    __device__ __forceinline__ void wait(const mega::Item& it, State& st) const {
        for (int step = q_of(it, 0) / cap; step <= q_of(it, it.live - 1) / cap; ++step) {
            const int src = src_of(step);
            if ((st.landed >> src) & 1ull) continue;
            comm::spin_until(c, comm::kArrive, src, c.epoch * gridDim.x);
            st.landed |= 1ull << src;
        }
    }
    // received row q: (its source rank, its row of [E, cap] for expert e)
    __device__ __forceinline__ int2 at(int e, int q) const {
        const int step = q / cap;
        return make_int2(src_of(step), e * cap + (q - step * cap));
    }
    __device__ __forceinline__ const uint8_t* x_row(const mega::Item& it, int n) const {
        const int2 a = at(it.e, q_of(it, n));
        return c.data(c.rank) + a.x * x_stride + static_cast<int64_t>(a.y) * x_row_bytes;
    }
    __device__ __forceinline__ const float* sf_row(const mega::Item& it, int n) const {
        const int2 a = at(it.e, q_of(it, n));
        return reinterpret_cast<const float*>(c.data(c.rank) + sf_region + a.x * sf_stride) +
               static_cast<int64_t>(a.y) * (hidden / 128);
    }
    // peers' stores of this call: read through L2
    __device__ __forceinline__ uint4 load16(const uint8_t* p) const {
        return __ldcg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ float sf_load(const float* p) const { return __ldcg(p); }
    __device__ __forceinline__ float rw_of(const mega::Item& it, int n) const {
        const int q = q_of(it, n), step = q / cap;
        return __ldg(rw_steps + (static_cast<int64_t>(step) * experts + it.e) * cap +
                     (q - step * cap));
    }
    __device__ __forceinline__ __nv_bfloat16* y_of(int e, int q) const {
        const int2 a = at(e, q);
        return reinterpret_cast<__nv_bfloat16*>(c.data(a.x) + y_region) +
               (static_cast<int64_t>(c.rank) * experts * cap + a.y) * hidden;
    }
    __device__ __forceinline__ __nv_bfloat16* y_row(const mega::Item& it, int n) const {
        return y_of(it.e, q_of(it, n));
    }
    // this block's share of the rows of weight 0: +0 in their combine rows
    __device__ __forceinline__ void zero_dead_rows() const {
        const int rows = c.size * cap;
        for (int w = blockIdx.x; w < experts * rows; w += gridDim.x) {
            const int e = w / rows, k = w - e * rows;
            if (k < __ldg(counts + e)) continue;
            uint4* dst = reinterpret_cast<uint4*>(
                y_of(e, __ldg(order + static_cast<int64_t>(e) * rows + k)));
            for (int i = threadIdx.x; i < hidden / 8; i += blockDim.x) dst[i] = make_uint4(0, 0, 0, 0);
        }
    }
};

struct MegaArgs {
    const uint8_t* send;     // [D, E, cap, H]
    const float* send_sf;    // [D, E, cap, H/128], or null
    int64_t x_slab, x_stride, sf_slab, sf_stride, sf_region;   // bytes
    EpRows rows;             // the items and their rows
};

template <mega::W kW, bool kActFp8>
__global__ void __launch_bounds__(mega::kThreads, 1)
mega_ep_kernel(const __grid_constant__ CUtensorMap map_w1,
               const __grid_constant__ CUtensorMap map_w2,
               const __grid_constant__ CUtensorMap map_act,
               const __grid_constant__ CUtensorMap map_x, const __grid_constant__ mega::Args p,
               const __grid_constant__ MegaArgs a) {
    const Peers& c = a.rows.c;
    comm::entry_barrier(c);
    push_slabs(c, a.send, a.x_slab, a.x_stride, 0);
    if (a.send_sf != nullptr)
        push_slabs(c, reinterpret_cast<const uint8_t*>(a.send_sf), a.sf_slab, a.sf_stride,
                   a.sf_region);
    comm::signal_all(c, comm::kArrive);
    mega::mega_body<kW, kActFp8>(map_w1, map_w2, map_act, map_x, p, a.rows);
    a.rows.zero_dead_rows();
    // combine: every result row is stored; then wait for every rank's
    comm::signal_all(c, comm::kCombine);
    for (int r = 0; r < c.size; ++r) comm::wait_from(c, comm::kCombine, (c.rank - r + c.size) % c.size);
}

// Launch one block of `threads` per share of the card; refuse a grid that
// cannot be resident at one block an SM.
template <class Kernel, class... A>
cudaError_t launch_persistent(Kernel kernel, int threads, int smem, int blocks,
                              cudaStream_t stream, const A&... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    kernel<<<blocks, threads, smem, stream>>>(args...);
    return cudaGetLastError();
}

// A dispatch_gemm_kernel instance of block_m rows (64 or 128).
template <sm90::Operand kAB>
cudaError_t launch_dispatch(const CUtensorMap& map_a, const CUtensorMap& map_b,
                            const CUtensorMap& map_d, const DispatchArgs& a, int block_m,
                            int blocks, cudaStream_t stream) {
    auto go = [&](auto kernel, auto plan) {
        using P = decltype(plan);
        const int smem = P::smem_bytes(a.p.num_stages);
        if (a.p.num_stages < 2 || smem > sm90::kSmemLimit) return cudaErrorInvalidValue;
        return launch_persistent(kernel, P::kThreads, smem, blocks, stream, map_a, map_b, map_d,
                                 a);
    };
    if (block_m == 128) return go(dispatch_gemm_kernel<128, kAB>, DispatchPlan<128, kAB>{});
    if (block_m == 64) return go(dispatch_gemm_kernel<64, kAB>, DispatchPlan<64, kAB>{});
    return cudaErrorInvalidValue;
}

}  // namespace ep
}  // namespace dgt

namespace {

dgt::comm::Peers peers(const void* table, int rank, int size, unsigned long long epoch,
                       long long timeout_ns, void* diag) {
    return {static_cast<const int64_t*>(table), rank, size, epoch, timeout_ns,
            static_cast<long long*>(diag)};
}

}  // namespace

// Fused dispatch + L1. send [D, E, cap, H] (e4m3 with send_sf [D, E, H/128,
// cap] f32 k-first, w_sf [E, N/128, H/128] f32 and scratch E (H/128) sfb_ld
// f32 for its k-first copy, sfb_ld = N/128 rounded up to 4; or bf16 with
// those null), w [E, N, H], out [E, D, cap, N] bf16. The symmetric buffer
// (table; this rank's own at recv) holds the tokens [E, D, cap, H] and, at
// sf_region, their scales [E, H/128, sfa_ld] f32 (sfa_ld: D cap rounded up
// to 4). block_m (64 or 128) and num_stages from
// heuristics/configs.py:get_sm90_config. Returns the cudaError_t of the
// launches.
extern "C" int dgt_dispatch_gemm(const void* send, const void* send_sf, const void* w,
                                 const void* w_sf, void* scratch, void* out, const void* recv,
                                 int experts, int cap, int n, int hidden, int sfa_ld, int sfb_ld,
                                 long long sf_region, int block_m, int num_stages,
                                 const void* table, int rank, int size, unsigned long long epoch,
                                 int blocks, long long timeout_ns, void* diag, void* stream) {
    using namespace dgt::sm90;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool fp8 = send_sf != nullptr;
    const int ksf = hidden / 128;
    const uint64_t row_bytes = static_cast<uint64_t>(hidden) * (fp8 ? 1 : 2);
    const int rows = size * cap;               // an expert's received rows
    dgt::ep::DispatchArgs a = {};
    a.send = static_cast<const uint8_t*>(send);
    a.send_sf = static_cast<const uint8_t*>(send_sf);
    a.experts = experts;
    a.cap = cap;
    a.ksf = ksf;
    a.row_bytes = static_cast<int64_t>(row_bytes);
    a.sf_region = sf_region;
    a.c = peers(table, rank, size, epoch, timeout_ns, diag);
    Args& p = a.p;
    if (fp8) {
        const cudaError_t err = launch_k_first(nullptr, w_sf, scratch, 0, n / 128, ksf, 0, sfb_ld,
                                               experts, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        p.sfa = reinterpret_cast<const float*>(static_cast<const uint8_t*>(recv) + sf_region);
        p.sfb = static_cast<const float*>(scratch);
        p.sfb_ld = sfb_ld;
        p.sfb_group_stride = static_cast<int64_t>(ksf) * sfb_ld;
    }
    p.sfa_ld = sfa_ld;
    p.d = out;
    p.M = rows;
    p.N = n;
    p.num_kb = static_cast<int>(row_bytes / kBK);   // a stage: 128 values of e4m3, 64 of bf16
    p.sfb_shift = 7;
    p.num_groups = experts;
    p.num_stages = num_stages;
    CUtensorMap map_a, map_b, map_d = {};
    if (!make_map_3d(&map_a, recv, row_bytes, rows, row_bytes, experts, block_m) ||
        !make_map_3d(&map_b, w, row_bytes, n, row_bytes, experts, kDenseBN) ||
        !make_out_map(&map_d, out, n, rows, experts, 0))
        return static_cast<int>(cudaErrorInvalidValue);
    p.tma_store = 1;
    using dgt::ep::launch_dispatch;
    const cudaError_t err =
        fp8 ? launch_dispatch<Operand::kE4m3>(map_a, map_b, map_d, a, block_m, blocks, s)
            : launch_dispatch<Operand::kBf16>(map_a, map_b, map_d, a, block_m, blocks, s);
    return static_cast<int>(err);
}

// The general mega MoE. send [D, E, cap, H] (e4m3 with send_sf, or bf16),
// rw_steps [D, E, cap] f32 in step order, weights and scales as
// dgt_mega_local takes them, act the scratch of blocks x 40 rows
// (dgt::mega::scratch_bytes); the live rows (weight not 0): order [E, D cap] int32 (each
// expert's received rows q = step cap + slot, the live ones first, both in
// step order), counts [E] and prefix [E + 1] (each expert's first tile of
// 40 live rows, the total last); the symmetric buffer holds D x slots
// (x_stride), at sf_region D sf slots (sf_stride), at y_region the combine
// [D, E, cap, H] bf16. pool: a divisor of D (it moves no bit). Returns the
// launch's cudaError_t.
extern "C" int dgt_mega_ep(const void* send, const void* send_sf, const void* rw_steps,
                           const void* w1, const void* w1sf, const void* w2, const void* w2sf,
                           void* act, const void* order, const void* counts, const void* prefix,
                           int experts, int cap, int hidden, int inter, int pool,
                           int weight_kind, int act_fp8, int silu_tanh, float clamp,
                           long long x_stride, long long sf_stride, long long sf_region,
                           long long y_region, const void* table, int rank, int size,
                           unsigned long long epoch, int blocks, long long timeout_ns,
                           void* diag, void* stream) {
    using dgt::mega::W;
    if (pool < 1 || size % pool != 0 || weight_kind < 0 || weight_kind > 2 ||
        (weight_kind == 0 && act_fp8) || size > 64)
        return static_cast<int>(cudaErrorInvalidValue);
    dgt::mega::Args p = {};
    p.w1sf = static_cast<const float*>(w1sf);
    p.w2sf = static_cast<const float*>(w2sf);
    p.hidden = hidden;
    p.inter = inter;
    p.silu_tanh = silu_tanh;
    p.clamp = clamp;
    dgt::ep::MegaArgs a = {};
    a.send = static_cast<const uint8_t*>(send);
    a.send_sf = static_cast<const float*>(send_sf);
    a.x_slab = static_cast<int64_t>(experts) * cap * hidden * (weight_kind == 0 ? 2 : 1);
    a.x_stride = x_stride;
    a.sf_slab = static_cast<int64_t>(experts) * cap * (hidden / 128) * 4;
    a.sf_stride = sf_stride;
    a.sf_region = sf_region;
    dgt::ep::EpRows& ep = a.rows;
    ep.c = peers(table, rank, size, epoch, timeout_ns, diag);
    ep.rw_steps = static_cast<const float*>(rw_steps);
    ep.order = static_cast<const int*>(order);
    ep.counts = static_cast<const int*>(counts);
    ep.prefix = static_cast<const int*>(prefix);
    ep.x_row_bytes = static_cast<int64_t>(hidden) * (weight_kind == 0 ? 2 : 1);
    ep.x_stride = x_stride;
    ep.sf_stride = sf_stride;
    ep.sf_region = sf_region;
    ep.y_region = y_region;
    ep.experts = experts;
    ep.cap = cap;
    ep.hidden = hidden;
    const int smem = dgt::mega::smem_bytes(inter);
    if (smem > dgt::sm90::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t rows = static_cast<int64_t>(blocks) * dgt::mega::kN;
    dgt::mega::split_scratch(&p, act, rows, weight_kind == 0 ? 2 : 1, act_fp8 ? 1 : 2);
    CUtensorMap m1, m2, ma, mx;
    if (!dgt::mega::make_maps(&m1, &m2, &ma, &mx, w1, w2, p, experts, weight_kind, act_fp8,
                              rows))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    using dgt::ep::launch_persistent;
    using dgt::ep::mega_ep_kernel;
    auto go = [&](auto kernel) {
        return launch_persistent(kernel, dgt::mega::kThreads, smem, blocks, s, m1, m2, ma, mx, p,
                                 a);
    };
    cudaError_t err;
    if (weight_kind == 0)
        err = go(mega_ep_kernel<W::kBf16, false>);
    else if (weight_kind == 1)
        err = act_fp8 ? go(mega_ep_kernel<W::kE4m3, true>) : go(mega_ep_kernel<W::kE4m3, false>);
    else
        err = act_fp8 ? go(mega_ep_kernel<W::kFp4, true>) : go(mega_ep_kernel<W::kFp4, false>);
    return static_cast<int>(err);
}
