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
//     dispatch of every slab to its rank, then per pool of P slabs and per
//     local expert the fused block (L1 gate|up, SwiGLU with clamp and the
//     row's top-k weight, fp8 requant when act is fp8, L2), each result row
//     stored straight into its source rank's combine region:
//     combine_src[my, e, slot] = block(recv[src, e, slot])
//   Replaces deepgemm_tpu/kernels/fused_moe.py:_mega_kernel (:343;
//   pl.pallas_call at :1198, fused_mega_moe).
//
// The protocol (entry barrier, epoch signals, bounded spins, sys-scope
// fences) is comm.cuh's. Every block first stores its 1/G share of each
// slab (and its scales) into slot [my] of the slab's rank (its own slot
// first), then fences and signals one arrival at every rank. Items are
// walked in processing-step order, step s being the slab from rank
// (my - s) mod D, so the first items compute on this rank's own tokens
// while the peers' slabs are in flight, and an item waits only for the
// slabs it reads (a pool waits for its P slabs). Slabs lie 128-byte aligned
// in the receive region, so no cache line holds bytes of two slabs.
//
// Bits: the dispatch + L1 tiles are the masked kernel's mainloop
// (gemm_mainloop.cuh, gemm_tile; 64 x 128 tiles), so ``out`` is bitwise the
// masked kernel on ``recv``. The mega items run mega_block.cuh, the body of
// the one-rank kernel (mega_local.cu), on rows gathered from the pool's
// slabs; a row's result depends on that row alone, so every slab's rows
// come out bitwise the one-rank kernel on the same rows, at every pool
// size, and force_general at D = 1 is bitwise the one-rank kernel.
//
// Co-residency: a rank's blocks spin on its peers' blocks, so every rank's
// grid must be on the card at once. G is the card's SMs shared out between
// the ranks on it (16 a rank for 8 ranks on one H100, 132 for a card of
// its own) at one block an SM; the launch checks that one block fits an
// SM. The spin timeout turns any mistake here into an error.
//
// What bounds it on the H100: dispatch + L1 streams each local expert's
// weights once per 64-row tile of a slab (D x ceil(cap/64) times) and
// moves the slabs (bytes); the mega items stream an expert's weights once
// per 48-row item (bytes), as the one-rank kernel does per expert. Both
// run mma.sync (wgmma is the next step).

#include "comm.cuh"
#include "mega_block.cuh"

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

struct DispatchArgs {
    const uint8_t* send;     // [D, E, cap, H] e4m3 or bf16
    const float* send_sf;    // [D, E, cap, H/128] f32, or null (bf16)
    const uint8_t* w;        // [E, N, H]
    const float* w_sf;       // [E, N/128, H/128] f32, or null
    __nv_bfloat16* out;      // [E, D, cap, N]
    int experts, cap, n, hidden;
    int64_t x_slab, x_stride, sf_slab, sf_stride, sf_region;   // bytes
    Peers c;
};

template <class F>
__global__ void __launch_bounds__(kThreads) dispatch_gemm_kernel(const DispatchArgs a) {
    const Peers& c = a.c;
    const int D = c.size;
    comm::entry_barrier(c);
    push_slabs(c, a.send, a.x_slab, a.x_stride, 0);
    if (a.send_sf != nullptr)
        push_slabs(c, reinterpret_cast<const uint8_t*>(a.send_sf), a.sf_slab, a.sf_stride,
                   a.sf_region);
    comm::signal_all(c, comm::kArrive);

    const int mt = (a.cap + kBM - 1) / kBM, nt = (a.n + 127) / 128;
    const int per_step = a.experts * mt * nt;
    const int ksf = a.hidden / 128;
    const uint8_t* recv = c.data(c.rank);
    int landed = 0;
    for (int item = blockIdx.x; item < D * per_step; item += gridDim.x) {
        const int s = item / per_step, rest = item % per_step;
        const int e = rest / (mt * nt), m_t = rest / nt % mt, n_t = rest % nt;
        for (; landed <= s; ++landed) comm::wait_from(c, comm::kArrive, (c.rank - landed + D) % D);
        const int src = (c.rank - s + D) % D;
        const int64_t row0 = static_cast<int64_t>(e) * a.cap;
        GemmArgs q = {};
        q.a = recv + src * a.x_stride + row0 * a.hidden * F::kEA;
        q.b = a.w + static_cast<int64_t>(e) * a.n * a.hidden * F::kEB;
        q.d = a.out + (static_cast<int64_t>(e) * D + src) * a.cap * a.n;
        q.M = a.cap;
        q.N = a.n;
        q.K = a.hidden;
        q.sfb_shift = 7;
        if (a.send_sf != nullptr) {
            q.sfa = reinterpret_cast<const float*>(recv + a.sf_region + src * a.sf_stride)
                  + row0 * ksf;
            q.sfb = a.w_sf + static_cast<int64_t>(e) * (a.n / 128) * ksf;
        }
        __syncthreads();     // the previous tile's stages are read
        gemm_tile<F, 128, Layout::kBatched, __nv_bfloat16>(q, n_t, m_t, 0);
    }
}

struct MegaArgs {
    mega::Args p;            // weights, scales, act scratch [G, kRows, I], widths, epilogue
    const uint8_t* send;     // [D, E, cap, H]
    const float* send_sf;    // [D, E, cap, H/128], or null
    const float* rw_steps;   // [D, E, cap] f32, step order
    int experts, cap, pool;
    int64_t x_slab, x_stride, sf_slab, sf_stride, sf_region, y_region;   // bytes
    Peers c;
};

// An item's rows, from the tables the block writes in shared memory.
struct EpRows {
    static constexpr bool kLocal = false;
    int r0;                    // unused: the tables give each row
    const uint8_t* const* xr;
    const float* const* sfr;
    const float* rwv;
    __nv_bfloat16* const* yr;
    uint8_t* act_base;
    int64_t act_row_bytes;
    __device__ __forceinline__ bool live(int r) const { return xr[r] != nullptr; }
    __device__ __forceinline__ const uint8_t* x_row(int r) const { return xr[r]; }
    __device__ __forceinline__ float xsf_at(int r, int kt) const { return __ldcg(sfr[r] + kt); }
    __device__ __forceinline__ float rw_at(int r) const { return rwv[r]; }
    __device__ __forceinline__ uint8_t* act_row(int r) const {
        return act_base + r * act_row_bytes;
    }
    __device__ __forceinline__ __nv_bfloat16* y_row(int r) const { return yr[r]; }
};

constexpr int kTableBytes = mega::kRows * (3 * 8 + 4);

template <mega::W kW, bool kActFp8>
__global__ void __launch_bounds__(kThreads) mega_ep_kernel(const MegaArgs a) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int kRows = mega::kRows;
    constexpr int kXBytes = kW == mega::W::kBf16 ? 2 : 1;
    const Peers& c = a.c;
    const int D = c.size, E = a.experts, cap = a.cap, P = a.pool;
    const int H = a.p.hidden, ksf = H / 128;
    uint8_t* tables = smem + mega::smem_bytes(a.p.inter);
    const uint8_t** xr = reinterpret_cast<const uint8_t**>(tables);
    const float** sfr = reinterpret_cast<const float**>(tables + kRows * 8);
    __nv_bfloat16** yr = reinterpret_cast<__nv_bfloat16**>(tables + 2 * kRows * 8);
    float* rwv = reinterpret_cast<float*>(tables + 3 * kRows * 8);

    comm::entry_barrier(c);
    push_slabs(c, a.send, a.x_slab, a.x_stride, 0);
    if (a.send_sf != nullptr)
        push_slabs(c, reinterpret_cast<const uint8_t*>(a.send_sf), a.sf_slab, a.sf_stride,
                   a.sf_region);
    comm::signal_all(c, comm::kArrive);

    const int64_t act_row_bytes = static_cast<int64_t>(a.p.inter) * (kActFp8 ? 1 : 2);
    const EpRows rows{0, xr, sfr, rwv, yr, a.p.act + blockIdx.x * kRows * act_row_bytes,
                      act_row_bytes};
    const uint8_t* recv = c.data(c.rank);
    const int pool_rows = P * cap;
    const int rbs = (pool_rows + kRows - 1) / kRows;
    const int total = (D / P) * E * rbs;
    int landed = 0;
    for (int item = blockIdx.x; item < total; item += gridDim.x) {
        const int sp = item / (E * rbs), e = item / rbs % E, rb = item % rbs;
        for (; landed < (sp + 1) * P; ++landed)
            comm::wait_from(c, comm::kArrive, (c.rank - landed + D) % D);
        __syncthreads();     // the previous item is done with the tables and the ring
        for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
            const int q = rb * kRows + r;
            if (q < pool_rows) {
                const int i = q / cap, slot = q % cap;
                const int step = sp * P + i, src = (c.rank - step + D) % D;
                const int64_t row = static_cast<int64_t>(e) * cap + slot;
                xr[r] = recv + src * a.x_stride + row * H * kXBytes;
                sfr[r] = a.send_sf == nullptr ? nullptr
                    : reinterpret_cast<const float*>(recv + a.sf_region + src * a.sf_stride)
                      + row * ksf;
                rwv[r] = __ldg(a.rw_steps + static_cast<int64_t>(step) * E * cap + row);
                yr[r] = reinterpret_cast<__nv_bfloat16*>(c.data(src) + a.y_region)
                      + ((static_cast<int64_t>(c.rank) * E + e) * cap + slot) * H;
            } else {
                xr[r] = nullptr;
                sfr[r] = nullptr;
                rwv[r] = 0.f;
                yr[r] = nullptr;
            }
        }
        __syncthreads();
        mega::mega_block<kW, kActFp8>(a.p, rows, e);
    }
    // combine: every result row is stored; then wait for every rank's
    cp_async_wait<0>();
    comm::signal_all(c, comm::kCombine);
    for (int p = 0; p < D; ++p) comm::wait_from(c, comm::kCombine, (c.rank - p + D) % D);
}

// Launch one block per share of the card; refuse a grid that cannot be
// resident at one block an SM.
template <class Kernel, class A>
cudaError_t launch_persistent(Kernel kernel, const A& a, int smem, int blocks,
                              cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    kernel<<<blocks, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
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

// Fused dispatch + L1. send [D, E, cap, H] (e4m3 with send_sf [D, E, cap,
// H/128] f32 and w_sf [E, N/128, H/128] f32, or bf16 with both null), w
// [E, N, H], out [E, D, cap, N] bf16; the symmetric buffer (table) holds
// D slots of x_stride bytes, then at sf_region D slots of sf_stride bytes.
// Returns the launch's cudaError_t.
extern "C" int dgt_dispatch_gemm(const void* send, const void* send_sf, const void* w,
                                 const void* w_sf, void* out, int experts, int cap, int n,
                                 int hidden, long long x_stride, long long sf_stride,
                                 long long sf_region, const void* table, int rank, int size,
                                 unsigned long long epoch, int blocks, long long timeout_ns,
                                 void* diag, void* stream) {
    dgt::ep::DispatchArgs a = {};
    a.send = static_cast<const uint8_t*>(send);
    a.send_sf = static_cast<const float*>(send_sf);
    a.w = static_cast<const uint8_t*>(w);
    a.w_sf = static_cast<const float*>(w_sf);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.experts = experts;
    a.cap = cap;
    a.n = n;
    a.hidden = hidden;
    const bool fp8 = send_sf != nullptr;
    a.x_slab = static_cast<int64_t>(experts) * cap * hidden * (fp8 ? 1 : 2);
    a.x_stride = x_stride;
    a.sf_slab = static_cast<int64_t>(experts) * cap * (hidden / 128) * 4;
    a.sf_stride = sf_stride;
    a.sf_region = sf_region;
    a.c = peers(table, rank, size, epoch, timeout_ns, diag);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    using dgt::Layout;
    if (fp8)
        return static_cast<int>(dgt::ep::launch_persistent(
            dgt::ep::dispatch_gemm_kernel<dgt::FormE4m3>, a,
            dgt::smem_bytes<dgt::FormE4m3, 128, Layout::kBatched>(), blocks, s));
    return static_cast<int>(dgt::ep::launch_persistent(
        dgt::ep::dispatch_gemm_kernel<dgt::FormBf16>, a,
        dgt::smem_bytes<dgt::FormBf16, 128, Layout::kBatched>(), blocks, s));
}

// The general mega MoE. send [D, E, cap, H] (e4m3 with send_sf, or bf16),
// rw_steps [D, E, cap] f32 in step order, weights and scales as
// dgt_mega_local takes them, act scratch [blocks, 48, I] (1 or 2 bytes an
// element); the symmetric buffer holds D x slots (x_stride), at sf_region
// D sf slots (sf_stride), at y_region the combine [D, E, cap, H] bf16.
// Returns the launch's cudaError_t.
extern "C" int dgt_mega_ep(const void* send, const void* send_sf, const void* rw_steps,
                           const void* w1, const void* w1sf, const void* w2, const void* w2sf,
                           void* act, int experts, int cap, int hidden, int inter, int pool,
                           int weight_kind, int act_fp8, int silu_tanh, float clamp,
                           long long x_stride, long long sf_stride, long long sf_region,
                           long long y_region, const void* table, int rank, int size,
                           unsigned long long epoch, int blocks, long long timeout_ns,
                           void* diag, void* stream) {
    using dgt::mega::W;
    dgt::ep::MegaArgs a = {};
    a.p.x = static_cast<const uint8_t*>(send);
    a.p.w1 = static_cast<const uint8_t*>(w1);
    a.p.w1sf = static_cast<const float*>(w1sf);
    a.p.w2 = static_cast<const uint8_t*>(w2);
    a.p.w2sf = static_cast<const float*>(w2sf);
    a.p.act = static_cast<uint8_t*>(act);
    a.p.cap = cap;
    a.p.hidden = hidden;
    a.p.inter = inter;
    a.p.silu_tanh = silu_tanh;
    a.p.clamp = clamp;
    a.send = static_cast<const uint8_t*>(send);
    a.send_sf = static_cast<const float*>(send_sf);
    a.rw_steps = static_cast<const float*>(rw_steps);
    a.experts = experts;
    a.cap = cap;
    a.pool = pool;
    a.x_slab = static_cast<int64_t>(experts) * cap * hidden * (weight_kind == 0 ? 2 : 1);
    a.x_stride = x_stride;
    a.sf_slab = static_cast<int64_t>(experts) * cap * (hidden / 128) * 4;
    a.sf_stride = sf_stride;
    a.sf_region = sf_region;
    a.y_region = y_region;
    a.c = peers(table, rank, size, epoch, timeout_ns, diag);
    if (pool < 1 || size % pool != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = dgt::mega::smem_bytes(inter) + dgt::ep::kTableBytes;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    using dgt::ep::launch_persistent;
    using dgt::ep::mega_ep_kernel;
    cudaError_t err = cudaErrorInvalidValue;
    if (weight_kind == 0 && !act_fp8)
        err = launch_persistent(mega_ep_kernel<W::kBf16, false>, a, smem, blocks, s);
    else if (weight_kind == 1)
        err = act_fp8 ? launch_persistent(mega_ep_kernel<W::kE4m3, true>, a, smem, blocks, s)
                      : launch_persistent(mega_ep_kernel<W::kE4m3, false>, a, smem, blocks, s);
    else if (weight_kind == 2)
        err = act_fp8 ? launch_persistent(mega_ep_kernel<W::kFp4, true>, a, smem, blocks, s)
                      : launch_persistent(mega_ep_kernel<W::kFp4, false>, a, smem, blocks, s);
    return static_cast<int>(err);
}
