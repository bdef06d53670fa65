// The Hopper mainloop of the dense FP8 GEMM and the k-grouped FP8 weight
// gradient: wgmma from shared memory fed by TMA, warp-specialised and
// persistent.
//
// Replaces the Pallas mainloops of deepgemm_tpu/kernels/dense.py
// (_build_dense_gemm, pl.pallas_call at dense.py:291) for e4m3 operands
// under 'promote', and of deepgemm_tpu/kernels/k_grouped.py
// (_build_k_grouped, pl.pallas_call at k_grouped.py:237) for e4m3
// operands, with the f32 promotion of deepgemm_tpu/kernels/common.py:27-52:
//     acc += p * (sfa[m] * sfb[n])   for each 128-deep k block's product p.
// The 'dequant' forms, the bf16 operands and the bf16 k-grouped form stay on
// the mma.sync mainloop (gemm_mainloop.cuh).
//
// What bounds it on the H100: a large dense product is tensor-core bound (2
// x 4096^3 operations on 32 MiB of fp8: ~2000 operations a byte, against the
// card's ~590 fp8 operations a byte of HBM); only wgmma reaches the fp8
// rate (e4m3 mma.sync runs as f16 HMMA on sm_90a). The k-grouped wgrad of a
// training step does 256 operations a written output element: its output
// bytes bound it, so its epilogue writes whole lines while the next work
// item's loads are in flight.
//
// Design:
//   * A persistent grid of at most one block an SM walks the output tiles
//     (kBM x kBN; kBN = 128, kBM = 64 or 128), rasterised in bands of
//     kSwizzleM row tiles so that the blocks running at once share rows of A
//     and B in L2. A k-grouped work item is (group, row tile, column tile),
//     the groups one after another.
//   * One producer warp keeps TMA loads in flight into a ring of stages
//     (full and empty mbarriers a stage, the phase parity from a running
//     count that carries over from one work item to the next). A stage is
//     one 128-deep k block: A [kBM x 128] and B [kBN x 128] e4m3, 128-byte
//     swizzled, zero-filled by TMA past m, n and k, plus the stage's scales,
//     k-first rows copied in bulk beside them. The producer is one lane: an
//     earlier design copied m-major scales with 4-byte cp.async from all 32
//     lanes, whose arrivals reached the barrier thousands of cycles late
//     and whose 40 registers spilled. The k-grouped scales are k-first
//     already; the dense entry lays its scales out k-first in a pre-pass
//     (k_first_kernel) on the same stream.
//   * kBM / 64 consumer warpgroups (setmaxnreg moves registers from the
//     producer to them) each run four wgmma m64n128k32 e4m3 a stage into a
//     fresh f32 partial (scale-d 0 on the first), wait for it, and promote
//     it into the f32 accumulator with one FFMA an element: sfa per row,
//     sfb per 128 columns (gran_n >= 128, one value a tile) or per column.
//   * Planar FP4 B (128 packed bytes a row hold 256 codes: the low nibbles
//     k 0-127 of the group, the high nibbles k 128-255): the producer loads
//     a group's bytes for each of its two stages; the consumers decode nibble
//     plane kb & 1 to e4m3 in place (a packed byte's position is its code's,
//     so the swizzle carries over), fence the writes into the async proxy
//     and meet at a barrier before the wgmma. With B's (1, 128) scales as
//     per-column SFB this is bitwise the e4m3 kernel on the decoded codes.
//   * Epilogue: c (c[g] for the k-grouped kernel) is added once to the
//     finished f32 sum, so d with c is bitwise d without c, plus c. (The
//     k-grouped kernel once started its sum from c[g], as JAX's does: 32
//     more loads a thread at each tile's start, and the register pressure
//     corrupted one n8 slice of the in-flight wgmma partial now and then.)
//     Each warpgroup writes its 64 rows, rounded to bf16
//     or as f32, into a 128-byte swizzled shared tile (conflict-free from
//     the accumulator layout), and one thread hands it to TMA stores (a 3-D
//     tensor map [G, M, N] that clips at m and n), which drain while the
//     consumers go on to the next tile. Where an output row is not whole
//     16-byte chunks (a tensor map's stride cannot be), the warpgroup
//     stores the tile itself: 16-byte chunks, pairs at the ragged edge.
//   * k-grouped: group g's depth is k_size[g] (device memory: no call syncs
//     the host), its scale rows start at sf_start[g] (scales k-first [nsf,
//     m] and [nsf, n]), an empty group writes c (or zero). The TN form reads
//     A [m, ldk] and B [n, ldk] k-major, group g's columns from 128 x
//     sf_start[g], zero past its depth (kernels/k_grouped.py lays them out);
//     the flat form reads each group's k-major segment in place through a
//     tensor map of its own (device memory, one pair a group). Both put the
//     same bytes in every stage, so they are bitwise equal.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"

namespace dgt {
namespace sm90 {

constexpr int kBN = 128;               // output columns a tile
constexpr int kBK = 128;               // k bytes a stage (one scale block of e4m3)
constexpr int kSwizzleM = 8;           // row tiles a raster band
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;     // bytes a block may use on the H100
// a consumer thread holds two f32 sets of kBN / 2 (the 128-deep block's
// partial and the accumulator), with room left for addresses and scales
static_assert(2 * (kBN / 2) + 64 <= kConsumerRegs, "two register sets a consumer thread");

enum class Kind { kDense, kKGrouped, kKGroupedFlat };
// How B is scaled and stored: one scale per 128 or more rows of B (a single
// value a tile), one per fewer rows (per column of the tile), or planar FP4
// codes with per-row scales.
enum class BForm { kBlockScaled, kChannelScaled, kPlanarFp4 };

struct Args {
    int tma_store;           // 1: map_d holds the output (its rows are whole 16-byte chunks)
    // scales k-first, one row per 128-deep block: sfa [ksf or nsf, sfa_ld], one per row
    // of A; sfb [ksf or nsf, sfb_ld], one per gran_n rows of B (k-grouped: per row)
    const float* sfa;
    const float* sfb;
    int sfa_ld, sfb_ld;      // row strides: M and ceil(N / gran_n), rounded up to 4
    const float* c;          // f32 or nullptr: [M, N] or [G, M, N], added to the finished sum
    void* d;                 // OutT [M, N] or [G, M, N]
    int M, N;
    int num_kb;              // dense: 128-deep k blocks (ceil(K / 128))
    int sfb_shift;           // log2(gran_n) (k-grouped: 0)
    int num_groups;          // k-grouped: G (dense: 1)
    int num_stages;
    const int* k_size;       // k-grouped [G]: each group's depth
    const int* sf_start;     // k-grouped [G]: each group's first scale row
    const CUtensorMap* group_maps;   // flat: [G][2] tensor maps of A and B
};

template <int kBM, class OutT>
struct Plan {
    static constexpr int kWG = kBM / 64;                      // consumer warpgroups
    static constexpr int kThreads = (kWG + 1) * 128;
    static constexpr int kEpc = 16 / static_cast<int>(sizeof(OutT));     // outputs a 16-byte chunk
    static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(OutT));  // outputs a swizzle row
    static constexpr int kBoxes = kBN / kBoxCols;             // 128-byte column boxes a tile
    static constexpr int kStagingWG = kBoxes * 64 * 128;      // a warpgroup's staging tile
    static constexpr int kStageBytes = kBM * kBK + kBN * kBK + (kBM + kBN) * 4;
    static constexpr int kFixedBytes = 1024 + kWG * kStagingWG;   // alignment slack, staging
    // the k-grouped kernel adds a table of 8 bytes a group
    static int smem_bytes(int stages, int table_groups) {
        return kFixedBytes + stages * (kStageBytes + 16) + 8 * table_groups;
    }
};

// Byte offset of 16-byte chunk `chunk` of row r (0-63) in a warpgroup's
// staging tile: 128-byte column boxes of 64 rows, 128-byte swizzled as TMA
// reads them.
__device__ __forceinline__ int staging_offset(int r, int chunk) {
    return (chunk >> 3) * (64 * 128) + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    return done;
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Waits for the phase of parity `parity` to complete. A wait that outlasts
// kWaitLimitNs (a fault: a load that never lands, an arrival that never
// comes) traps, so the launch fails instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 20ull * 1000 * 1000 * 1000;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const uint64_t t0 = global_ns();
    for (uint32_t polls = 1; !mbar_try_wait(addr, parity); ++polls)
        if (polls % 64 == 0 && global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
           "r"(smem_u32(bar))
        : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16) from global to shared
// memory that completes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int x, int y,
                                             int z) {
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(x), "r"(y),
                    "r"(z)
                 : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// A K-major operand of 128-byte rows in shared memory, 128-byte swizzled in
// 8-row (1024-byte) atoms: the stride between atoms is 1024 bytes; the
// leading offset is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void fence_operand(float& r) {
    asm volatile("" : "+f"(r) :: "memory");
}

// d[64 x 128] (+)= a[64 x 32] . b[128 x 32]^T, e4m3 from shared memory,
// f32 in registers; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <class OutT>
__device__ __forceinline__ void store_pair(OutT* dst, float x, float y) {
    if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(x, y);
    } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
    }
}

// One work item: problem g (0 for dense), its output tile, its depth in
// 128-deep blocks.
struct Item {
    int g, m0, n0, num_kb;
};

// The first scale column of B a tile copies: the 16-byte chunk that holds
// column n0's scale.
__device__ __forceinline__ int sfb_first(const Args& p, int n0) {
    return (n0 >> p.sfb_shift) & ~3;
}

// The work item t: the groups one after another, each group's tiles in
// bands of kSwizzleM row tiles. k-grouped: each group's (128-deep blocks,
// first scale row) from the table the block copies into shared memory.
template <int kBM, Kind kKind>
__device__ __forceinline__ Item item_of(const Args& p, const int2* groups, int t, int tiles_m,
                                        int tiles_n) {
    const int per_group = tiles_m * tiles_n;
    const int g = t / per_group;
    const int r = t - g * per_group;
    const int band = kSwizzleM * tiles_n;
    const int first_m = (r / band) * kSwizzleM;
    const int rows = min(tiles_m - first_m, kSwizzleM);
    const int in = r - (r / band) * band;
    Item it;
    it.g = g;
    it.m0 = (first_m + in % rows) * kBM;
    it.n0 = (in / rows) * kBN;
    it.num_kb = kKind == Kind::kDense ? p.num_kb : groups[g].x;
    return it;
}

template <int kBM, class OutT, Kind kKind, BForm kBForm>
__global__ void __launch_bounds__(Plan<kBM, OutT>::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_d, const Args p) {
    using P = Plan<kBM, OutT>;
    constexpr int kWG = P::kWG;
    constexpr bool kKG = kKind != Kind::kDense;
    static_assert(!kKG || kBForm == BForm::kChannelScaled, "k-grouped: per-channel scales");
    extern __shared__ __align__(1024) uint8_t smem_raw[];

    // carve: A and B stages and the staging tiles (1024-aligned for the
    // swizzle), scales, barriers
    const int S = p.num_stages;
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* smem_a = base;
    uint8_t* smem_b = smem_a + S * kBM * kBK;
    uint8_t* staging = smem_b + S * kBN * kBK;
    float* sfa_s = reinterpret_cast<float*>(staging + kWG * P::kStagingWG);
    float* sfb_s = sfa_s + S * kBM;
    uint64_t* full = reinterpret_cast<uint64_t*>(sfb_s + S * kBN);
    uint64_t* empty = full + S;
    int2* groups = reinterpret_cast<int2*>(empty + S);

    if constexpr (kKG) {
        for (int g = threadIdx.x; g < p.num_groups; g += blockDim.x)
            groups[g] = make_int2((__ldg(p.k_size + g) + kBK - 1) / kBK, __ldg(p.sf_start + g));
    }
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full + s, 1);          // the producer's arrival, with the bytes it expects
            mbar_init(empty + s, kWG * 4);   // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int tiles_m = (p.M + kBM - 1) / kBM;
    const int tiles_n = (p.N + kBN - 1) / kBN;
    const int num_items = tiles_m * tiles_n * p.num_groups;
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;

    if (wg == kWG) {
        // ---- producer: one lane of the last warpgroup ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
        if (threadIdx.x % 128 != 0) return;
        if constexpr (kKind != Kind::kKGroupedFlat) {
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
        }
        int s = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
            const Item it = item_of<kBM, kKind>(p, groups, t, tiles_m, tiles_n);
            const CUtensorMap* ma = &map_a;
            const CUtensorMap* mb = &map_b;
            int col0 = 0, sf0 = 0;
            if constexpr (kKG) sf0 = groups[it.g].y;
            if constexpr (kKind == Kind::kKGrouped) col0 = sf0 * kBK;
            if constexpr (kKind == Kind::kKGroupedFlat) {
                ma = p.group_maps + 2 * it.g;
                mb = ma + 1;
            }
            // the stage's scales: a k-first row each, whole 16-byte chunks
            // (the rows' stride is; a row or column of the tile past the
            // live part keeps stale scales, and its outputs are never stored)
            const int sa_n = min(kBM, p.sfa_ld - it.m0);
            const int sb_col = sfb_first(p, it.n0);
            const int sb_n = min((((it.n0 + kBN - 1) >> p.sfb_shift) - sb_col + 4) & ~3,
                                 p.sfb_ld - sb_col);
            for (int kb = 0; kb < it.num_kb; ++kb) {
                mbar_wait(empty + s, phase ^ 1);
                mbar_arrive_expect_tx(full + s, (kBM + kBN) * kBK + 4 * (sa_n + sb_n));
                tma_load_2d(smem_a + s * kBM * kBK, ma, full + s, col0 + kb * kBK, it.m0);
                const int col_b = kBForm == BForm::kPlanarFp4 ? (kb >> 1) * kBK : col0 + kb * kBK;
                tma_load_2d(smem_b + s * kBN * kBK, mb, full + s, col_b, it.n0);
                const int64_t row = sf0 + kb;
                bulk_load(sfa_s + s * kBM, p.sfa + row * p.sfa_ld + it.m0, 4 * sa_n, full + s);
                bulk_load(sfb_s + s * kBN, p.sfb + row * p.sfb_ld + sb_col, 4 * sb_n, full + s);
                if (++s == S) { s = 0; phase ^= 1; }
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;     // the thread's rows: r0, r0 + 8
    const int q = 2 * (lane % 4);                       // its columns: 8 j + q, 8 j + q + 1
    OutT* const dst_all = static_cast<OutT*>(p.d);
    uint8_t* const stage_out = staging + wg * P::kStagingWG;
    constexpr int kEpc = P::kEpc;
    constexpr int kCpr = kBN / kEpc;                                // chunks a row

    float acc[kBN / 2], part[kBN / 2];
    #pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
        const Item it = item_of<kBM, kKind>(p, groups, t, tiles_m, tiles_n);
        const int64_t out_off = static_cast<int64_t>(it.g) * p.M * p.N;

        #pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;

        for (int kb = 0; kb < it.num_kb; ++kb) {
            mbar_wait(full + s, phase);
            uint8_t* sb_tile = smem_b + s * kBN * kBK;
            if constexpr (kBForm == BForm::kPlanarFp4) {
                // nibble plane kb & 1 of the packed group, decoded to e4m3 in place
                uint4* words = reinterpret_cast<uint4*>(sb_tile);
                for (int i = threadIdx.x; i < kBN * kBK / 16; i += kWG * 128) {
                    uint4 w = words[i];
                    w.x = fp4x4_to_e4m3x4(w.x, kb & 1);
                    w.y = fp4x4_to_e4m3x4(w.y, kb & 1);
                    w.z = fp4x4_to_e4m3x4(w.z, kb & 1);
                    w.w = fp4x4_to_e4m3x4(w.w, kb & 1);
                    words[i] = w;
                }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                named_barrier(1, kWG * 128);
            }
            const uint64_t da = smem_desc(smem_a + s * kBM * kBK + wg * 64 * kBK);
            const uint64_t db = smem_desc(sb_tile);
            #pragma unroll
            for (int i = 0; i < 64; ++i) fence_operand(part[i]);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            #pragma unroll
            for (int k = 0; k < kBK / 32; ++k)
                wgmma_m64n128k32(part, da + 2 * k, db + 2 * k, k);   // +32 bytes: +2 in 16-byte units
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            #pragma unroll
            for (int i = 0; i < 64; ++i) fence_operand(part[i]);
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

            // promote: acc += p * (sfa[row] * sfb[col])
            const float* sa = sfa_s + s * kBM;
            const float* sb = sfb_s + s * kBN;
            const float sa0 = sa[r0], sa1 = sa[r0 + 8];
            if constexpr (kBForm == BForm::kBlockScaled) {
                const float b = sb[(it.n0 >> p.sfb_shift) - sfb_first(p, it.n0)];
                const float s0 = sa0 * b, s1 = sa1 * b;
                #pragma unroll
                for (int j = 0; j < 16; ++j) {
                    acc[4 * j] = fmaf(part[4 * j], s0, acc[4 * j]);
                    acc[4 * j + 1] = fmaf(part[4 * j + 1], s0, acc[4 * j + 1]);
                    acc[4 * j + 2] = fmaf(part[4 * j + 2], s1, acc[4 * j + 2]);
                    acc[4 * j + 3] = fmaf(part[4 * j + 3], s1, acc[4 * j + 3]);
                }
            } else if (p.sfb_shift == 0) {
                #pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const float2 b2 = *reinterpret_cast<const float2*>(sb + 8 * j + q);
                    acc[4 * j] = fmaf(part[4 * j], sa0 * b2.x, acc[4 * j]);
                    acc[4 * j + 1] = fmaf(part[4 * j + 1], sa0 * b2.y, acc[4 * j + 1]);
                    acc[4 * j + 2] = fmaf(part[4 * j + 2], sa1 * b2.x, acc[4 * j + 2]);
                    acc[4 * j + 3] = fmaf(part[4 * j + 3], sa1 * b2.y, acc[4 * j + 3]);
                }
            } else {
                // one scale per 2 to 64 rows of B: a column's scale by its index
                const int first = sfb_first(p, it.n0);
                #pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const int col = it.n0 + 8 * j + q;
                    const float b0 = sb[(col >> p.sfb_shift) - first];
                    const float b1 = sb[((col + 1) >> p.sfb_shift) - first];
                    acc[4 * j] = fmaf(part[4 * j], sa0 * b0, acc[4 * j]);
                    acc[4 * j + 1] = fmaf(part[4 * j + 1], sa0 * b1, acc[4 * j + 1]);
                    acc[4 * j + 2] = fmaf(part[4 * j + 2], sa1 * b0, acc[4 * j + 2]);
                    acc[4 * j + 3] = fmaf(part[4 * j + 3], sa1 * b1, acc[4 * j + 3]);
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s);
            if (++s == S) { s = 0; phase ^= 1; }
        }

        // epilogue: c added once to the finished sum, rounded, staged, stored;
        // first the staging tile must be free: the last tile's TMA stores
        // have read it, or this warpgroup's own stores are done
        if (p.tma_store && tid == 0)
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_barrier(2 + wg, 128);
        #pragma unroll
        for (int j = 0; j < 16; ++j)
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 - wg * 64 + 8 * h, cl = 8 * j + q;
                float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
                if (p.c != nullptr) {
                    const int row = it.m0 + wg * 64 + r, col = it.n0 + cl;
                    if (row < p.M && col < p.N) {
                        const float2 cv = __ldg(reinterpret_cast<const float2*>(
                            p.c + out_off + static_cast<int64_t>(row) * p.N + col));
                        x = __fadd_rn(x, cv.x);
                        y = __fadd_rn(y, cv.y);
                    }
                }
                const int byte = cl * static_cast<int>(sizeof(OutT));
                store_pair(reinterpret_cast<OutT*>(stage_out + staging_offset(r, byte >> 4) +
                                                   (byte & 15)),
                           x, y);
            }
        if (p.tma_store) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            named_barrier(2 + wg, 128);
            if (tid == 0) {
                #pragma unroll
                for (int box = 0; box < P::kBoxes; ++box)
                    tma_store_3d(&map_d, stage_out + box * 64 * 128,
                                 it.n0 + box * P::kBoxCols, it.m0 + wg * 64, it.g);
                asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            }
            continue;
        }
        named_barrier(2 + wg, 128);
        OutT* const dst = dst_all + out_off;
        for (int i = tid; i < 64 * kCpr; i += 128) {
            const int r = i / kCpr, ch = i % kCpr;
            const int row = it.m0 + wg * 64 + r, col = it.n0 + ch * kEpc;
            if (row >= p.M) continue;
            const uint8_t* src = stage_out + staging_offset(r, ch);
            OutT* out = dst + static_cast<int64_t>(row) * p.N + col;
            if (col + kEpc <= p.N && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
                *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
            } else {
                // a chunk off 16-byte alignment, or the ragged edge: pairs (N is even)
                #pragma unroll
                for (int e = 0; e < kEpc; e += 2) {
                    if (col + e >= p.N) break;
                    if constexpr (sizeof(OutT) == 2)
                        *reinterpret_cast<uint32_t*>(out + e) =
                            *reinterpret_cast<const uint32_t*>(src + 2 * e);
                    else
                        *reinterpret_cast<uint2*>(out + e) =
                            *reinterpret_cast<const uint2*>(src + 4 * e);
                }
            }
        }
    }
    if (p.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The dense kernel's scales k-first, as the producer copies them: sfa [m,
// ksf] -> sfa_k [ksf, sfa_ld] and sfb [nsf, ksf] -> sfb_k [ksf, sfb_ld], zero
// in the pad columns; one thread an output element.
__global__ void k_first_kernel(const float* __restrict__ sfa, const float* __restrict__ sfb,
                               float* __restrict__ sfa_k, float* __restrict__ sfb_k, int m,
                               int nsf, int ksf, int sfa_ld, int sfb_ld) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t na = static_cast<int64_t>(ksf) * sfa_ld;
    if (i < na) {
        const int kb = static_cast<int>(i / sfa_ld), r = static_cast<int>(i % sfa_ld);
        sfa_k[i] = r < m ? __ldg(sfa + static_cast<int64_t>(r) * ksf + kb) : 0.f;
    } else if (i < na + static_cast<int64_t>(ksf) * sfb_ld) {
        const int64_t j = i - na;
        const int kb = static_cast<int>(j / sfb_ld), r = static_cast<int>(j % sfb_ld);
        sfb_k[j] = r < nsf ? __ldg(sfb + static_cast<int64_t>(r) * ksf + kb) : 0.f;
    }
}

// ---- host side: tensor maps and launches ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link to libcuda.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult status;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                    &status) == cudaSuccess &&
            status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// A byte matrix [rows, row_bytes] with row stride ld bytes, read in boxes of
// box_rows x 128 bytes, 128-byte swizzled; zero past its edges.
inline bool make_map(CUtensorMap* map, const void* base, uint64_t row_bytes, uint64_t rows,
                     uint64_t ld, uint32_t box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {row_bytes, rows};
    const cuuint64_t strides[1] = {ld};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The output d [G, M, N] (bf16 or f32) for TMA stores of 64-row boxes of
// 128 bytes, 128-byte swizzled. False where a row is not whole 16-byte
// chunks: the kernel then stores the tile itself.
inline bool make_out_map(CUtensorMap* map, void* d, uint64_t n, uint64_t m, uint64_t groups,
                         int out_f32) {
    const EncodeTiled encode = encode_tiled();
    const uint64_t elem = out_f32 ? 4 : 2;
    if (encode == nullptr || (n * elem) % 16 != 0) return false;
    const cuuint64_t dims[3] = {n, m, groups};
    const cuuint64_t strides[2] = {n * elem, n * m * elem};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem), 64, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, d, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kBM, class OutT, Kind kKind, BForm kBForm>
inline cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
                          const CUtensorMap& map_d, const Args& p, int num_sms,
                          cudaStream_t stream) {
    using P = Plan<kBM, OutT>;
    const int smem = P::smem_bytes(p.num_stages, kKind == Kind::kDense ? 0 : p.num_groups);
    if (p.num_stages < 2 || smem > kSmemLimit) return cudaErrorInvalidValue;
    auto kernel = gemm_kernel<kBM, OutT, kKind, kBForm>;
    // the instance's shared memory, opted in once a device
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !opted_in[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
        if (err != cudaSuccess) return err;
        if (dev < 64) opted_in[dev] = true;
    }
    const long long items = static_cast<long long>((p.M + kBM - 1) / kBM) *
                            ((p.N + kBN - 1) / kBN) * p.num_groups;
    const int grid = static_cast<int>(items < num_sms ? items : num_sms);
    if (grid == 0) return cudaSuccess;
    kernel<<<grid, P::kThreads, smem, stream>>>(map_a, map_b, map_d, p);
    return cudaGetLastError();
}

// The instance of block_m (64 or 128) and the output type, with the
// output's tensor map where its rows allow one.
template <Kind kKind, BForm kBForm>
inline cudaError_t launch_any(const CUtensorMap& map_a, const CUtensorMap& map_b, Args p,
                              int block_m, int out_f32, int num_sms, cudaStream_t stream) {
    CUtensorMap map_d = {};
    p.tma_store = make_out_map(&map_d, p.d, p.N, p.M, p.num_groups, out_f32) ? 1 : 0;
    if (block_m == 128)
        return out_f32
            ? launch<128, float, kKind, kBForm>(map_a, map_b, map_d, p, num_sms, stream)
            : launch<128, __nv_bfloat16, kKind, kBForm>(map_a, map_b, map_d, p, num_sms, stream);
    if (block_m == 64)
        return out_f32
            ? launch<64, float, kKind, kBForm>(map_a, map_b, map_d, p, num_sms, stream)
            : launch<64, __nv_bfloat16, kKind, kBForm>(map_a, map_b, map_d, p, num_sms, stream);
    return cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace dgt

#ifndef DGT_ERROR_STRING_DEFINED
#define DGT_ERROR_STRING_DEFINED
extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
