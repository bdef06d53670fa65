// The fused MoE expert block on Hopper (L1 gate|up, SwiGLU with clamp and
// row weight, optional fp8 requant, L2), one body for the one-rank kernel
// (mega_local.cu, #13) and the expert-parallel kernel (mega_ep.cu, #14), so
// that a row's bits are the same in both. Where a tile's rows come from and
// where their results go is the caller's Rows (LocalRows here, EpRows in
// mega_ep.cu):
//   items()          the work items, (expert, tile of up to kN token rows)
//   item(t)          item t: its expert, its first row and its live rows (a
//                    prefix of the tile; the rest read as zero, are never
//                    stored and do not touch a live row's bits)
//   wait(it, state)  one consumer thread, before an item's rows are read:
//                    they have landed (the EP kernel's slabs)
//   x_row, sf_row    a row's token bytes and scales, read by load16 and
//                    sf_load (through L2 where peers stored them)
//   rw_of, y_row     a row's top-k weight and where its bf16 result goes
//
// Design (the hopper-kernels guide's shape):
//   * Weights on wgmma's M, tokens on N: an item's kN = 40 token rows are
//     the N of every wgmma (m64n40k16, 16-bit products, f32 sums), so one
//     instruction shape serves both entries and a row's sums never depend on
//     how many rows share its tile or where it sits in it (each output
//     column is its own dot product; tiles of 48 rows give the same bits).
//     One item streams its expert's weights once: cap 40 (DeepSeek-V3
//     serving) is one item an expert, and the EP kernel's received rows are
//     ceil(rows / kN) items, the tiles of an expert on neighbouring blocks
//     so their weight tiles are read from L2 after the first.
//   * A persistent grid, one block an SM: two consumer warpgroups, a
//     producer warp and a widening warp (320 threads). A 3-stage ring: a
//     stage is 256 weight rows x 128 bytes of k (L1: 128 gate and the same
//     128 up columns, so one thread holds gate and up of an element; L2:
//     256 output columns), the item's token rows (a 16-bit tile of two
//     128-byte swizzled boxes of kN rows, the wgmma's B, and a box where
//     e4m3 rows land) and their 128-deep block's scales. One producer lane
//     issues TMA loads through 3-D maps [E, rows, k] for the weights (zero
//     past the rows) and 2-D maps over the block's scratch for the tokens,
//     and one bulk copy for the scales; the widening warp widens a stage's
//     e4m3 tokens exactly into f16 (one conversion a pair) and arrives on
//     the stage's tokens_ready. The barriers sit in the dynamic shared
//     memory.
//   * At an item's start the consumers gather its rows into the block's
//     scratch as they are (e4m3 x, or bf16 for bf16 weights) and their
//     scales k-first, fence them into the async proxy and arrive on
//     x_ready, which the producer waits for: one pass over the rows an item.
//     The rows are re-read once an L1 tile from there, act once an L2 tile,
//     so the scratch keeps them in their narrowest exact type. (A design
//     that copied each row's 128 bytes a stage with its own bulk copy, 40
//     copies a stage, took 4.5 ms of #13's 5.3 without any weight load; one
//     that kept the rows widened to 16 bits in the scratch re-read twice
//     the bytes.)
//   * Arithmetic, as the mma.sync body computed it but for the sum order
//     inside a 128-deep k block: e4m3 weights (and FP4, decoded to e4m3 in
//     place first) are widened exactly into wgmma's register A, to f16 where
//     the tokens are e4m3 codes (L1's x, L2's fp8 act) and to bf16 against
//     bf16 act (its bits moved into a bf16 and multiplied by 2^120), never
//     e4m3 wgmma (its reduced-precision sums moved the mesh forward 1e-3
//     from the plain path); the products are exact either way and summed in
//     f32. Each 128-deep block's partial is promoted as acc += (p * sfw) *
//     sfx (L2: acc += p * sfw, times the act scale with fp8 act), each step
//     rounded (no FMA); bf16 weights take wgmma's shared-memory A and one
//     f32 sum. A warpgroup's two 64-row blocks of a stage (L1: its gate rows
//     and its up rows) each sum into a partial of their own, each k16 step's
//     A built while the step before runs (ptxas gives a thread 168
//     registers: a warp scheduler holds three of the block's ten warps).
//   * act between L1 and L2 stays in the block's L2-resident scratch (kN
//     rows, bf16, or e4m3 with fp8 act, its scales in shared memory): 40
//     rows of bf16 act at I = 2048 are 160 KB, which leave no room for a
//     ring. The L1 epilogue stores it (a row's fp8 amax over 128 columns
//     crosses lanes by shuffles and the 8 consumer warps through shared
//     memory), fences it into the async proxy and arrives on act_ready,
//     which the producer waits for before L2's loads.
// What bounds it on the H100: each item streams its expert's weights (44 MB
// e4m3 at DeepSeek-V3 widths) against kN token rows: ~80 operations a weight
// byte, under the bf16 rate's ~295, so HBM's 3.35 TB/s bounds it.

#pragma once

#include <cuda_fp8.h>

#include "gemm_sm90.cuh"

namespace dgt {
namespace mega {

using sm90::bulk_load;
using sm90::fence_all;
using sm90::mbar_arrive;
using sm90::mbar_arrive_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_barrier;
using sm90::smem_desc;
using sm90::smem_u32;
using sm90::tma_load_2d;
using sm90::tma_load_3d;

constexpr int kN = 40;                 // token rows of an item: wgmma's N
constexpr int kStages = 3;             // the ring (a 4th stage bought no time at I = 2048)
constexpr int kWG = 2;                 // consumer warpgroups
constexpr int kConsumers = kWG * 128;
constexpr int kThreads = kConsumers + 64;   // the producer warp and the widening warp
constexpr int kBK = 128;               // bytes of k a stage row
constexpr int kWBytes = 256 * kBK;     // a stage's weight rows
constexpr int kXBytes = 2 * kN * kBK;  // a stage's token tile: two 16-bit boxes of kN rows
constexpr int kRawBytes = kN * kBK;    // a stage's e4m3 token box as it lands
constexpr int kSfBytes = 256;          // a stage's token scales (kN floats)
__host__ __device__ constexpr int align1024(int v) { return (v + 1023) & ~1023; }
constexpr int kStageBytes = align1024(kWBytes + kXBytes + kRawBytes + kSfBytes);
constexpr int kFixedBytes = 1024 + kStages * kStageBytes + 2 * 8 * kN * 4 + kN * 4 + kN * 8 +
                            (3 * kStages + 2) * 8;
static_assert(kN % 8 == 0 && kN <= 256 && (kN * 4) % 16 == 0, "wgmma's N; the scales' bulk copy");
static_assert(kSfBytes >= kN * 4, "the stage's token scales");

// Shared memory of an instance: the ring, the amax partials, row weights,
// result rows, barriers, then act's scales [kN, I/128] (every instance
// keeps their room).
__host__ __device__ constexpr int smem_bytes(int inter) {
    return kFixedBytes + kN * (inter / 128) * 4;
}

// The block scratch of `rows` token rows (kN a block): act [rows, I] (bf16,
// or e4m3 with fp8 act), x [rows, H] (e4m3, or bf16 for bf16 weights) and
// x's scales [rows / kN][H/128][kN] f32, one after another.
__host__ __device__ constexpr int64_t scratch_bytes(int64_t rows, int hidden, int inter,
                                                    int x_bytes, int act_bytes) {
    return rows * (static_cast<int64_t>(act_bytes) * inter + x_bytes * hidden + 4 * (hidden / 128));
}

enum class W { kBf16, kE4m3, kFp4 };

struct Args {
    const float* w1sf;      // [E, 2I/128, H/128] (scaled)
    const float* w2sf;      // [E, H/128, I/128]
    uint8_t* act;           // the scratch (scratch_bytes): act [gridDim.x kN, I],
    uint8_t* xs;            //   x [gridDim.x kN, H],
    float* sfs;             //   x's scales [gridDim.x, H/128, kN]
    int hidden, inter;
    int silu_tanh;          // 1: x * (0.5 tanh(x/2) + 0.5); 0: x / (1 + exp(-x))
    float clamp;            // silu(gate) * up is clipped at +-clamp
};

struct Item {
    int e, r0, live;        // expert, first row, live rows (at most kN)
};

// The one-rank kernel's rows: item (e, tile) is rows tile kN .. of expert
// e's cap slot rows in the wrapper's [E, cap, .] arrays.
struct LocalRows {
    const uint8_t* x;       // [E, cap, H] e4m3 (bf16 for W::kBf16)
    const float* xsf;       // [E, cap, H/128] f32
    const float* rw;        // [E, cap] f32
    __nv_bfloat16* y;       // [E, cap, H]
    int experts, cap, tiles, hidden;
    int64_t x_row_bytes;
    struct State {};
    __device__ __forceinline__ int items() const { return experts * tiles; }
    __device__ __forceinline__ Item item(int t) const {
        const int e = t / tiles, r0 = (t - e * tiles) * kN;
        return {e, r0, min(kN, cap - r0)};
    }
    __device__ __forceinline__ void wait(const Item&, State&) const {}
    __device__ __forceinline__ int64_t row(const Item& it, int n) const {
        return static_cast<int64_t>(it.e) * cap + it.r0 + n;
    }
    __device__ __forceinline__ const uint8_t* x_row(const Item& it, int n) const {
        return x + row(it, n) * x_row_bytes;
    }
    __device__ __forceinline__ const float* sf_row(const Item& it, int n) const {
        return xsf + row(it, n) * (hidden / 128);
    }
    __device__ __forceinline__ uint4 load16(const uint8_t* p) const {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ float sf_load(const float* p) const { return __ldg(p); }
    __device__ __forceinline__ float rw_of(const Item& it, int n) const {
        return __ldg(rw + row(it, n));
    }
    __device__ __forceinline__ __nv_bfloat16* y_row(const Item& it, int n) const {
        return y + row(it, n) * hidden;
    }
};

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float silu(float g, int tanh_form) {
    if (tanh_form) return __fmul_rn(g, __fadd_rn(__fmul_rn(0.5f, tanhf(__fmul_rn(0.5f, g))), 0.5f));
    return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

// wgmma m64nNk16 into f32, f16 (kF16) or bf16 products: A from registers
// (the m16n8k16 A fragment of each warp's 16 rows) or from shared memory, B
// (the token tile) k-major in shared memory; scale_d 0 overwrites d.
#define MEGA_O4(d, o) "+f"(d[(o)]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3])
#define MEGA_O20(d) MEGA_O4(d, 0), MEGA_O4(d, 4), MEGA_O4(d, 8), MEGA_O4(d, 12), MEGA_O4(d, 16)
#define MEGA_D20 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}"
#define MEGA_WGMMA(n, t) "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32." t "." t " "
#define MEGA_MMA40(T)                                                                          \
    __device__ __forceinline__ static void rs(float (&d)[20], const uint32_t (&a)[4],           \
                                              uint64_t db, int scale_d) {                      \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n" MEGA_WGMMA(40, T) MEGA_D20  \
                     ", {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"                            \
                     : MEGA_O20(d)                                                             \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));    \
    }                                                                                          \
    __device__ __forceinline__ static void ss(float (&d)[20], uint64_t da, uint64_t db,         \
                                              int scale_d) {                                   \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n" MEGA_WGMMA(40, T) MEGA_D20  \
                     ", %20, %21, p, 1, 1, 0, 0;\n}\n"                                          \
                     : MEGA_O20(d) : "l"(da), "l"(db), "r"(scale_d));                          \
    }
template <int kCols, bool kF16>
struct Mma;
template <> struct Mma<40, false> { MEGA_MMA40("bf16") };
template <> struct Mma<40, true> { MEGA_MMA40("f16") };

#undef MEGA_MMA40
#undef MEGA_WGMMA
#undef MEGA_O4
#undef MEGA_O20
#undef MEGA_D20

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e]) :: "memory");
}

// Two e4m3 codes (the low 16 bits of w) as f16x2, exact.
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t w) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu),
                                                     __NV_E4M3);
    return static_cast<uint32_t>(h.x) | static_cast<uint32_t>(h.y) << 16;
}

// 2^120 in both halves of a bf16x2 (sm90::kWidenUnit).
constexpr uint32_t kUnitBf16x2 = 0x7B807B80u;

// The A fragment of k16 step v of a warp's rows rr and rr + 8 of the
// 64-row block at ``rows64`` (e4m3 codes, 128-byte swizzled; the thread's
// pairs are bytes q and q + 1 of each 8), each code widened exactly: to f16
// (kF16: one conversion a pair) or to bf16 (its bits moved into a bf16 and
// multiplied by 2^120, as widen_body widens its A).
template <bool kF16>
__device__ __forceinline__ void build_a(const uint8_t* rows64, int rr, int q, int v,
                                        uint32_t (&af)[4]) {
    const uint8_t* row = rows64 + rr * kBK;
    auto pair = [&](uint32_t lo, uint32_t hi) -> uint32_t {
        if constexpr (kF16) {
            uint32_t b;
            asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(b) : "r"(lo), "r"(hi), "r"(q | (q + 1) << 4));
            return e4m3x2_to_f16x2(b);
        } else {
            return mul_bf16x2(sm90::e4m3x2_bits(lo, hi, sm90::pair_selector(q)), kUnitBf16x2);
        }
    };
    const int off = (v ^ (rr & 7)) << 4;
    const uint4 x = *reinterpret_cast<const uint4*>(row + off);
    const uint4 y = *reinterpret_cast<const uint4*>(row + 8 * kBK + off);
    af[0] = pair(x.x, x.y);
    af[1] = pair(y.x, y.y);
    af[2] = pair(x.z, x.w);
    af[3] = pair(y.z, y.w);
}

// p0, p1 = the 128-deep block sums of a warpgroup's two 64-row blocks at
// rows0 and rows1 (e4m3, 128-byte swizzled) against the token tile db (two
// 16-bit boxes of kN rows): eight k16 steps of wgmma a block with A from
// registers, each step's A built while the step before runs (two sets of A
// registers); waited for.
template <bool kF16, int kAcc>
__device__ __forceinline__ void block_sums(float (&p0)[kAcc], float (&p1)[kAcc],
                                           const uint8_t* rows0, const uint8_t* rows1, uint64_t db,
                                           int rr, int q) {
    using M = Mma<kN, kF16>;
    uint32_t a[2][4];
    #pragma unroll
    for (int r = 0; r < 16; ++r) {
        const int step = r % 8;                      // the k16 step of the block
        float (&p)[kAcc] = r < 8 ? p0 : p1;
        if (r >= 2) {
            // the step before last is done: its A registers may be rebuilt
            sm90::wgmma_wait<1>();
            fence_regs(a[r & 1]);
        }
        build_a<kF16>(r < 8 ? rows0 : rows1, rr, q, step, a[r & 1]);
        fence_all(p);
        wgmma_fence();
        // step s of the block: box (s / 4) of the tile, +32 bytes a step
        M::rs(p, a[r & 1], db + (((step >> 2) * kN * kBK + (step & 3) * 32) >> 4), step > 0);
        wgmma_commit();
        fence_all(p);
    }
    sm90::wgmma_wait<0>();
    // after the wait: no read of the sums moves above it, and A's registers,
    // which the wgmma reads until it completes, stay as they are until here
    fence_all(p0);
    fence_all(p1);
    fence_regs(a[0]);
    fence_regs(a[1]);
}

// Planar FP4 codes of nibble plane ``plane`` decoded to e4m3 in place, in
// `bytes` bytes at p (this warpgroup's rows of a stage; a packed byte's
// position is its code's, so the swizzle carries over).
__device__ __forceinline__ void decode_fp4(uint8_t* p, int bytes, int plane, int tid) {
    uint4* w = reinterpret_cast<uint4*>(p);
    for (int i = tid; i < bytes / 16; i += 128) {
        uint4 v = w[i];
        v.x = fp4x4_to_e4m3x4(v.x, plane);
        v.y = fp4x4_to_e4m3x4(v.y, plane);
        v.z = fp4x4_to_e4m3x4(v.z, plane);
        v.w = fp4x4_to_e4m3x4(v.w, plane);
        w[i] = v;
    }
}

// An item's rows into the block's scratch, by the consumers: x [kN, H] as
// it is (four 16-byte chunks a lane in flight) and its scales k-first
// [H/128, kN]; rows at or past the live ones zero.
template <bool kScaled, class Rows>
__device__ __forceinline__ void gather(const Rows& rows, const Item& it, uint8_t* xs, float* sfs,
                                       int hidden, int ctid) {
    constexpr int kIn = 4;                           // chunks a lane has in flight
    const int warp = ctid / 32, lane = ctid % 32;
    const int chunks = hidden * (kScaled ? 1 : 2) / 16;     // 16-byte chunks of a source row
    for (int n = warp; n < kN; n += kConsumers / 32) {
        const uint8_t* src = n < it.live ? rows.x_row(it, n) : nullptr;
        uint8_t* dst = xs + static_cast<int64_t>(n) * chunks * 16;
        for (int c0 = lane; c0 < chunks; c0 += 32 * kIn) {
            uint4 v[kIn];
            #pragma unroll
            for (int u = 0; u < kIn; ++u) {
                const int c = c0 + 32 * u;
                v[u] = src != nullptr && c < chunks ? rows.load16(src + 16 * c)
                                                    : make_uint4(0, 0, 0, 0);
            }
            #pragma unroll
            for (int u = 0; u < kIn; ++u) {
                const int c = c0 + 32 * u;
                if (c >= chunks) break;
                *reinterpret_cast<uint4*>(dst + 16 * c) = v[u];
            }
        }
    }
    if constexpr (kScaled) {
        for (int i = ctid; i < kN * (hidden / 128); i += kConsumers) {
            const int kb = i / kN, n = i - kb * kN;
            sfs[i] = n < it.live ? rows.sf_load(rows.sf_row(it, n) + kb) : 0.f;
        }
    }
}

template <W kW, bool kActFp8, class Rows>
__device__ __forceinline__ void mega_body(const CUtensorMap& map_w1, const CUtensorMap& map_w2,
                                          const CUtensorMap& map_act, const CUtensorMap& map_x,
                                          const Args& p, const Rows& rows) {
    constexpr bool kScaled = kW != W::kBf16;
    constexpr bool kFp4 = kW == W::kFp4;
    constexpr bool kActBf16 = kScaled && !kActFp8;    // no bf16 round trip, no requant
    constexpr int kAcc = kN / 2;                      // accumulator registers of an m64 block
    using M = Mma<kN, false>;                         // bf16 weights: A from shared memory
    extern __shared__ __align__(1024) uint8_t smem_raw[];

    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    float* red = reinterpret_cast<float*>(ring + kStages * kStageBytes);   // [2][8 warps][kN]
    float* rw_s = red + 2 * 8 * kN;
    __nv_bfloat16** ytab = reinterpret_cast<__nv_bfloat16**>(rw_s + kN);
    uint64_t* full = reinterpret_cast<uint64_t*>(ytab + kN);
    uint64_t* empty = full + kStages;
    uint64_t* act_ready = empty + kStages;
    uint64_t* x_ready = act_ready + 1;
    uint64_t* tokens_ready = x_ready + 1;
    float* act_sf = reinterpret_cast<float*>(tokens_ready + kStages);   // [kN][I/128]

    const int H = p.hidden, I = p.inter;
    const int ksf1 = H / 128, ksf2 = I / 128;
    const int kt1 = H * (kScaled ? 1 : 2) / kBK;      // stages of an L1 tile
    const int kt2 = I * (kScaled ? 1 : 2) / kBK;      // stages of an L2 tile
    const int nt1 = I / 128, nt2 = (H + 255) / 256;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + s, 1);                   // the producer's arrival and its bytes
            mbar_init(empty + s, kWG * 4);            // one arrival a consumer warp
        }
        mbar_init(act_ready, kWG * 4);
        mbar_init(x_ready, kWG * 4);
        for (int s = 0; s < kStages; ++s) mbar_init(tokens_ready + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int num_items = rows.items();
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int row0 = blockIdx.x * kN;                 // the block's rows of the scratch

    // a stage's tokens: e4m3 codes land in the raw box and the widening warp
    // widens them into the token tile (L1's x; L2's fp8 act), 16-bit ones
    // land in the tile as they are (bf16 act: two boxes of 64 values; the
    // bf16 weights' stages of 64 values: one box)
    constexpr bool kRaw1 = kScaled, kRaw2 = kActFp8;
    constexpr int kBoxes2 = kActBf16 ? 2 : 1;
    if (threadIdx.x >= kConsumers + 32) {
        // ---- the widening warp: every stage in order ----
        int s = 0;
        uint32_t phase = 0;
        auto widen = [&](bool raw) {
            uint8_t* tile = ring + s * kStageBytes + kWBytes;
            mbar_wait(full + s, phase);
            if (raw) {
                // chunk j of row n (16 codes, 128-byte swizzled) into f16
                // chunks 2 (j % 4) and + 1 of box j / 4
                const uint8_t* src = tile + kXBytes;
                #pragma unroll
                for (int i = 0; i < kN * 8 / 32; ++i) {
                    const int c = lane + 32 * i, n = c >> 3, j = c & 7;
                    const uint4 v = *reinterpret_cast<const uint4*>(src + n * kBK +
                                                                    ((j ^ (n & 7)) << 4));
                    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
                    uint32_t o[8];
                    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        o[2 * e] = e4m3x2_to_f16x2(in[e]);
                        o[2 * e + 1] = e4m3x2_to_f16x2(in[e] >> 16);
                    }
                    uint8_t* dst = tile + (j >> 2) * kN * kBK + n * kBK;
                    const int cc = 2 * (j & 3);
                    *reinterpret_cast<uint4*>(dst + ((cc ^ (n & 7)) << 4)) =
                        make_uint4(o[0], o[1], o[2], o[3]);
                    *reinterpret_cast<uint4*>(dst + (((cc + 1) ^ (n & 7)) << 4)) =
                        make_uint4(o[4], o[5], o[6], o[7]);
                }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(tokens_ready + s);
            if (++s == kStages) { s = 0; phase ^= 1; }
        };
        for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
            for (int g = 0; g < nt1 * kt1; ++g) widen(kRaw1);
            for (int g = 0; g < nt2 * kt2; ++g) widen(kRaw2);
        }
        return;
    }
    if (threadIdx.x >= kConsumers) {
        // ---- producer: one lane ----
        if (threadIdx.x != kConsumers) return;
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&map_w1)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&map_w2)) : "memory");
        const float* sfs = p.sfs + static_cast<int64_t>(blockIdx.x) * ksf1 * kN;
        const uint32_t l1_bytes = kWBytes + kN * kBK + (kScaled ? kN * 4 : 0);
        int s = 0;
        uint32_t phase = 0, done = 0;
        for (int t = blockIdx.x; t < num_items; t += gridDim.x, ++done) {
            const Item it = rows.item(t);
            // L1 reads the rows the consumers gathered for this item
            mbar_wait(x_ready, done & 1);
            for (int t1 = 0; t1 < nt1; ++t1)
                for (int kb = 0; kb < kt1; ++kb) {
                    uint8_t* st = ring + s * kStageBytes;
                    mbar_wait(empty + s, phase ^ 1);
                    mbar_arrive_expect_tx(full + s, l1_bytes);
                    const int col = kFp4 ? (kb >> 1) * kBK : kb * kBK;
                    tma_load_3d(st, &map_w1, full + s, col, t1 * 128, it.e);
                    tma_load_3d(st + kWBytes / 2, &map_w1, full + s, col, I + t1 * 128, it.e);
                    tma_load_2d(st + kWBytes + (kRaw1 ? kXBytes : 0), &map_x, full + s, kb * kBK,
                                row0);
                    if constexpr (kScaled)
                        bulk_load(st + kWBytes + kXBytes + kRawBytes,
                                  sfs + static_cast<int64_t>(kb) * kN, kN * 4, full + s);
                    if (++s == kStages) { s = 0; phase ^= 1; }
                }
            // L2 reads the act the consumers stored for this item
            mbar_wait(act_ready, done & 1);
            for (int u = 0; u < nt2; ++u)
                for (int kt = 0; kt < kt2; ++kt) {
                    uint8_t* st = ring + s * kStageBytes;
                    mbar_wait(empty + s, phase ^ 1);
                    mbar_arrive_expect_tx(full + s, kWBytes + kBoxes2 * kN * kBK);
                    const int col = kFp4 ? (kt >> 1) * kBK : kt * kBK;
                    tma_load_3d(st, &map_w2, full + s, col, u * 256, it.e);
                    tma_load_3d(st + kWBytes / 2, &map_w2, full + s, col, u * 256 + 128, it.e);
                    #pragma unroll
                    for (int box = 0; box < kBoxes2; ++box)
                        tma_load_2d(st + kWBytes + (kRaw2 ? kXBytes : box * kN * kBK), &map_act,
                                    full + s, (kt * kBoxes2 + box) * kBK, row0);
                    if (++s == kStages) { s = 0; phase ^= 1; }
                }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns 64 of the stage's gate rows and the
    // same 64 up rows (L1), 128 of its output rows (L2) ----
    const int tid = threadIdx.x % 128;
    const int ctid = threadIdx.x;                     // 0 .. kConsumers - 1
    const int warp = tid / 32;
    const int rr = warp * 16 + lane / 4;             // its rows of a 64-row block: rr, rr + 8
    const int q = 2 * (lane % 4);                    // its token columns: 8 j + q, + 1
    // act rows of I elements: bf16, or e4m3 with fp8 act
    __nv_bfloat16* const act = reinterpret_cast<__nv_bfloat16*>(
        p.act + static_cast<int64_t>(row0) * I * (kActFp8 ? 1 : 2));
    typename Rows::State state{};
    int s = 0;
    uint32_t phase = 0;
    float p0[kAcc], p1[kAcc];                        // two 64-row blocks' 128-deep sums
    #pragma unroll
    for (int i = 0; i < kAcc; ++i) p0[i] = p1[i] = 0.f;

    for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
        const Item it = rows.item(t);
        if (ctid == 0) rows.wait(it, state);
        // the last item is done with rw_s, ytab and the scratch; its rows landed
        named_barrier(1, kConsumers);
        for (int n = ctid; n < kN; n += kConsumers) {
            const bool ok = n < it.live;
            rw_s[n] = ok ? rows.rw_of(it, n) : 0.f;
            ytab[n] = ok ? rows.y_row(it, n) : nullptr;
        }
        gather<kScaled>(rows, it, p.xs + static_cast<int64_t>(row0) * H * (kScaled ? 1 : 2),
                        p.sfs + static_cast<int64_t>(blockIdx.x) * ksf1 * kN, H, ctid);
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(x_ready);
        named_barrier(1, kConsumers);                // rw_s and ytab are written
        const float* sf1 = p.w1sf + static_cast<int64_t>(it.e) * (2 * I / 128) * ksf1;
        const float* sf2 = p.w2sf + static_cast<int64_t>(it.e) * ksf1 * ksf2;

        // ---- L1: the I/128 tiles of 128 gate and 128 up columns --------
        for (int t1 = 0; t1 < nt1; ++t1) {
            float acc_g[kAcc], acc_u[kAcc];
            #pragma unroll
            for (int i = 0; i < kAcc; ++i) acc_g[i] = acc_u[i] = 0.f;
            for (int kb = 0; kb < kt1; ++kb) {
                float sfw_g = 0.f, sfw_u = 0.f;
                if constexpr (kScaled) {
                    // the tile's gate rows are all in scale block t1, its up rows in I/128 + t1
                    sfw_g = __ldg(sf1 + static_cast<int64_t>(t1) * ksf1 + kb);
                    sfw_u = __ldg(sf1 + static_cast<int64_t>(nt1 + t1) * ksf1 + kb);
                }
                mbar_wait(full + s, phase);
                mbar_wait(tokens_ready + s, phase);
                uint8_t* st = ring + s * kStageBytes;
                uint8_t* gate = st + wg * 64 * kBK;
                uint8_t* up = st + (128 + wg * 64) * kBK;
                if constexpr (kFp4) {
                    // this warpgroup's rows, decoded to e4m3 in place
                    decode_fp4(gate, 64 * kBK, kb & 1, tid);
                    decode_fp4(up, 64 * kBK, kb & 1, tid);
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                    named_barrier(2 + wg, 128);
                }
                const uint64_t db = smem_desc(st + kWBytes);     // the token rows, two boxes
                if constexpr (kScaled) {
                    // f16 products (x and the weights widened exactly); acc +=
                    // (p * sfw) * sfx: rows rr and rr + 8 share their tokens' scales
                    block_sums<true>(p0, p1, gate, up, db, rr, q);
                    const float* sfx =
                        reinterpret_cast<const float*>(st + kWBytes + kXBytes + kRawBytes);
                    #pragma unroll
                    for (int j = 0; j < kN / 8; ++j) {
                        const float2 x2 = *reinterpret_cast<const float2*>(sfx + 8 * j + q);
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const float sx = (v & 1) ? x2.y : x2.x;
                            const int i = 4 * j + v;
                            acc_g[i] = __fadd_rn(acc_g[i], __fmul_rn(__fmul_rn(p0[i], sfw_g), sx));
                            acc_u[i] = __fadd_rn(acc_u[i], __fmul_rn(__fmul_rn(p1[i], sfw_u), sx));
                        }
                    }
                } else {
                    const uint64_t dg = smem_desc(gate), du = smem_desc(up);
                    fence_all(acc_g);
                    fence_all(acc_u);
                    wgmma_fence();
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) {
                        M::ss(acc_g, dg + 2 * v, db + 2 * v, 1);
                        M::ss(acc_u, du + 2 * v, db + 2 * v, 1);
                    }
                    wgmma_commit();
                    fence_all(acc_g);
                    fence_all(acc_u);
                    sm90::wgmma_wait<0>();
                    fence_all(acc_g);
                    fence_all(acc_u);
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s);
                if (++s == kStages) { s = 0; phase ^= 1; }
            }

            // ---- the epilogue of tile t1: SwiGLU, clamp, row weight (+requant)
            const int c0 = t1 * 128 + wg * 64 + rr;   // intermediate column of rows rr (+8)
            #pragma unroll
            for (int i = 0; i < kAcc; ++i) {
                float gt = acc_g[i], u = acc_u[i];
                if constexpr (!kActBf16) {
                    gt = bf16_round(gt);
                    u = bf16_round(u);
                }
                float val = __fmul_rn(silu(gt, p.silu_tanh), u);
                val = fminf(fmaxf(val, -p.clamp), p.clamp);
                acc_g[i] = __fmul_rn(val, rw_s[8 * (i >> 2) + q + (i & 1)]);
            }
            if constexpr (!kActFp8) {
                #pragma unroll
                for (int i = 0; i < kAcc; ++i) {
                    const int n = 8 * (i >> 2) + q + (i & 1), c = c0 + ((i >> 1) & 1) * 8;
                    act[static_cast<int64_t>(n) * I + c] = __float2bfloat16_rn(acc_g[i]);
                }
            } else {
                // each token's amax over the tile's 128 columns (bf16 values): its
                // two rows, the 8 lanes of a warp with its columns, the 8 warps
                float* rbuf = red + (t1 & 1) * 8 * kN;
                #pragma unroll
                for (int i = 0; i < kAcc; ++i) acc_g[i] = bf16_round(acc_g[i]);
                #pragma unroll
                for (int j = 0; j < kN / 8; ++j)
                    #pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float m = fmaxf(fabsf(acc_g[4 * j + e]), fabsf(acc_g[4 * j + 2 + e]));
                        m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 4));
                        m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 8));
                        m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 16));
                        if (lane < 4) rbuf[(wg * 4 + warp) * kN + 8 * j + q + e] = m;
                    }
                named_barrier(1, kConsumers);
                #pragma unroll
                for (int j = 0; j < kN / 8; ++j)
                    #pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int n = 8 * j + q + e;
                        float m = rbuf[n];
                        #pragma unroll
                        for (int w = 1; w < 8; ++w) m = fmaxf(m, rbuf[w * kN + n]);
                        const float sf = __fdiv_rn(fmaxf(m, 1e-4f), 448.f);
                        const float inv = __fdiv_rn(1.f, sf);
                        if (wg == 0 && warp == 0 && lane < 4) act_sf[n * ksf2 + t1] = sf;
                        #pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float v = fminf(fmaxf(__fmul_rn(acc_g[4 * j + 2 * h + e], inv),
                                                        -448.f), 448.f);
                            reinterpret_cast<uint8_t*>(act)[static_cast<int64_t>(n) * I + c0 + 8 * h] =
                                __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
                        }
                    }
            }
        }
        // act stored: into the async proxy, then the producer may load it
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(act_ready);

        // ---- L2: the H/256 tiles, two 64-row blocks a warpgroup --------
        for (int u = 0; u < nt2; ++u) {
            const int h0 = u * 256 + wg * 128;        // the warpgroup's first output column
            float acc[2][kAcc];
            #pragma unroll
            for (int m = 0; m < 2; ++m)
                #pragma unroll
                for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;
            for (int kt = 0; kt < kt2; ++kt) {
                // the warpgroup's 128 rows are one scale block (none past H)
                const float sfw = kScaled && h0 < H
                    ? __ldg(sf2 + static_cast<int64_t>(h0 / 128) * ksf2 + kt) : 0.f;
                mbar_wait(full + s, phase);
                mbar_wait(tokens_ready + s, phase);
                uint8_t* st = ring + s * kStageBytes;
                uint8_t* rows128 = st + wg * 128 * kBK;
                if constexpr (kFp4) {
                    decode_fp4(rows128, 128 * kBK, kt & 1, tid);
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                    named_barrier(2 + wg, 128);
                }
                const uint64_t db = smem_desc(st + kWBytes);     // act, as TMA lands it
                if constexpr (kScaled) {
                    // f16 products with fp8 act (its codes' values), bf16 with bf16
                    // act; acc += p * sfw (times the act scale with fp8 act)
                    block_sums<kActFp8>(p0, p1, rows128, rows128 + 64 * kBK, db, rr, q);
                    #pragma unroll
                    for (int j = 0; j < kN / 8; ++j) {
                        float sa0 = 1.f, sa1 = 1.f;
                        if constexpr (kActFp8) {
                            sa0 = act_sf[(8 * j + q) * ksf2 + kt];
                            sa1 = act_sf[(8 * j + q + 1) * ksf2 + kt];
                        }
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const int i = 4 * j + v;
                            float t0 = __fmul_rn(p0[i], sfw), t1 = __fmul_rn(p1[i], sfw);
                            if constexpr (kActFp8) {
                                t0 = __fmul_rn(t0, (v & 1) ? sa1 : sa0);
                                t1 = __fmul_rn(t1, (v & 1) ? sa1 : sa0);
                            }
                            acc[0][i] = __fadd_rn(acc[0][i], t0);
                            acc[1][i] = __fadd_rn(acc[1][i], t1);
                        }
                    }
                } else {
                    const uint64_t d0 = smem_desc(rows128), d1 = smem_desc(rows128 + 64 * kBK);
                    fence_all(acc[0]);
                    fence_all(acc[1]);
                    wgmma_fence();
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) {
                        M::ss(acc[0], d0 + 2 * v, db + 2 * v, 1);
                        M::ss(acc[1], d1 + 2 * v, db + 2 * v, 1);
                    }
                    wgmma_commit();
                    fence_all(acc[0]);
                    fence_all(acc[1]);
                    sm90::wgmma_wait<0>();
                    fence_all(acc[0]);
                    fence_all(acc[1]);
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s);
                if (++s == kStages) { s = 0; phase ^= 1; }
            }
            // the tile's results: column h of token row n, for live rows
            #pragma unroll
            for (int m = 0; m < 2; ++m)
                #pragma unroll
                for (int i = 0; i < kAcc; ++i) {
                    const int n = 8 * (i >> 2) + q + (i & 1);
                    const int h = h0 + m * 64 + rr + ((i >> 1) & 1) * 8;
                    __nv_bfloat16* dst = ytab[n];
                    if (dst != nullptr && h < H) dst[h] = __float2bfloat16_rn(acc[m][i]);
                }
        }
    }
}

// The tensor maps of an instance: w1 [E, 2I, k bytes] and w2 [E, H, k bytes]
// in boxes of 128 rows x 128 bytes (zero past the rows); the scratch's act
// [rows, I] and x [rows, H] bf16 in boxes of kN rows x 128 bytes.
inline bool make_maps(CUtensorMap* map_w1, CUtensorMap* map_w2, CUtensorMap* map_act,
                      CUtensorMap* map_x, const void* w1, const void* w2, const Args& p,
                      int experts, int weight_kind, int act_fp8, int64_t rows) {
    const int hidden = p.hidden, inter = p.inter;
    const uint64_t k1 = weight_kind == 0 ? 2ull * hidden : weight_kind == 2 ? hidden / 2 : hidden;
    const uint64_t k2 = weight_kind == 0 ? 2ull * inter : weight_kind == 2 ? inter / 2 : inter;
    const uint64_t x_bytes = weight_kind == 0 ? 2ull * hidden : hidden;
    const uint64_t act_bytes = act_fp8 ? inter : 2ull * inter;
    return sm90::make_map_3d(map_w1, w1, k1, 2ull * inter, k1, experts, 128) &&
           sm90::make_map_3d(map_w2, w2, k2, hidden, k2, experts, 128) &&
           sm90::make_map(map_act, p.act, act_bytes, rows, act_bytes, kN) &&
           sm90::make_map(map_x, p.xs, x_bytes, rows, x_bytes, kN);
}

// The scratch's parts for `rows` token rows (scratch_bytes).
inline void split_scratch(Args* p, void* scratch, int64_t rows, int x_bytes, int act_bytes) {
    p->act = static_cast<uint8_t*>(scratch);
    p->xs = p->act + rows * act_bytes * p->inter;
    p->sfs = reinterpret_cast<float*>(p->xs + rows * x_bytes * p->hidden);
}

}  // namespace mega
}  // namespace dgt
