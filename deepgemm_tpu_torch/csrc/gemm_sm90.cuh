// The Hopper mainloop of the dense FP8 GEMM, the k-grouped FP8 weight
// gradient, the contiguous and the masked m-grouped GEMMs and the fused
// dispatch + L1: wgmma from shared memory fed by TMA, warp-specialised and
// persistent.
//
// Replaces the Pallas mainloops of deepgemm_tpu/kernels/dense.py
// (_build_dense_gemm, pl.pallas_call at dense.py:291) for e4m3 operands
// under 'promote', of deepgemm_tpu/kernels/k_grouped.py (_build_k_grouped,
// pl.pallas_call at k_grouped.py:237) for e4m3 operands, and of
// deepgemm_tpu/kernels/grouped.py (_build_contiguous, pl.pallas_call at
// grouped.py:240; _build_contiguous_dual_b, at grouped.py:401) for bf16 and
// e4m3 operands, with the f32 promotion of deepgemm_tpu/kernels/common.py:27-52:
//     acc += p * (sfa[m] * sfb[n])   for each 128-deep k block's product p;
// and, for the dense kernel's forms on bf16 products (dense_dequant.cu: the
// 'dequant' strategy, dense.py:248-255, and the folded FP4 operands),
// bf16 x bf16 as gemm_kernel's unscaled dense form and every form with an
// e4m3 operand as widen_kernel; and of deepgemm_tpu/kernels/grouped.py
// (_build_masked, pl.pallas_call at grouped.py:576) and fused_moe.py (the
// fused dispatch + L1's _kernel, pl.pallas_call at fused_moe.py:185) on
// widen_kernel's body (widen_body) as masked items, on bf16 products as the
// mma.sync kernel they replace computed them. The bf16 k-grouped form stays
// on the mma.sync mainloop (gemm_mainloop.cuh).
//
// What bounds it on the H100: a large dense product is tensor-core bound (2
// x 4096^3 operations on 32 MiB of fp8: ~2000 operations a byte, against the
// card's ~590 fp8 operations a byte of HBM); only wgmma reaches the fp8
// rate (e4m3 mma.sync runs as f16 HMMA on sm_90a). The k-grouped wgrad of a
// training step does 256 operations a written output element: its output
// bytes bound it, so its epilogue writes whole lines while the next work
// item's loads are in flight. The contiguous grouped GEMM of a training step
// (256 experts of 128 rows) does 256 operations a weight byte: the experts'
// weights bound it, so each expert's weights stream from HBM once. The forms
// on bf16 products run at the bf16 rate (half of e4m3's); widening e4m3 to
// bf16 costs each 128 x 128 tile a stage as many shared-memory bytes as the
// wgmma's own reads of B, so the widening, not the tensor cores, bounds
// them (PERF.md, section 7). The masked decode calls (40 rows of each of
// 256 experts) do ~80 operations a weight byte: the weights bound them
// (chip_smoke.py --masked-variants times them without their wgmma), and
// their ring is held at 3 stages: deeper rings gained an earlier design of
// them at most ~5% and ran the fused dispatch + L1 in bf16 up to ~2x slower.
//
// Design:
//   * A persistent grid of at most one block an SM walks the work items
//     (output tiles of kBM x kBN). Dense: kBN = 128, kBM = 64 or 128,
//     rasterised in bands of kSwizzleM row tiles so that the blocks running
//     at once share rows of A and B in L2. k-grouped: (group, row tile,
//     column tile), the groups one after another. Contiguous: (row tile,
//     column tile) with the column tiles of one row tile on neighbouring
//     blocks, so its A rows stay in L2 while each reads its own slice of the
//     group's B; a row tile's group is tile_gid[row tile] (device memory, as
//     the k-grouped items read k_size: no call syncs the host). The mk
//     alignment makes every row tile one group's (kBM 128 where it is a
//     multiple of 128: one pass over each expert's weights; else 64).
//   * One producer warp keeps TMA loads in flight into a ring of stages
//     (full and empty mbarriers a stage, the phase parity from a running
//     count that carries over from one work item to the next). A stage is
//     128 bytes of k (128 e4m3 values, one scale block, or 64 bf16 values):
//     A [kBM rows] and B [kBN rows] 128-byte swizzled, zero-filled by TMA past
//     m, n and k (the contiguous B through a 3-D map [G, n, k], so a tile past
//     n inside one group reads zeros, not the next group), plus the stage's
//     scales, k-first rows copied in bulk beside them. The producer is one
//     lane: an earlier design copied m-major scales with 4-byte cp.async from
//     all 32 lanes, whose arrivals reached the barrier thousands of cycles
//     late and whose 40 registers spilled. The k-grouped scales are k-first
//     already; the dense and contiguous entries lay theirs out k-first in a
//     pre-pass (k_first_kernel) on the same stream.
//   * Consumer warpgroups (setmaxnreg moves registers from the producer to
//     them) each own 64 rows of the tile (the dual-B item: 128, as two m64
//     halves). e4m3: four wgmma m64nNk32 a stage into a fresh f32 partial
//     (scale-d 0 on the first), wait for it, and promote it into the f32
//     accumulator with one FFMA an element: sfa per row, sfb per 128 columns
//     (gran_n >= 128, one value a tile) or per column. bf16 (no scales): four
//     wgmma m64nNk16 a stage straight into the accumulator.
//   * Planar FP4 B (128 packed bytes a row hold 256 codes: the low nibbles
//     k 0-127 of the group, the high nibbles k 128-255): the producer loads
//     a group's bytes for each of its two stages; the consumers decode nibble
//     plane kb & 1 to e4m3 in place (a packed byte's position is its code's,
//     so the swizzle carries over), fence the writes into the async proxy
//     and meet at a barrier before the wgmma. With B's (1, 128) scales as
//     per-column SFB this is bitwise the e4m3 kernel on the decoded codes.
//   * The forms on bf16 products (widen_kernel; tiles of 128 x 128, 64 x
//     128, or 64 x 64 where wider ones would leave SMs idle): 128 values of
//     k a stage (one 128-byte box a row of e4m3, two of bf16); an e4m3 A
//     widened exactly into wgmma's register operand (m64nNk16 with A from
//     registers) by each consumer, an e4m3 B into one of two bf16 tiles by
//     the consumers a stage ahead (each code's bits moved into a bf16, then
//     one bf16x2 product by 2^120 times the scale, a second one where that
//     would overflow: bf16(code * bf16(s)) rounded once, as JAX's 'dequant'
//     rounds it).
//   * MN-major B [G, k, n] (the contiguous NN form), loaded as it lies: bf16
//     in [64 k x 64 n] boxes that wgmma reads through its transpose-B
//     descriptor; e4m3 (wgmma takes 8-bit operands k-major only) in one
//     [128 k x 128 n] box that the consumers transpose into a k-major
//     swizzled tile (4 x 4 byte blocks by __byte_perm, each warp's reads and
//     writes on 32 banks; transpose_b_stage), fence and meet at a barrier
//     before the wgmma, as the FP4 decode does; two such tiles, so the next
//     stage is turned while the wgmma of this one runs. The tile is the
//     bytes a k-major load of B^T gives, so NN is bitwise NT on
//     b.transpose(1, 2) without a relayout of the weights in device memory
//     (these calls are bytes-bound: a relayout would read and write every
//     weight byte once more).
//   * The dual-B item (Kind::kContiguousDual): 256 rows by 64 columns, each
//     consumer warpgroup one 128-row half (two m64 wgmmas a step) against its
//     own half's group's B (tile_gid [m/256][2]); a stage holds one B tile
//     when the halves share a group and two when they straddle, so a 256-row
//     expert's B is read once. 64 columns: at 128 the e4m3 partial and sum
//     of two halves exceed a consumer thread's registers, and the bf16 item
//     spilled and ran slower than the contiguous kernel on the H100. Each 64
//     rows compute what the contiguous kernel's tile computes, in the same k
//     order, so its bits are the contiguous kernel's.
//   * Epilogue: c (c[g] for the k-grouped kernel) is added once to the
//     finished f32 sum, so d with c is bitwise d without c, plus c. (The
//     k-grouped kernel once started its sum from c[g], as JAX's does: 32
//     more loads a thread at each tile's start, and the register pressure
//     corrupted one n8 slice of the in-flight wgmma partial now and then.)
//     The contiguous kernel's rows at or past tile_row_end (ensure_zero_padding)
//     are written as zero, and a tile wholly past it skips its mainloop. Each
//     64 rows, rounded to bf16 or as f32, go into a 128-byte swizzled shared
//     tile (conflict-free from the accumulator layout), and one thread hands
//     it to TMA stores (a 3-D tensor map [G, M, N] that clips at m and n),
//     which drain while the consumers go on to the next tile. Where an output
//     row is not whole 16-byte chunks (a tensor map's stride cannot be), the
//     warpgroup stores the tile itself: 16-byte chunks, pairs at the ragged
//     edge.
//   * Masked (widen_body's Items kMasked and kByWeight): (group, row tile,
//     column tile) items over 3-D maps [G, M, K] of A and [G, N, K] of B, an
//     item at or past masked_m[g] (device memory) skipped by the producer
//     and the consumers alike, 64-row tiles where a group's rows fit (one
//     consumer warpgroup), else 128; two e4m3 operands widened to bf16, each
//     128-deep block's exact products summed in f32 and promoted as (p *
//     sfb) * sfa, which is the mma.sync kernel's and the plain version's
//     arithmetic (e4m3 wgmma sums its products at reduced precision: it left
//     the model's forward ~1e-3 from the plain one, its e4m3 casts flipping);
//     two bf16 operands in one f32 sum. The fused dispatch + L1 walks (group,
//     column tile, row tile) and waits on its producer lane for the slabs an
//     item's rows read. Each row's sum is the same in every tile, so the two
//     are bitwise equal.
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

#include <climits>
#include <type_traits>

#include "convert.cuh"

namespace dgt {
namespace sm90 {

constexpr int kBK = 128;               // k bytes a stage (one scale block of e4m3)
constexpr int kDenseBN = 128;          // output columns of a dense or k-grouped tile
constexpr int kSwizzleM = 8;           // row tiles a raster band (dense, k-grouped)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;     // bytes a block may use on the H100

enum class Kind { kDense, kKGrouped, kKGroupedFlat, kContiguous, kContiguousDual };
// How B is scaled and stored: one scale per 128 or more rows of B (a single
// value a tile), one per fewer rows (per column of the tile), planar FP4
// codes with per-row scales, or bf16 with no scales (A bf16 too).
enum class BForm { kBlockScaled, kChannelScaled, kPlanarFp4, kUnscaled };

struct Args {
    int tma_store;           // 1: map_d holds the output (its rows are whole 16-byte chunks)
    // scales k-first, one row per 128-deep block: sfa [ksf or nsf, sfa_ld], one per row
    // of A; sfb [ksf or nsf, sfb_ld], one per gran_n rows of B (k-grouped: per row;
    // contiguous: [G, ksf, sfb_ld], group g's from g * sfb_group_stride)
    const float* sfa;
    const float* sfb;
    int sfa_ld, sfb_ld;      // row strides: M and ceil(N / gran_n), rounded up to 4
    int64_t sfb_group_stride;
    const float* c;          // f32 or nullptr: [M, N] or [G, M, N], added to the finished sum
    void* d;                 // OutT [M, N] or [G, M, N]
    int M, N;
    int num_kb;              // dense, contiguous: 128-byte k blocks (ceil(K bytes / 128))
    int sfb_shift;           // log2(gran_n) (k-grouped: 0)
    int num_groups;          // k-grouped: G (dense: 1; contiguous: B's G, not a factor of the items)
    int num_stages;
    const int* k_size;       // k-grouped [G]: each group's depth
    const int* sf_start;     // k-grouped [G]: each group's first scale row
    const CUtensorMap* group_maps;   // flat: [G][2] tensor maps of A and B
    const int* tile_gid;     // contiguous: [row tiles] each tile's group (dual: [row tiles][2])
    const int* tile_row_end; // contiguous: [row tiles] rows at or past it are zero, or nullptr
};

template <Kind kKind>
__host__ __device__ constexpr bool is_contiguous() {
    return kKind == Kind::kContiguous || kKind == Kind::kContiguousDual;
}

template <Kind kKind>
__host__ __device__ constexpr bool is_k_grouped() {
    return kKind == Kind::kKGrouped || kKind == Kind::kKGroupedFlat;
}

template <int kBM, int kBN, class OutT, Kind kKind, BForm kBForm, bool kBMn>
struct Plan {
    static constexpr bool kDual = kKind == Kind::kContiguousDual;
    static constexpr int kSub = kDual ? 2 : 1;                // m64 halves a warpgroup owns
    static constexpr int kWG = kBM / (64 * kSub);             // consumer warpgroups
    static constexpr int kThreads = (kWG + 1) * 128;
    static constexpr int kBTiles = kDual ? 2 : 1;             // B tiles a stage holds
    static constexpr bool kScaled = kBForm != BForm::kUnscaled;
    static constexpr bool kTransposeB = kBMn && kScaled;      // e4m3 MN-major B
    static constexpr int kEpc = 16 / static_cast<int>(sizeof(OutT));     // outputs a 16-byte chunk
    static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(OutT));  // outputs a swizzle row
    static constexpr int kBoxes = kBN / kBoxCols;             // 128-byte column boxes a tile
    static constexpr int kStagingWG = kBoxes * 64 * 128;      // a warpgroup's staging tile
    static constexpr int kSfA = kScaled ? kBM : 0;            // scales a stage
    static constexpr int kSfB = kScaled ? kBTiles * kBN : 0;
    static constexpr int kStageBytes = kBM * kBK + kBTiles * kBN * kBK + (kSfA + kSfB) * 4;
    static constexpr int kTransposed = kTransposeB ? 2 * kBN * kBK : 0;   // two k-major B tiles
    static constexpr int kFixedBytes = 1024 + kWG * kStagingWG + kTransposed;
    // the k-grouped kernel adds a table of 8 bytes a group
    static int smem_bytes(int stages, int table_groups) {
        return kFixedBytes + stages * (kStageBytes + 16) + 8 * table_groups;
    }
    static_assert(kBN == 64 || kBN == 128, "tiles of 64 or 128 columns");
    static_assert(kWG >= 1 && kWG * 64 * kSub == kBM, "64 rows a consumer warpgroup (dual: 128)");
    // a consumer thread holds the accumulator and, for e4m3, the 128-deep
    // block's partial: kSub sets of kBN / 2 each, with room for addresses
    static_assert(kSub * (kScaled ? 2 : 1) * (kBN / 2) + 64 <= kConsumerRegs,
                  "the register sets of a consumer thread");
    static_assert(!kBMn || kKind == Kind::kContiguous, "MN-major B: the contiguous kernel");
    static_assert(kScaled || !is_k_grouped<kKind>(), "bf16 operands: dense or contiguous");
    static_assert(!kDual || (kBM == 256 && kBN == 64), "the dual-B item is 256 x 64");
    static_assert(kBForm != BForm::kPlanarFp4 || kKind == Kind::kDense, "planar FP4 B: dense");
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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
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

// An MN-major bf16 B tile [64 k rows x 128 n] as two boxes of [64 k x 64 n]
// (128-byte rows of n, 128-byte swizzled): the leading offset is the stride
// between the 64-column boxes (8 KiB), the stride offset between 8-row atoms
// of k (1024 bytes). A k16 step is 16 rows: +2048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((64 * 128) >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void fence_operand(float& r) {
    asm volatile("" : "+f"(r) :: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

template <int kN>
__device__ __forceinline__ void fence_all(float (&r)[kN]) {
    #pragma unroll
    for (int i = 0; i < kN; ++i) fence_operand(r[i]);
}

#define DGT_D32 \
    "{" "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31" \
    "}"
#define DGT_D64 \
    "{" "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63" \
    "}"
#define DGT_OUT8(d, o) \
    "+f"(d[(o)]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), \
    "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])
#define DGT_OUT32(d) DGT_OUT8(d, 0), DGT_OUT8(d, 8), DGT_OUT8(d, 16), DGT_OUT8(d, 24)
#define DGT_OUT64(d) \
    DGT_OUT32(d), DGT_OUT8(d, 32), DGT_OUT8(d, 40), DGT_OUT8(d, 48), DGT_OUT8(d, 56)

// d[64 x N] (+)= a[64 x 32] . b[N x 32]^T, e4m3 from shared memory (both
// k-major), f32 in registers; scale_d 0 overwrites d. N = 2 x the registers.
__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " DGT_D64
                 ", %64, %65, p, 1, 1;\n}\n"
                 : DGT_OUT64(d) : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_e4m3(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 " DGT_D32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : DGT_OUT32(d) : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] (+)= a[64 x 16] . b[N x 16]^T, bf16 from shared memory, A
// k-major, B k-major or (kTransB) MN-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DGT_D64
                 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
                 : DGT_OUT64(d) : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DGT_D32
                 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
                 : DGT_OUT32(d) : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d[64 x N] (+)= a[64 x 16] . b[N x 16]^T, bf16; a from registers (the
// m16n8k16 A fragment of each warp's 16 rows), b k-major in shared memory.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DGT_D64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : DGT_OUT64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DGT_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
                 : DGT_OUT32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef DGT_D32
#undef DGT_D64
#undef DGT_OUT8
#undef DGT_OUT32
#undef DGT_OUT64

// An e4m3 B stage as TMA loads it MN-major (128 k rows of 128 n bytes,
// 128-byte swizzled) into the k-major tile a k-major load gives (128 n rows
// of 128 k bytes, 128-byte swizzled): 1024 blocks of 4 k x 4 n bytes, each
// read as four words and written as four by __byte_perm. Block f of warp
// round w = f / 32, lane l = f % 32, is (bk, bn) with bk from lane bits
// 0, 1, 3, 4 and bn from bits 2, 3, 1, 4 (crossed with w), so each round's
// reads and its writes fall on 32 distinct banks.
__device__ __forceinline__ void transpose_b_stage(const uint8_t* raw, uint8_t* t, int tid,
                                                  int threads) {
    for (int f = tid; f < 1024; f += threads) {
        const int l = f & 31, w = f >> 5;
        const int bk = (l & 3) | (((l >> 3) & 3) << 2) | ((w & 1) << 4);
        const int bn = ((l >> 2) & 1) | ((((l >> 3) ^ (w >> 2)) & 1) << 1) |
                       ((((l >> 1) ^ (w >> 3)) & 1) << 2) | ((((l >> 4) ^ (w >> 4)) & 1) << 3) |
                       (((w >> 1) & 1) << 4);
        uint32_t v[4];
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = 4 * bk + i;
            v[i] = *reinterpret_cast<const uint32_t*>(
                raw + k * 128 + (((bn >> 2) ^ (k & 7)) << 4) + ((bn & 3) << 2));
        }
        const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140), hi01 = __byte_perm(v[0], v[1], 0x7362);
        const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140), hi23 = __byte_perm(v[2], v[3], 0x7362);
        const uint32_t o[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = 4 * bn + j;
            *reinterpret_cast<uint32_t*>(t + n * 128 + (((bk >> 2) ^ (n & 7)) << 4) +
                                         ((bk & 3) << 2)) = o[j];
        }
    }
}

template <class OutT>
__device__ __forceinline__ void store_pair(OutT* dst, float x, float y) {
    if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(x, y);
    } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
    }
}

// widen_body's epilogue of 64 rows of a tile (a consumer warpgroup's, rows
// row0 on of group g, columns n0 on; c [M, N], the dense forms only): c
// added once to the finished sum, rounded to OutT, staged in the
// warpgroup's swizzled tile and handed to TMA stores (or stored by the
// warpgroup where map_d cannot hold the output), as gemm_kernel's epilogue
// does (which keeps its own copy: the dense 'promote' forms are held to
// their SASS). First the staging tile must be free: the last TMA stores have
// read it, or this warpgroup's own stores are done. acc is the m64nNk16
// accumulator layout: rows rr and rr + 8, columns 8 j + q and 8 j + q + 1.
template <class OutT, int kBN>
__device__ __forceinline__ void store_rows64(const float (&acc)[kBN / 2], const Args& p,
                                             const CUtensorMap& map_d, uint8_t* stage_out,
                                             int row0, int n0, int rr, int q, int tid, int wg,
                                             int g = 0) {
    constexpr int kEpc = 16 / static_cast<int>(sizeof(OutT));     // outputs a 16-byte chunk
    constexpr int kBoxCols = 128 / static_cast<int>(sizeof(OutT));
    constexpr int kCpr = kBN / kEpc;                 // chunks a row
    if (p.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_barrier(2 + wg, 128);
    #pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
        #pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = rr + 8 * hh, cl = 8 * j + q;
            float x = acc[4 * j + 2 * hh], y = acc[4 * j + 2 * hh + 1];
            if (p.c != nullptr) {
                const int row = row0 + r, col = n0 + cl;
                if (row < p.M && col < p.N) {
                    const float2 cv = __ldg(reinterpret_cast<const float2*>(
                        p.c + static_cast<int64_t>(row) * p.N + col));
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
            for (int box = 0; box < kBN / kBoxCols; ++box)
                tma_store_3d(&map_d, stage_out + box * 64 * 128, n0 + box * kBoxCols, row0, g);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        return;
    }
    named_barrier(2 + wg, 128);
    OutT* const dst = static_cast<OutT*>(p.d) + static_cast<int64_t>(g) * p.M * p.N;
    for (int i = tid; i < 64 * kCpr; i += 128) {
        const int r = i / kCpr, ch = i % kCpr;
        const int row = row0 + r, col = n0 + ch * kEpc;
        if (row >= p.M || col >= p.N) continue;
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

// One work item: problem g (0 for dense and contiguous), its output tile,
// its depth in 128-byte blocks; contiguous: B's group of each half (b0, b1;
// equal but for a straddling dual-B tile) and the rows' end (rows at or
// past it are zero).
struct Item {
    int g, m0, n0, num_kb, b0, b1, row_end;
};

// The first scale column of B a tile copies: the 16-byte chunk that holds
// column n0's scale.
__device__ __forceinline__ int sfb_first(const Args& p, int n0) {
    return (n0 >> p.sfb_shift) & ~3;
}

// The work item t. Dense and k-grouped: the groups one after another, each
// group's tiles in bands of kSwizzleM row tiles; k-grouped: each group's
// (128-deep blocks, first scale row) from the table the block copies into
// shared memory. Contiguous: the column tiles of a row tile one after
// another (the bands ran 10-15% slower at the training step's shapes on the
// H100), the tile's group(s) and end row from device memory.
template <int kBM, int kBN, Kind kKind>
__device__ __forceinline__ Item item_of(const Args& p, const int2* groups, int t, int tiles_m,
                                        int tiles_n) {
    const int per_group = tiles_m * tiles_n;
    const int g = t / per_group;
    const int r = t - g * per_group;
    const int band = kSwizzleM * tiles_n;
    const int first_m = (r / band) * kSwizzleM;
    const int rows = min(tiles_m - first_m, kSwizzleM);
    const int in = r - (r / band) * band;
    int mt = first_m + in % rows;
    Item it;
    it.g = it.b0 = it.b1 = g;
    it.m0 = mt * kBM;
    it.n0 = (in / rows) * kBN;
    it.row_end = INT_MAX;
    if constexpr (is_contiguous<kKind>()) {
        mt = t / tiles_n;
        it.m0 = mt * kBM;
        it.n0 = (t - mt * tiles_n) * kBN;
        it.num_kb = p.num_kb;
        if constexpr (kKind == Kind::kContiguousDual) {
            it.b0 = __ldg(p.tile_gid + 2 * mt);
            it.b1 = __ldg(p.tile_gid + 2 * mt + 1);
        } else {
            it.b0 = it.b1 = __ldg(p.tile_gid + mt);
            if (p.tile_row_end != nullptr) {
                it.row_end = __ldg(p.tile_row_end + mt);
                if (it.m0 >= it.row_end) it.num_kb = 0;   // the whole tile is written as zero
            }
        }
    } else {
        it.num_kb = kKind == Kind::kDense ? p.num_kb : groups[g].x;
    }
    return it;
}

template <int kBM, int kBN, class OutT, Kind kKind, BForm kBForm, bool kBMn>
__global__ void __launch_bounds__((Plan<kBM, kBN, OutT, kKind, kBForm, kBMn>::kThreads), 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_d, const Args p) {
    using P = Plan<kBM, kBN, OutT, kKind, kBForm, kBMn>;
    constexpr int kWG = P::kWG, kSub = P::kSub, kBTiles = P::kBTiles;
    constexpr bool kKG = is_k_grouped<kKind>();
    constexpr bool kContig = is_contiguous<kKind>();
    constexpr bool kScaled = P::kScaled;
    static_assert(!kKG || kBForm == BForm::kChannelScaled, "k-grouped: per-channel scales");
    extern __shared__ __align__(1024) uint8_t smem_raw[];

    // carve: A and B stages, the staging tiles and the transposed B tiles
    // (1024-aligned for the swizzle), scales, barriers
    const int S = p.num_stages;
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* smem_a = base;
    uint8_t* smem_b = smem_a + S * kBM * kBK;
    uint8_t* staging = smem_b + S * kBTiles * kBN * kBK;
    uint8_t* transposed = staging + kWG * P::kStagingWG;
    float* sfa_s = reinterpret_cast<float*>(transposed + P::kTransposed);
    float* sfb_s = sfa_s + S * P::kSfA;
    uint64_t* full = reinterpret_cast<uint64_t*>(sfb_s + S * P::kSfB);
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
    const int num_items = tiles_m * tiles_n * (kContig ? 1 : p.num_groups);
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
            const Item it = item_of<kBM, kBN, kKind>(p, groups, t, tiles_m, tiles_n);
            const CUtensorMap* ma = &map_a;
            const CUtensorMap* mb = &map_b;
            int col0 = 0, sf0 = 0;
            if constexpr (kKG) sf0 = groups[it.g].y;
            if constexpr (kKind == Kind::kKGrouped) col0 = sf0 * kBK;
            if constexpr (kKind == Kind::kKGroupedFlat) {
                ma = p.group_maps + 2 * it.g;
                mb = ma + 1;
            }
            const int b_tiles = it.b1 != it.b0 ? 2 : 1;   // a straddling dual-B tile: 2
            // the stage's scales: a k-first row each, whole 16-byte chunks
            // (the rows' stride is; a row or column of the tile past the
            // live part keeps stale scales, and its outputs are never stored)
            const int sa_n = min(kBM, p.sfa_ld - it.m0);
            const int sb_col = sfb_first(p, it.n0);
            const int sb_n = min((((it.n0 + kBN - 1) >> p.sfb_shift) - sb_col + 4) & ~3,
                                 p.sfb_ld - sb_col);
            const uint32_t bytes = (kBM + b_tiles * kBN) * kBK +
                                   (kScaled ? 4 * (sa_n + b_tiles * sb_n) : 0);
            for (int kb = 0; kb < it.num_kb; ++kb) {
                mbar_wait(empty + s, phase ^ 1);
                mbar_arrive_expect_tx(full + s, bytes);
                tma_load_2d(smem_a + s * kBM * kBK, ma, full + s, col0 + kb * kBK, it.m0);
                uint8_t* sb = smem_b + s * kBTiles * kBN * kBK;
                if constexpr (!kContig) {
                    const int col_b = kBForm == BForm::kPlanarFp4 ? (kb >> 1) * kBK
                                                                  : col0 + kb * kBK;
                    tma_load_2d(sb, mb, full + s, col_b, it.n0);
                } else if constexpr (!kBMn) {
                    tma_load_3d(sb, mb, full + s, kb * kBK, it.n0, it.b0);
                    if (b_tiles == 2)
                        tma_load_3d(sb + kBN * kBK, mb, full + s, kb * kBK, it.n0, it.b1);
                } else if constexpr (kScaled) {
                    // e4m3 [128 k rows x 128 n bytes]
                    tma_load_3d(sb, mb, full + s, it.n0, kb * kBK, it.b0);
                } else {
                    // bf16 [64 k rows x 128 n]: two boxes of 64 columns
                    #pragma unroll
                    for (int box = 0; box < kBN / 64; ++box)
                        tma_load_3d(sb + box * 64 * 128, mb, full + s, 2 * it.n0 + box * 128,
                                    kb * (kBK / 2), it.b0);
                }
                if constexpr (kScaled) {
                    const int64_t row = sf0 + kb;
                    bulk_load(sfa_s + s * P::kSfA, p.sfa + row * p.sfa_ld + it.m0, 4 * sa_n,
                              full + s);
                    float* sbs = sfb_s + s * P::kSfB;
                    const float* src = p.sfb + row * p.sfb_ld + sb_col;
                    bulk_load(sbs, src + it.b0 * p.sfb_group_stride, 4 * sb_n, full + s);
                    if (b_tiles == 2)
                        bulk_load(sbs + kBN, src + it.b1 * p.sfb_group_stride, 4 * sb_n, full + s);
                }
                if (++s == S) { s = 0; phase ^= 1; }
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns rows [64 kSub wg, 64 kSub (wg + 1)) of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int rr = warp * 16 + lane / 4;             // its rows of a 64-row half: rr, rr + 8
    const int q = 2 * (lane % 4);                    // its columns: 8 j + q, 8 j + q + 1
    // its rows of the tile, for the scales: one index per half, computed once
    // (an index formed in the loop ran the dense kernel 10-20% slower)
    int rows[kSub];
    #pragma unroll
    for (int h = 0; h < kSub; ++h) rows[h] = (wg * kSub + h) * 64 + rr;
    OutT* const dst_all = static_cast<OutT*>(p.d);
    uint8_t* const stage_out = staging + wg * P::kStagingWG;
    constexpr int kEpc = P::kEpc;
    constexpr int kCpr = kBN / kEpc;                 // chunks a row
    constexpr int kJ = kBN / 8;                      // n8 column groups a tile

    float acc[kSub][kBN / 2], part[kSub][kBN / 2];
    #pragma unroll
    for (int h = 0; h < kSub; ++h)
        #pragma unroll
        for (int i = 0; i < kBN / 2; ++i) part[h][i] = 0.f;
    int s = 0;
    uint32_t phase = 0, rounds = 0;
    for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
        const Item it = item_of<kBM, kBN, kKind>(p, groups, t, tiles_m, tiles_n);
        const int64_t out_off = static_cast<int64_t>(it.g) * p.M * p.N;
        // the B tile this warpgroup reads: the second of a straddling dual-B stage
        const int bt = (P::kDual && wg == 1 && it.b1 != it.b0) ? 1 : 0;

        #pragma unroll
        for (int h = 0; h < kSub; ++h)
            #pragma unroll
            for (int i = 0; i < kBN / 2; ++i) acc[h][i] = 0.f;
        if constexpr (P::kTransposeB) {
            // the item's first B stage, k-major; each later one is turned
            // while the wgmma of the one before runs
            if (it.num_kb > 0) {
                mbar_wait(full + s, phase);
                transpose_b_stage(smem_b + s * kBN * kBK, transposed + (rounds & 1) * kBN * kBK,
                                  threadIdx.x, kWG * 128);
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            }
        }

        for (int kb = 0; kb < it.num_kb; ++kb) {
            mbar_wait(full + s, phase);
            uint8_t* sb_tile = smem_b + (s * kBTiles + bt) * kBN * kBK;
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
            if constexpr (P::kTransposeB) {
                // this round's k-major tile, each warpgroup's half written (the
                // barrier also means the other warpgroup's wgmma of the round
                // before has finished, so the other tile may be rewritten)
                named_barrier(1, kWG * 128);
                sb_tile = transposed + (rounds & 1) * kBN * kBK;
            }
            ++rounds;
            const uint64_t db = (kBMn && !kScaled) ? smem_desc_mn(sb_tile) : smem_desc(sb_tile);
            #pragma unroll
            for (int h = 0; h < kSub; ++h)
                #pragma unroll
                for (int i = 0; i < kBN / 2; ++i) fence_operand(kScaled ? part[h][i] : acc[h][i]);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            #pragma unroll
            for (int h = 0; h < kSub; ++h) {
                const uint64_t da = smem_desc(smem_a + s * kBM * kBK + (wg * kSub + h) * 64 * kBK);
                #pragma unroll
                for (int k = 0; k < 4; ++k) {
                    // +32 bytes of a k-major row: +2 in 16-byte units; MN-major
                    // B: +16 rows of 128 bytes
                    if constexpr (kScaled)
                        wgmma_e4m3(part[h], da + 2 * k, db + 2 * k, k);
                    else
                        wgmma_bf16<kBMn ? 1 : 0>(acc[h], da + 2 * k, db + (kBMn ? 128 : 2) * k, 1);
                }
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            if constexpr (P::kTransposeB) {
                // the next stage into the other k-major tile, under the wgmma
                if (kb + 1 < it.num_kb) {
                    const int s1 = s + 1 == S ? 0 : s + 1;
                    mbar_wait(full + s1, s + 1 == S ? phase ^ 1 : phase);
                    transpose_b_stage(smem_b + s1 * kBN * kBK,
                                      transposed + (rounds & 1) * kBN * kBK, threadIdx.x,
                                      kWG * 128);
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                }
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            // after the wait, as widen_body fences: no read of the sums moves above it
            #pragma unroll
            for (int h = 0; h < kSub; ++h)
                #pragma unroll
                for (int i = 0; i < kBN / 2; ++i) fence_operand(kScaled ? part[h][i] : acc[h][i]);

            if constexpr (kScaled) {
                // promote: acc += p * (sfa[row] * sfb[col])
                const float* sa = sfa_s + s * P::kSfA;
                const float* sb = sfb_s + s * P::kSfB;
                if constexpr (P::kDual) sb += bt * kBN;
                #pragma unroll
                for (int h = 0; h < kSub; ++h) {
                    const float sa0 = sa[rows[h]], sa1 = sa[rows[h] + 8];
                    if constexpr (kBForm == BForm::kBlockScaled) {
                        const float b = sb[(it.n0 >> p.sfb_shift) - sfb_first(p, it.n0)];
                        const float s0 = sa0 * b, s1 = sa1 * b;
                        #pragma unroll
                        for (int j = 0; j < kJ; ++j) {
                            acc[h][4 * j] = fmaf(part[h][4 * j], s0, acc[h][4 * j]);
                            acc[h][4 * j + 1] = fmaf(part[h][4 * j + 1], s0, acc[h][4 * j + 1]);
                            acc[h][4 * j + 2] = fmaf(part[h][4 * j + 2], s1, acc[h][4 * j + 2]);
                            acc[h][4 * j + 3] = fmaf(part[h][4 * j + 3], s1, acc[h][4 * j + 3]);
                        }
                    } else if (p.sfb_shift == 0) {
                        #pragma unroll
                        for (int j = 0; j < kJ; ++j) {
                            const float2 b2 = *reinterpret_cast<const float2*>(sb + 8 * j + q);
                            acc[h][4 * j] = fmaf(part[h][4 * j], sa0 * b2.x, acc[h][4 * j]);
                            acc[h][4 * j + 1] = fmaf(part[h][4 * j + 1], sa0 * b2.y, acc[h][4 * j + 1]);
                            acc[h][4 * j + 2] = fmaf(part[h][4 * j + 2], sa1 * b2.x, acc[h][4 * j + 2]);
                            acc[h][4 * j + 3] = fmaf(part[h][4 * j + 3], sa1 * b2.y, acc[h][4 * j + 3]);
                        }
                    } else {
                        // one scale per 2 to 64 rows of B: a column's scale by its index
                        const int first = sfb_first(p, it.n0);
                        #pragma unroll
                        for (int j = 0; j < kJ; ++j) {
                            const int col = it.n0 + 8 * j + q;
                            const float b0 = sb[(col >> p.sfb_shift) - first];
                            const float b1 = sb[((col + 1) >> p.sfb_shift) - first];
                            acc[h][4 * j] = fmaf(part[h][4 * j], sa0 * b0, acc[h][4 * j]);
                            acc[h][4 * j + 1] = fmaf(part[h][4 * j + 1], sa0 * b1, acc[h][4 * j + 1]);
                            acc[h][4 * j + 2] = fmaf(part[h][4 * j + 2], sa1 * b0, acc[h][4 * j + 2]);
                            acc[h][4 * j + 3] = fmaf(part[h][4 * j + 3], sa1 * b1, acc[h][4 * j + 3]);
                        }
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s);
            if (++s == S) { s = 0; phase ^= 1; }
        }

        // epilogue, a 64-row half at a time: c added once to the finished
        // sum, rows past row_end zeroed, rounded, staged, stored; first the
        // staging tile must be free: the last half's TMA stores have read
        // it, or this warpgroup's own stores are done
        #pragma unroll
        for (int h = 0; h < kSub; ++h) {
            const int row0 = it.m0 + (wg * kSub + h) * 64;
            if (p.tma_store && tid == 0)
                asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            named_barrier(2 + wg, 128);
            #pragma unroll
            for (int j = 0; j < kJ; ++j)
                #pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int r = rr + 8 * hh, cl = 8 * j + q;
                    float x = acc[h][4 * j + 2 * hh], y = acc[h][4 * j + 2 * hh + 1];
                    if (p.c != nullptr) {
                        const int row = row0 + r, col = it.n0 + cl;
                        if (row < p.M && col < p.N) {
                            const float2 cv = __ldg(reinterpret_cast<const float2*>(
                                p.c + out_off + static_cast<int64_t>(row) * p.N + col));
                            x = __fadd_rn(x, cv.x);
                            y = __fadd_rn(y, cv.y);
                        }
                    }
                    if (kKind == Kind::kContiguous && row0 + r >= it.row_end) x = y = 0.f;
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
                                     it.n0 + box * P::kBoxCols, row0, it.g);
                    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                }
                continue;
            }
            named_barrier(2 + wg, 128);
            OutT* const dst = dst_all + out_off;
            for (int i = tid; i < 64 * kCpr; i += 128) {
                const int r = i / kCpr, ch = i % kCpr;
                const int row = row0 + r, col = it.n0 + ch * kEpc;
                if (row >= p.M || col >= p.N) continue;
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
    }
    if (p.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- the dense forms on bf16 products: e4m3 operands widened to bf16 ----

// An operand of widen_kernel: e4m3 codes with f32 scales (widened to bf16
// in the kernel) or bf16 values with none (a folded FP4 operand).
enum class Operand { kE4m3, kBf16 };

template <int kBM, int kBN, class OutT, Operand kA, Operand kB, bool kDequant>
struct WidenPlan {
    static constexpr bool kAE4m3 = kA == Operand::kE4m3;
    static constexpr bool kBE4m3 = kB == Operand::kE4m3;
    // one f32 sum over the whole depth ('dequant', or two bf16 operands),
    // else a fresh partial a stage, promoted by the e4m3 sides' scales
    static constexpr bool kOneSum = kDequant || (!kAE4m3 && !kBE4m3);
    static constexpr int kWG = kBM / 64;                      // consumer warpgroups
    static constexpr int kThreads = (kWG + 1) * 128;
    // two bf16 operands (the masked kernel's bf16 form): A read by the wgmma
    // from shared memory, as B is, and a stage 128 bytes of k (64 values),
    // as in gemm_kernel (a stage of 128 values put twice the bytes in
    // flight, and ran the fused dispatch + L1 at 8 ranks of one card ~2x
    // slower); else a stage is 128 values of k: a 128-byte box a row of
    // e4m3, two of bf16
    static constexpr bool kSharedA = !kAE4m3 && !kBE4m3;
    static constexpr int kSteps = kSharedA ? 4 : 8;           // k16 steps a stage
    static constexpr int kABytes = (kAE4m3 || kSharedA ? 1 : 2) * kBM * kBK;
    static constexpr int kBBytes = (kBE4m3 || kSharedA ? 1 : 2) * kBN * kBK;
    static constexpr int kSfA = kAE4m3 ? kBM : 0;             // scales a stage
    static constexpr int kSfB = kBE4m3 ? kBN : 0;
    static constexpr int kStageBytes = kABytes + kBBytes + (kSfA + kSfB) * 4;
    static constexpr int kWideTile = 2 * kBN * kBK;           // a widened bf16 B stage
    static constexpr int kWidened = kBE4m3 ? 2 * kWideTile : 0;
    static constexpr int kStagingWG = kBN * static_cast<int>(sizeof(OutT)) / 128 * 64 * 128;
    static constexpr int kFixedBytes = 1024 + kWG * kStagingWG + kWidened;
    static int smem_bytes(int stages) { return kFixedBytes + stages * (kStageBytes + 16); }
    static_assert(kBN == 64 || kBN == 128, "tiles of 64 or 128 columns");
    static_assert(kWG == 1 || kWG == 2, "64 or 128 rows");
    // the accumulator, the partial under 'promote' and A's fragments of a
    // stage, within the 168 registers a thread of a 384-thread block has
    // (ptxas allots the consumers no more, setmaxnreg notwithstanding; the
    // 128-row 'promote' instances spill a few)
    static_assert((kOneSum ? 1 : 2) * (kBN / 2) + 32 <= 168, "the registers of a consumer");
};

// An e4m3 code's bits moved into a bf16 (sign to bit 15, exponent and
// mantissa to bits 4-10) are its value times 2^-120, zero and the subnormal
// codes included (e4m3 and bf16 subnormals scale alike; the codes' NaN,
// which the casts never write, becomes +-480).
constexpr float kWidenUnit = 0x1p120f;

// Two e4m3 codes, the bytes of the 8-byte {hi, lo} that selector sel picks
// with their signs replicated, as bf16x2 bits (each the code times 2^-120).
__device__ __forceinline__ uint32_t e4m3x2_bits(uint32_t lo, uint32_t hi, uint32_t sel) {
    uint32_t v;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(v) : "r"(lo), "r"(hi), "r"(sel));
    return (v << 4) & 0x87F087F0u;
}

// The selector of e4m3x2_bits for bytes i and i + 1 (0-6) of {hi, lo}.
__host__ __device__ constexpr uint32_t pair_selector(int i) {
    return i | (8 | i) << 4 | (i + 1) << 8 | (8 | (i + 1)) << 12;
}

// The bf16x2 multipliers c1, c2 that take codes' bits to bf16(code *
// bf16(s)), as JAX's 'dequant' rounds them (dense.py:248-255): c1 = 2^120
// bf16(s) and c2 = 1 where that is finite, else c1 = 2^120 and c2 =
// bf16(s); either way the first product is exact and the last rounds once
// to nearest even. Returns whether the second product (by c2) is needed.
__device__ __forceinline__ bool widen_scale(float s, uint32_t& c1, uint32_t& c2) {
    const float sb = __bfloat162float(__float2bfloat16_rn(s));
    const bool small = fabsf(sb) < 256.f;
    c1 = bf16x2_splat(small ? sb * kWidenUnit : kWidenUnit);
    c2 = bf16x2_splat(small ? 1.f : sb);
    return !small;
}

// An e4m3 B stage (kBN rows of 128 codes, 128-byte swizzled) widened into
// the bf16 tile a k-major TMA load of bf16 B gives (two 128-byte swizzled
// boxes of kBN rows, k 0-63 and 64-127), each row times its scale (kScaled:
// sb, the stage's scales of B from column first's, one per 1 << shift rows)
// or unscaled; half a row (64 codes, four 16-byte chunks: one scale) a
// thread at a time.
template <int kBN, bool kScaled>
__device__ __forceinline__ void widen_b_stage(const uint8_t* raw, uint8_t* tile, const float* sb,
                                              int n0, int shift, int first, int tid, int threads) {
    const uint32_t unit = bf16x2_splat(kWidenUnit);
    for (int u = tid; u < kBN * 2; u += threads) {
        const int n = u >> 1, box = u & 1;
        uint32_t c1 = unit, c2 = 0;
        bool twice = false;
        if constexpr (kScaled) twice = widen_scale(sb[((n0 + n) >> shift) - first], c1, c2);
        const uint8_t* src = raw + n * 128;
        uint8_t* dst = tile + box * kBN * 128 + n * 128;
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint4 w = *reinterpret_cast<const uint4*>(src + (((4 * box + j) ^ (n & 7)) << 4));
            const uint32_t in[4] = {w.x, w.y, w.z, w.w};
            uint32_t o[8];
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
                o[2 * i] = mul_bf16x2(e4m3x2_bits(in[i], 0, pair_selector(0)), c1);
                o[2 * i + 1] = mul_bf16x2(e4m3x2_bits(in[i], 0, pair_selector(2)), c1);
            }
            if (twice) {
                #pragma unroll
                for (int i = 0; i < 8; ++i) o[i] = mul_bf16x2(o[i], c2);
            }
            // the chunk's 16 values are the box row's bf16 chunks 2 j and 2 j + 1
            *reinterpret_cast<uint4*>(dst + (((2 * j) ^ (n & 7)) << 4)) =
                make_uint4(o[0], o[1], o[2], o[3]);
            *reinterpret_cast<uint4*>(dst + (((2 * j + 1) ^ (n & 7)) << 4)) =
                make_uint4(o[4], o[5], o[6], o[7]);
        }
    }
}

// The work items of widen_body: the dense kernel's (item_of's bands), the
// masked kernel's (group, row tile, column tile: the column tiles of a row
// tile on neighbouring blocks, so its A rows are read from L2) or the fused
// dispatch + L1's (group, column tile, row tile: the row tiles of a weight
// tile on neighbouring blocks, so each weight tile is read from HBM once).
enum class Items { kDense, kMasked, kByWeight };

// The masked kernel's arguments: a [G, M, K], b [G, N, K], the k-first
// scales (sfa [G, ksf, sfa_ld], sfb [G, ksf, sfb_ld] at sfb_group_stride),
// d [G, M, N]; masked_m [G] the live rows of each group, or nullptr (every
// row live).
struct MaskedArgs {
    Args p;
    const int* masked_m;
};

// Masked work item t of Items kMasked or kByWeight, the groups one after
// another.
template <int kBM, int kBN, Items kItems>
__device__ __forceinline__ Item masked_item(const Args& p, int t, int tiles_m, int tiles_n) {
    constexpr bool kByWeight = kItems == Items::kByWeight;
    const int per_group = tiles_m * tiles_n;
    Item it;
    it.g = t / per_group;
    const int r = t - it.g * per_group;
    const int inner = kByWeight ? tiles_m : tiles_n;
    const int outer = r / inner;
    it.m0 = (kByWeight ? r - outer * inner : outer) * kBM;
    it.n0 = (kByWeight ? outer : r - outer * inner) * kBN;
    it.num_kb = p.num_kb;
    return it;
}

// widen_body's wait_rows where A's rows are in place: nothing to wait for.
struct NoRows {
    __device__ __forceinline__ void operator()(int, int) const {}
};

// The body of the kernels on bf16 products: the dense kernel's forms on
// bf16 products (widen_kernel, dense_dequant.cu), the masked kernel
// (masked_kernel, masked.cu) and the GEMM of the fused dispatch + L1
// (mega_ep.cu). An e4m3 operand is widened exactly to bf16 (times bf16 of
// its scale under 'dequant'), a bf16 operand taken as it is, m64nNk16 wgmma
// into f32. A (64 rows a consumer warpgroup) is wgmma's register operand:
// each consumer builds its fragments of a stage (widened from the e4m3
// stage, or loaded from the bf16 one); with two bf16 operands (the masked
// forms) the wgmma reads A from shared memory, as B. An e4m3 B is widened
// by the consumers, each its share, a stage ahead into one of two bf16
// tiles while the wgmma on the other runs; they fence their writes into
// the async proxy and meet at a barrier before the wgmma (the barrier also
// means that every wgmma of the stage before, which read the other tile,
// has finished). A bf16 B is read as TMA loads it. 'dequant' and two bf16 operands sum the
// whole depth in one f32 accumulator; 'promote' sums each 128-deep stage in
// a fresh partial (exact products, f32 sums, as mma.sync's) and adds it
// times the e4m3 sides' scales: with one FMA for one e4m3 operand, and for
// two as the plain version orders it, (p * sfb) * sfa, each step rounded.
//
// Items kDense: gemm_kernel's dense producer, items and epilogue. Items
// kMasked and kByWeight: d[g, :masked_m[g]] = a[g] . b[g]^T over G groups;
// A and B through 3-D tensor maps [G, M, K] and [G, N, K], so a tile past M
// reads zeros and no row of the next group; an item whose first row is at
// or past masked_m[g] is skipped, before any load, by the producer and the
// consumers alike; wait_rows(m0, rows), on the producer lane before an
// item's first load, waits until the item's rows of A have landed (the
// dispatch's slabs). Each row's sum is computed alike in every tile and item
// order (the wgmma rows are independent, the promotion is per element), so
// its bits depend on neither the tile's rows nor the items: the dispatch's
// GEMM is bitwise the masked kernel on the received rows.
template <int kBM, int kBN, class OutT, Operand kA, Operand kB, bool kDequant, Items kItems,
          class WaitRows>
__device__ __forceinline__ void widen_body(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                           const CUtensorMap& map_d, const Args& p,
                                           const int* masked_m, WaitRows& wait_rows) {
    using P = WidenPlan<kBM, kBN, OutT, kA, kB, kDequant>;
    constexpr int kWG = P::kWG, kABytes = P::kABytes, kBBytes = P::kBBytes;
    constexpr bool kAE4m3 = P::kAE4m3, kBE4m3 = P::kBE4m3, kOneSum = P::kOneSum;
    constexpr bool kMasked = kItems != Items::kDense, kSharedA = P::kSharedA;
    static_assert(kMasked || kAE4m3 || kBE4m3, "two bf16 operands: gemm_kernel's dense form");
    static_assert(kMasked || kDequant || !(kAE4m3 && kBE4m3),
                  "dense e4m3 x e4m3 under 'promote': gemm_kernel");
    static_assert(!kMasked || (kA == kB && !kDequant), "masked: bf16 or e4m3 'promote'");
    extern __shared__ __align__(1024) uint8_t smem_raw[];

    // carve: A and B stages, the staging tiles and the widened B tiles
    // (1024-aligned for the swizzle), scales, barriers
    const int S = p.num_stages;
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* smem_a = base;
    uint8_t* smem_b = smem_a + S * kABytes;
    uint8_t* staging = smem_b + S * kBBytes;
    uint8_t* widened = staging + kWG * P::kStagingWG;
    float* sfa_s = reinterpret_cast<float*>(widened + P::kWidened);
    float* sfb_s = sfa_s + S * P::kSfA;
    uint64_t* full = reinterpret_cast<uint64_t*>(sfb_s + S * P::kSfB);
    uint64_t* empty = full + S;

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, kWG * 4);   // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int tiles_m = (p.M + kBM - 1) / kBM;
    const int tiles_n = (p.N + kBN - 1) / kBN;
    const int num_items = tiles_m * tiles_n * (kMasked ? p.num_groups : 1);
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    auto item = [&](int t) {
        if constexpr (kMasked) return masked_item<kBM, kBN, kItems>(p, t, tiles_m, tiles_n);
        else return item_of<kBM, kBN, Kind::kDense>(p, nullptr, t, tiles_m, tiles_n);
    };
    auto live = [&](const Item& it) {
        return !kMasked || masked_m == nullptr || it.m0 < __ldg(masked_m + it.g);
    };

    if (wg == kWG) {
        // ---- producer: one lane of the last warpgroup ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
        if (threadIdx.x % 128 != 0) return;
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
        int s = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
            const Item it = item(t);
            if (!live(it)) continue;
            if constexpr (kMasked) wait_rows(it.m0, min(kBM, p.M - it.m0));
            const int sa_n = min(kBM, p.sfa_ld - it.m0);
            const int sb_col = sfb_first(p, it.n0);
            const int sb_n = min((((it.n0 + kBN - 1) >> p.sfb_shift) - sb_col + 4) & ~3,
                                 p.sfb_ld - sb_col);
            const uint32_t bytes = kABytes + kBBytes + (kAE4m3 ? 4 * sa_n : 0) +
                                   (kBE4m3 ? 4 * sb_n : 0);
            // the group's scale rows (masked: G problems of num_kb rows each)
            const float* sfa_g =
                p.sfa + (kMasked ? static_cast<int64_t>(it.g) * p.num_kb * p.sfa_ld : 0);
            const float* sfb_g = p.sfb + (kMasked ? it.g * p.sfb_group_stride : 0);
            auto load = [&](void* dst, const CUtensorMap* map, int col, int row) {
                if constexpr (kMasked) tma_load_3d(dst, map, full + s, col, row, it.g);
                else tma_load_2d(dst, map, full + s, col, row);
            };
            for (int kb = 0; kb < it.num_kb; ++kb) {
                mbar_wait(empty + s, phase ^ 1);
                mbar_arrive_expect_tx(full + s, bytes);
                #pragma unroll
                for (int box = 0; box < kABytes / (kBM * kBK); ++box)
                    load(smem_a + s * kABytes + box * kBM * kBK, &map_a,
                         (kb * kABytes / (kBM * kBK) + box) * kBK, it.m0);
                #pragma unroll
                for (int box = 0; box < kBBytes / (kBN * kBK); ++box)
                    load(smem_b + s * kBBytes + box * kBN * kBK, &map_b,
                         (kb * kBBytes / (kBN * kBK) + box) * kBK, it.n0);
                if constexpr (kAE4m3)
                    bulk_load(sfa_s + s * P::kSfA, sfa_g + static_cast<int64_t>(kb) * p.sfa_ld + it.m0,
                              4 * sa_n, full + s);
                if constexpr (kBE4m3)
                    bulk_load(sfb_s + s * P::kSfB, sfb_g + static_cast<int64_t>(kb) * p.sfb_ld + sb_col,
                              4 * sb_n, full + s);
                if (++s == S) { s = 0; phase ^= 1; }
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int rr = (tid / 32) * 16 + lane / 4;       // its rows of the warpgroup's 64: rr, rr + 8
    const int q = 2 * (lane % 4);                    // its columns: 8 j + q, 8 j + q + 1
    const int ra = wg * 64 + rr;                     // its rows of A in a stage
    const uint32_t sel = pair_selector(q);           // its codes of an 8-byte half chunk
    uint8_t* const stage_out = staging + wg * P::kStagingWG;
    constexpr int kJ = kBN / 8;

    float acc[kBN / 2];
    float part[kOneSum ? 1 : kBN / 2];
    int s = 0;
    uint32_t phase = 0, rounds = 0;
    for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
        const Item it = item(t);
        if (!live(it)) continue;
        const int first = sfb_first(p, it.n0);
        auto widen_b = [&](int st) {
            widen_b_stage<kBN, kDequant>(smem_b + st * kBBytes, widened + (rounds & 1) * P::kWideTile,
                                         sfb_s + st * P::kSfB, it.n0, p.sfb_shift, first,
                                         threadIdx.x, kWG * 128);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        };
        #pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
        if constexpr (kBE4m3) {
            // the item's first B stage; each later one is widened while the
            // wgmma of the one before runs
            mbar_wait(full + s, phase);
            widen_b(s);
        }

        for (int kb = 0; kb < it.num_kb; ++kb) {
            mbar_wait(full + s, phase);
            // A's fragments of the stage's eight k16 steps: rows ra and ra +
            // 8, k 16 v + q, + 1 and 16 v + q + 8, + 9
            const uint8_t* sa = smem_a + s * kABytes;
            uint32_t af[8][4];
            if constexpr (kAE4m3) {
                uint32_t c1[2], c2[2];
                bool twice = false;
                if constexpr (kDequant) {
                    twice = widen_scale(sfa_s[s * P::kSfA + ra], c1[0], c2[0]);
                    twice |= widen_scale(sfa_s[s * P::kSfA + ra + 8], c1[1], c2[1]);
                } else {
                    c1[0] = c1[1] = bf16x2_splat(kWidenUnit);
                }
                const uint8_t* row = sa + ra * kBK;
                #pragma unroll
                for (int v = 0; v < 8; ++v) {
                    const int off = (v ^ (ra & 7)) << 4;
                    const uint4 x = *reinterpret_cast<const uint4*>(row + off);
                    const uint4 y = *reinterpret_cast<const uint4*>(row + 8 * kBK + off);
                    af[v][0] = mul_bf16x2(e4m3x2_bits(x.x, x.y, sel), c1[0]);
                    af[v][1] = mul_bf16x2(e4m3x2_bits(y.x, y.y, sel), c1[1]);
                    af[v][2] = mul_bf16x2(e4m3x2_bits(x.z, x.w, sel), c1[0]);
                    af[v][3] = mul_bf16x2(e4m3x2_bits(y.z, y.w, sel), c1[1]);
                }
                if (twice) {
                    // a scale of 2^8 or more (c2 is 1 on the other row)
                    #pragma unroll
                    for (int v = 0; v < 8; ++v)
                        #pragma unroll
                        for (int e = 0; e < 4; ++e) af[v][e] = mul_bf16x2(af[v][e], c2[e & 1]);
                }
            } else if constexpr (!kSharedA) {
                #pragma unroll
                for (int v = 0; v < 8; ++v)
                    #pragma unroll
                    for (int e = 0; e < 4; ++e)
                        af[v][e] = *reinterpret_cast<const uint32_t*>(
                            sa + (v >> 2) * kBM * kBK + (ra + 8 * (e & 1)) * kBK +
                            (((2 * (v & 3) + (e >> 1)) ^ (ra & 7)) << 4) + 2 * q);
            }
            const uint8_t* b_tile = smem_b + s * kBBytes;
            if constexpr (kBE4m3) {
                // every consumer's share of this round's tile is written
                named_barrier(1, kWG * 128);
                b_tile = widened + (rounds & 1) * P::kWideTile;
            }
            ++rounds;

            // step v reads box v / 4 of the B tile (and of a shared A),
            // +32 bytes a step inside it
            auto mma = [&](float (&d)[kBN / 2]) {
                fence_all(d);
                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                const uint64_t db = smem_desc(b_tile);
                #pragma unroll
                for (int v = 0; v < P::kSteps; ++v) {
                    const uint64_t db_v = db + (((v >> 2) * kBN * kBK + (v & 3) * 32) >> 4);
                    if constexpr (kSharedA) {
                        const uint8_t* a_box = sa + (v >> 2) * kBM * kBK + wg * 64 * kBK;
                        wgmma_bf16<0>(d, smem_desc(a_box) + (v & 3) * 2, db_v, 1);
                    } else {
                        wgmma_bf16_rs(d, af[v], db_v, kOneSum || v > 0);
                    }
                }
                asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                fence_all(d);
            };
            if constexpr (kOneSum) mma(acc);
            else mma(part);
            if constexpr (kBE4m3) {
                // the next stage into the other tile, under the wgmma
                if (kb + 1 < it.num_kb) {
                    const int s1 = s + 1 == S ? 0 : s + 1;
                    mbar_wait(full + s1, s + 1 == S ? phase ^ 1 : phase);
                    widen_b(s1);
                }
            }
            wgmma_wait<0>();
            // after the wait: no read of the sums moves above it, and A's
            // registers, which the wgmma reads until it completes, stay
            // untouched until here
            if constexpr (kOneSum) fence_all(acc);
            else fence_all(part);
            if constexpr (!kSharedA) {
                #pragma unroll
                for (int v = 0; v < 8; ++v)
                    #pragma unroll
                    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[v][e]) :: "memory");
            }

            if constexpr (!kOneSum) {
                if constexpr (kAE4m3 && kBE4m3) {
                    // acc += (p * sfb[col]) * sfa[row]
                    const float s0 = sfa_s[s * P::kSfA + ra], s8 = sfa_s[s * P::kSfA + ra + 8];
                    const float* sb = sfb_s + s * P::kSfB;
                    #pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        const int col = it.n0 + 8 * j + q;
                        const float b0 = sb[(col >> p.sfb_shift) - first];
                        const float b1 = sb[((col + 1) >> p.sfb_shift) - first];
                        acc[4 * j] = __fadd_rn(acc[4 * j], __fmul_rn(__fmul_rn(part[4 * j], b0), s0));
                        acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1],
                                                   __fmul_rn(__fmul_rn(part[4 * j + 1], b1), s0));
                        acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2],
                                                   __fmul_rn(__fmul_rn(part[4 * j + 2], b0), s8));
                        acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3],
                                                   __fmul_rn(__fmul_rn(part[4 * j + 3], b1), s8));
                    }
                } else if constexpr (kAE4m3) {
                    // acc += p * sfa[row]
                    const float s0 = sfa_s[s * P::kSfA + ra], s8 = sfa_s[s * P::kSfA + ra + 8];
                    #pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        acc[4 * j] = fmaf(part[4 * j], s0, acc[4 * j]);
                        acc[4 * j + 1] = fmaf(part[4 * j + 1], s0, acc[4 * j + 1]);
                        acc[4 * j + 2] = fmaf(part[4 * j + 2], s8, acc[4 * j + 2]);
                        acc[4 * j + 3] = fmaf(part[4 * j + 3], s8, acc[4 * j + 3]);
                    }
                } else {
                    // acc += p * sfb[col]
                    const float* sb = sfb_s + s * P::kSfB;
                    #pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        const int col = it.n0 + 8 * j + q;
                        const float b0 = sb[(col >> p.sfb_shift) - first];
                        const float b1 = sb[((col + 1) >> p.sfb_shift) - first];
                        acc[4 * j] = fmaf(part[4 * j], b0, acc[4 * j]);
                        acc[4 * j + 1] = fmaf(part[4 * j + 1], b1, acc[4 * j + 1]);
                        acc[4 * j + 2] = fmaf(part[4 * j + 2], b0, acc[4 * j + 2]);
                        acc[4 * j + 3] = fmaf(part[4 * j + 3], b1, acc[4 * j + 3]);
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s);
            if (++s == S) { s = 0; phase ^= 1; }
        }
        store_rows64<OutT, kBN>(acc, p, map_d, stage_out, it.m0 + wg * 64, it.n0, rr, q, tid, wg,
                                kMasked ? it.g : 0);
    }
    if (p.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}



// The dense kernel's forms on bf16 products (dense_dequant.cu): widen_body
// on the dense items, no operand two bf16 and no e4m3 x e4m3 under 'promote'
// (gemm_kernel's forms).
template <int kBM, int kBN, class OutT, Operand kA, Operand kB, bool kDequant>
__global__ void __launch_bounds__((WidenPlan<kBM, kBN, OutT, kA, kB, kDequant>::kThreads), 1)
widen_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_d, const Args p) {
    NoRows no_rows;
    widen_body<kBM, kBN, OutT, kA, kB, kDequant, Items::kDense>(map_a, map_b, map_d, p, nullptr,
                                                                no_rows);
}

// The masked kernel (masked.cu): widen_body on the masked items, its rows
// in place; two e4m3 operands (promoted) or two bf16.
template <int kBM, class OutT, Operand kAB>
using MaskedPlan = WidenPlan<kBM, kDenseBN, OutT, kAB, kAB, false>;

template <int kBM, class OutT, Operand kAB>
__global__ void __launch_bounds__((MaskedPlan<kBM, OutT, kAB>::kThreads), 1)
masked_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_d, const MaskedArgs a) {
    NoRows in_place;
    widen_body<kBM, kDenseBN, OutT, kAB, kAB, false, Items::kMasked>(map_a, map_b, map_d, a.p,
                                                                     a.masked_m, in_place);
}

// Scales k-first, as the producer copies them: sfa [m, ksf] -> sfa_k [ksf,
// sfa_ld] and, for each of `groups` problems, sfb [nsf, ksf] -> sfb_k [ksf,
// sfb_ld], zero in the pad columns; one thread an output element.
__global__ void k_first_kernel(const float* __restrict__ sfa, const float* __restrict__ sfb,
                               float* __restrict__ sfa_k, float* __restrict__ sfb_k, int m,
                               int nsf, int ksf, int sfa_ld, int sfb_ld, int groups) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t na = static_cast<int64_t>(ksf) * sfa_ld;
    const int64_t per_group = static_cast<int64_t>(ksf) * sfb_ld;
    if (i < na) {
        const int kb = static_cast<int>(i / sfa_ld), r = static_cast<int>(i % sfa_ld);
        sfa_k[i] = r < m ? __ldg(sfa + static_cast<int64_t>(r) * ksf + kb) : 0.f;
    } else if (i < na + groups * per_group) {
        const int64_t j = i - na;
        const int64_t g = j / per_group, jj = j % per_group;
        const int kb = static_cast<int>(jj / sfb_ld), r = static_cast<int>(jj % sfb_ld);
        sfb_k[j] = r < nsf ? __ldg(sfb + (g * nsf + r) * ksf + kb) : 0.f;
    }
}

// ---- host side: tensor maps and launches ----

// sfa and `groups` problems' sfb k-first into scratch (sfa_k, then sfb_k)
// on the stream.
inline cudaError_t launch_k_first(const void* sfa, const void* sfb, void* scratch, int m, int nsf,
                                  int ksf, int sfa_ld, int sfb_ld, int groups,
                                  cudaStream_t stream) {
    float* sfa_k = static_cast<float*>(scratch);
    float* sfb_k = sfa_k + static_cast<int64_t>(ksf) * sfa_ld;
    const int64_t elems = static_cast<int64_t>(ksf) * (sfa_ld + static_cast<int64_t>(groups) * sfb_ld);
    k_first_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(sfa), static_cast<const float*>(sfb), sfa_k, sfb_k, m, nsf, ksf,
        sfa_ld, sfb_ld, groups);
    return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link to libcuda.
static inline EncodeTiled encode_tiled() {
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

// A byte tensor [groups, rows, row_bytes] with row stride ld bytes, read in
// boxes of box_rows x 128 bytes (one group), 128-byte swizzled; zero past its
// edges, and so past a group's rows.
inline bool make_map_3d(CUtensorMap* map, const void* base, uint64_t row_bytes, uint64_t rows,
                        uint64_t ld, uint64_t groups, uint32_t box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {row_bytes, rows, groups};
    const cuuint64_t strides[2] = {ld, ld * rows};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK), box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// The kernel's shared memory opted in to the block limit, once a device.
// static: internal linkage, so each library keeps its own flags (a
// function-local static of an inline template is one object across every
// library the process loads that instantiates it).
template <auto kKernel>
static inline cudaError_t opt_in() {
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !opted_in[dev]) {
        err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
        if (err != cudaSuccess) return err;
        if (dev < 64) opted_in[dev] = true;
    }
    return cudaSuccess;
}

template <int kBM, int kBN, class OutT, Kind kKind, BForm kBForm, bool kBMn = false>
static inline cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                 const CUtensorMap& map_d, const Args& p, int num_sms,
                                 cudaStream_t stream) {
    using P = Plan<kBM, kBN, OutT, kKind, kBForm, kBMn>;
    const int smem = P::smem_bytes(p.num_stages, is_k_grouped<kKind>() ? p.num_groups : 0);
    if (p.num_stages < 2 || smem > kSmemLimit) return cudaErrorInvalidValue;
    constexpr auto kernel = gemm_kernel<kBM, kBN, OutT, kKind, kBForm, kBMn>;
    const cudaError_t err = opt_in<kernel>();
    if (err != cudaSuccess) return err;
    const long long items = static_cast<long long>((p.M + kBM - 1) / kBM) *
                            ((p.N + kBN - 1) / kBN) * (is_contiguous<kKind>() ? 1 : p.num_groups);
    const int grid = static_cast<int>(items < num_sms ? items : num_sms);
    if (grid == 0) return cudaSuccess;
    kernel<<<grid, P::kThreads, smem, stream>>>(map_a, map_b, map_d, p);
    return cudaGetLastError();
}

// The dense or k-grouped instance of block_m (64 or 128) and the output
// type, with the output's tensor map where its rows allow one.
template <Kind kKind, BForm kBForm>
inline cudaError_t launch_any(const CUtensorMap& map_a, const CUtensorMap& map_b, Args p,
                              int block_m, int out_f32, int num_sms, cudaStream_t stream) {
    CUtensorMap map_d = {};
    p.tma_store = make_out_map(&map_d, p.d, p.N, p.M, p.num_groups, out_f32) ? 1 : 0;
    if (block_m == 128)
        return out_f32
            ? launch<128, kDenseBN, float, kKind, kBForm>(map_a, map_b, map_d, p, num_sms, stream)
            : launch<128, kDenseBN, __nv_bfloat16, kKind, kBForm>(map_a, map_b, map_d, p,
                                                                  num_sms, stream);
    if (block_m == 64)
        return out_f32
            ? launch<64, kDenseBN, float, kKind, kBForm>(map_a, map_b, map_d, p, num_sms, stream)
            : launch<64, kDenseBN, __nv_bfloat16, kKind, kBForm>(map_a, map_b, map_d, p,
                                                                 num_sms, stream);
    return cudaErrorInvalidValue;
}

// A widen_kernel instance: tiles of block_m x block_n (128 x 128, 64 x 128
// or 64 x 64), the output type, the output's tensor map where its rows
// allow one.
template <int kBM, int kBN, class OutT, Operand kA, Operand kB, bool kDequant>
static inline cudaError_t launch_widen(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                       const CUtensorMap& map_d, const Args& p, int num_sms,
                                       cudaStream_t stream) {
    using P = WidenPlan<kBM, kBN, OutT, kA, kB, kDequant>;
    const int smem = P::smem_bytes(p.num_stages);
    if (p.num_stages < 2 || smem > kSmemLimit) return cudaErrorInvalidValue;
    constexpr auto kernel = widen_kernel<kBM, kBN, OutT, kA, kB, kDequant>;
    const cudaError_t err = opt_in<kernel>();
    if (err != cudaSuccess) return err;
    const long long items = static_cast<long long>((p.M + kBM - 1) / kBM) *
                            ((p.N + kBN - 1) / kBN);
    const int grid = static_cast<int>(items < num_sms ? items : num_sms);
    if (grid == 0) return cudaSuccess;
    kernel<<<grid, P::kThreads, smem, stream>>>(map_a, map_b, map_d, p);
    return cudaGetLastError();
}

template <Operand kA, Operand kB, bool kDequant>
inline cudaError_t launch_widen_any(const CUtensorMap& map_a, const CUtensorMap& map_b, Args p,
                                    int block_m, int block_n, int out_f32, int num_sms,
                                    cudaStream_t stream) {
    CUtensorMap map_d = {};
    p.tma_store = make_out_map(&map_d, p.d, p.N, p.M, 1, out_f32) ? 1 : 0;
    using Bf16 = __nv_bfloat16;
    auto go = [&](auto kernel_of) { return kernel_of(map_a, map_b, map_d, p, num_sms, stream); };
    if (block_m == 128 && block_n == 128)
        return out_f32 ? go(launch_widen<128, 128, float, kA, kB, kDequant>)
                       : go(launch_widen<128, 128, Bf16, kA, kB, kDequant>);
    if (block_m == 64 && block_n == 128)
        return out_f32 ? go(launch_widen<64, 128, float, kA, kB, kDequant>)
                       : go(launch_widen<64, 128, Bf16, kA, kB, kDequant>);
    if (block_m == 64 && block_n == 64)
        return out_f32 ? go(launch_widen<64, 64, float, kA, kB, kDequant>)
                       : go(launch_widen<64, 64, Bf16, kA, kB, kDequant>);
    return cudaErrorInvalidValue;
}

// A masked_kernel instance of block_m rows (64 or 128), the operands' type
// and the output type: persistent, one block an SM, at most one per item.
template <int kBM, class OutT, Operand kAB>
static inline cudaError_t launch_masked(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                        const CUtensorMap& map_d, const MaskedArgs& a,
                                        int num_sms, cudaStream_t stream) {
    using P = MaskedPlan<kBM, OutT, kAB>;
    const int smem = P::smem_bytes(a.p.num_stages);
    if (a.p.num_stages < 2 || smem > kSmemLimit) return cudaErrorInvalidValue;
    constexpr auto kernel = masked_kernel<kBM, OutT, kAB>;
    const cudaError_t err = opt_in<kernel>();
    if (err != cudaSuccess) return err;
    const long long items = static_cast<long long>((a.p.M + kBM - 1) / kBM) *
                            ((a.p.N + kDenseBN - 1) / kDenseBN) * a.p.num_groups;
    const int grid = static_cast<int>(items < num_sms ? items : num_sms);
    if (grid == 0) return cudaSuccess;
    kernel<<<grid, P::kThreads, smem, stream>>>(map_a, map_b, map_d, a);
    return cudaGetLastError();
}

}  // namespace sm90
}  // namespace dgt

#ifndef DGT_ERROR_STRING_DEFINED
#define DGT_ERROR_STRING_DEFINED
extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
