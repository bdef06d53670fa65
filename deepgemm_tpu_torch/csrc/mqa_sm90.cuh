// MQA ("lightning indexer") logits on Hopper, the prefill and the decode side:
//
//   logits[i, c] = sum_h w[i, h] * relu(q[i, h, :] . kv(i, c)) * sf(i, c)
//
// for the output columns c in [lo[i], hi[i]) of each query row i, and the
// fill (-inf, or 0 in the compressed layout) elsewhere. The kernel's Source
// is the entry it serves:
//   * kLinear, the prefill logits (mqa_logits.cu): kv row base_i + c of one
//     [skv, d] tensor. Replaces the body of deepgemm_tpu/kernels/
//     mqa_logits.py:_build_mqa_logits (pl.pallas_call at mqa_logits.py:133;
//     its body at :100-125).
//   * kPaged, the paged logits (paged_mqa.cu): row c % block_kv of page
//     block_table[b, c / block_kv] of batch row b, zero rows at and past
//     mb * block_kv. Replaces the bodies of deepgemm_tpu/kernels/
//     paged_mqa.py:_build_paged_mqa (pallas_call at :166; the cache the
//     wrapper linearised is one page a batch row) and
//     _build_paged_mqa_zerocopy (pallas_call at :382; the pages in place).
// The sources share every line of the kernel: the host describes where a
// column's kv row lies (Args: a block table, or one page a query tile at
// kv_base[tile] or at tile * tile_stride) and which stages an item takes.
// Their one difference inside the kernel is the e4m3 x e4m3 products (see
// exact_e4m3). So the two paged entries give the same bits.
//
// What bounds it on the H100: the prefill bench shape (2048 x 8192, 64 heads
// x 128) does ~1000 fp8 operations a byte: the tensor cores, at wgmma's rate
// only (e4m3 mma.sync runs as f16 HMMA on sm_90a). The head sum costs two
// CUDA-core instructions an accumulator element, half the wgmma time of an
// element at d = 128: it must run under wgmmas in flight. The decode (a
// batch row's next_n tokens one query tile) is bytes bound: each cache row
// is read once for 2 * next_n * h * d operations.
//
// Design:
//   * Operands: kv rows on wgmma's M, the item's query heads on N: qg query
//     rows of hp heads each (h rounded up to a power of two, at least 8,
//     with zero q rows and zero w, so each query's heads are whole column
//     blocks and every query row runs the same instructions whatever slot
//     it lands in), N = 128 (h <= 128: qg = min(rows_per_tile, 128 / hp))
//     or two n128 halves (h > 128: one query). K = d: e4m3 x e4m3 wgmma
//     m64n128k32; any bf16 operand bf16 m64n128k16, an e4m3 operand widened
//     exactly: an e4m3 q once an item into a bf16 shared tile, an e4m3 kv
//     in registers as the register-A operand.
//   * Work items: (query group, r). A query group lies inside one query tile
//     of rows_per_tile rows (the compressed layout's unit: one kv base a
//     tile, as JAX's host check of the layout, kernels/mqa_logits.py:
//     176-200). Item r takes the stages r * item_first + k * stage_step,
//     k < run: a run of neighbouring stages for the prefill (item_first =
//     run, stage_step 1; the groups of one run neighbours in the item order,
//     so the blocks running at once read the same kv rows from L2), every
//     num_runs-th for the decode (item_first 1, stage_step num_runs: a row's
//     window [0, hi) is a prefix, so every item of a group holds its share
//     of active stages to within one, and the SMs' loads differ only by
//     their groups' context lengths, not by which run they drew). A
//     persistent grid of at most one block an SM walks the items.
//   * Producer, three warps. Warps 1 and 2 ready each item up to q_bufs
//     items ahead of the consumers: warp 1 its rows' lo and hi, the union of
//     their windows and the first cache row of every piece of its active
//     stages (a piece: the rows of one page inside a stage) into shared
//     memory, then its w; warp 2 its q rows (3-D tensor map [sq, h, d
//     bytes], boxes of [qg, hp, 128 bytes], zero past h and sq), or, for an
//     e4m3 q that the consumers take as bf16, the rows copied in 16-byte
//     cp.async chunks and widened into the buffer's bf16 tile. Warp 0
//     issues each stage of kRows kv rows (128; 64 at h > 128) that meets
//     the window into a ring with full and empty mbarriers, once warp 1 has
//     written its rows. Where a piece is a multiple of 8 rows: one 128-byte
//     swizzled box a piece (a piece past the cache reads a row wholly out of
//     range: zeros), and its scales in row order, by a box from the 16-byte
//     boundary at or before its first row (a compressed stage starts at any
//     kv row, and a tensor copy from an unaligned start faulted on the
//     card), or, for pieces of 8 or 16 rows, whose boxes would not land
//     128-aligned, by 16-byte cp.async chunks that the stage's barrier
//     tracks (a row's scale lies where the consumers read it without a
//     run-time slot: indexing one cost #7's bench shape ~6%). Otherwise its
//     32 lanes copy the stage's rows with cp.async to their swizzled places
//     (zero past the cache), then arrive. A stage outside every row's
//     [lo, hi) loads nothing: its warpgroup writes the fill. (At the
//     decode's ~5 stages an item, an item's fixed cost sets the time: with
//     one warp doing it all, an item's loads of w and the table sat between
//     its stages and the previous item's; with the consumers widening q,
//     both warpgroups met at a barrier every item; with one warp for w, the
//     rows and q, their global loads ran one after another.)
//   * Two consumer warpgroups take the loaded stages in turns (stage n to
//     warpgroup n % 2) and issue their wgmmas in that order (an mbarrier a
//     warpgroup counts its issues). A warpgroup issues both m64 halves of
//     its stage at once (two commit groups) and sums the first while the
//     second runs, so the head sum of one half, and of one warpgroup, runs
//     under wgmmas in flight.
//   * Epilogue in registers: ReLU, times w (registers, loaded once an item),
//     summed over each query's heads: each lane's own columns of a query in
//     order (two chains, one a column of a block, added at the query's last
//     block), then two quad shuffles in a fixed order (every lane of the
//     quad gets the same bits), times sf; staged [query, kRows columns] in
//     shared memory, the fill selected outside [lo, hi), stored as whole
//     row segments. hp is a template argument so that the query boundaries
//     are fixed in the unrolled loop: a run-time boundary test at every
//     block left the consumers at about a tenth of an instruction a cycle.
//   * No atomics; a logit is the same sequence of operations whichever
//     stage, slot or batch computes it, so a row never depends on the other
//     rows and the compressed layout is bitwise the full layout's window.

#pragma once

#include <limits.h>

#include "gemm_sm90.cuh"

namespace dgt_mqa90 {

namespace sm90 = dgt::sm90;

enum class Elem { kE4m3, kBf16 };

// The entry an instance serves: kLinear the prefill logits (mqa_logits.cu),
// kPaged the paged logits (paged_mqa.cu). Only the e4m3 x e4m3 products
// differ between them (exact_e4m3); where a kv row lies is in Args.
enum class Source { kLinear, kPaged };

template <Elem kE>
__host__ __device__ constexpr int elem_bytes() { return kE == Elem::kBf16 ? 2 : 1; }

// Operand forms (q8 / kv8: the operand is e4m3): e4m3 x e4m3 on e4m3 wgmma;
// any bf16 operand on bf16 wgmma, an e4m3 q widened once an item into a bf16
// shared tile, an e4m3 kv widened in registers. kPaged widens e4m3 x e4m3
// too: exact products summed in f32, where e4m3 wgmma sums each k32 step at
// reduced precision (on the decode's top-2048, 68 of 512 selections then
// differed from the plain path's, against none on the mma.sync kernel
// before it: H100, chip_smoke.py phase 7).
__host__ __device__ constexpr bool exact_e4m3(Source s) { return s == Source::kPaged; }
__host__ __device__ constexpr bool math_e4m3(bool q8, bool kv8, Source s) {
    return q8 && kv8 && !exact_e4m3(s);
}
__host__ __device__ constexpr bool widen_q(bool q8, bool kv8, Source s) {
    return q8 && !math_e4m3(q8, kv8, s);
}
__host__ __device__ constexpr bool widen_kv(bool q8, bool kv8, Source s) {
    return kv8 && !math_e4m3(q8, kv8, s);
}

constexpr int kThreads = 384;        // two consumer warpgroups, then the producer's
constexpr int kMaxQg = 16;           // query rows an item (N 128 / 8 columns)
constexpr int kMaxStages = 8;
constexpr int kMaxPieces = 256;      // first cache rows of an item's pieces in shared memory
constexpr int kQBatch = 8;           // 16-byte chunks a lane of e4m3 q staged at once
// items an SM the paged run chooser aims at (paged_mqa.cu; at the decode
// shape 4 ran faster than 2, 8 and 16: an item's fixed cost against balance)
constexpr int kPagedItemsPerSm = 4;
// registers after setmaxnreg, the same total (168 a thread): the producer's
// warps walk an item's pieces and widen q, and take 64 (56 spilled), the
// consumers 216
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 216;

// kv rows a stage: two m64 halves, one where a query's heads take two n128
// halves (h > 128) and the q tile takes the shared memory.
__host__ __device__ constexpr int stage_rows(int nb) { return nb == 1 ? 128 : 64; }

struct Args {
    const uint8_t* q;        // [sq, h, d]
    const float* w;          // f32 [sq, h]
    const int* lo;           // [sq] first valid output column, or nullptr (0)
    const int* hi;           // [sq] end of the valid output columns
    const int* kv_base;      // [query tiles] or nullptr (see block_table)
    float* out;              // f32 [sq, out_cols]
    float fill;
    int has_sf;
    int sq, h, hp, d;
    int rows_per_tile, qg, groups_per_tile, num_groups;
    int out_cols, run, num_runs;   // run: kv stages an item at most
    int num_stages, q_bufs;
    // item (group, r) takes the stages r * item_first + k * stage_step, k < run
    int item_first, stage_step;
    // Column c of query tile t reads, below mb * block_kv, row c % block_kv of
    // its page: page block_table[t * mb + c / block_kv] (rows of block_kv
    // from 0), or where block_table is null the one page at row kv_base[t]
    // (kv_base null: t * tile_stride); a zero row at and past mb * block_kv.
    const int* block_table;
    const uint8_t* kv;       // [cache_rows, d] (read directly where tma is 0)
    const float* sf;         // [cache_rows] (has_sf) or nullptr
    int mb, block_kv, tile_stride, cache_rows;
    // 2^piece_shift rows a piece (a divisor of block_kv and of a stage): a
    // TMA box each where tma is 1 (pieces of 8 or more rows), else pieces of
    // one row that the producer warp copies
    int piece_shift, tma;
    // A stage's scales: row r of a stage that starts at column c0 at
    // [r + (kv_base[t] + c0) % 4] (kv_base null: [r]). sf_tma 1: a piece's
    // by one 1-D box of sf_box values from the 16-byte boundary at or before
    // its first row (boxes land 128-aligned: pieces of 32 or more rows, or
    // one a stage); 0: by 16-byte cp.async chunks (pieces of 8 or 16 rows).
    int sf_tma, sf_box;
};

// Shared memory, from a 1024-aligned base: the q buffers (none where e4m3 q
// is widened into bf16 tiles), the bf16 q tiles (one a buffer) and the
// staging area of their widening, the kv stages, their scales, each q
// buffer's w / lo / hi / window and the first cache rows of its item's
// pieces, each consumer warpgroup's two staged output tiles, the barriers.
struct Layout {
    int q, q16, q8, kv, sf, info, staging, bars, total;
    int q_buf, q16_tile, kv_stage, sf_stage, info_buf, staged;
};

__host__ __device__ inline int boxes(int d, int bytes) { return (d * bytes + 127) / 128; }

__host__ __device__ inline Layout layout(int nb, int d, int q_bytes, int kv_bytes, bool widen,
                                         int stages, int q_bufs, int qg) {
    const int n = 128 * nb, rows = stage_rows(nb);
    Layout l;
    l.q_buf = widen ? 0 : boxes(d, q_bytes) * n * 128;
    l.q16_tile = widen ? boxes(d, 2) * n * 128 : 0;
    l.kv_stage = boxes(d, kv_bytes) * rows * 128;
    l.sf_stage = ((rows + 4) * 4 + 127) / 128 * 128;
    l.info_buf = ((n + 2 * kMaxQg + 2 + kMaxPieces) * 4 + 15) / 16 * 16;
    l.staged = qg * rows;                // floats of one staged tile
    l.q = 0;
    l.q16 = l.q + q_bufs * l.q_buf;
    l.q8 = l.q16 + q_bufs * l.q16_tile;
    l.kv = l.q8 + (widen ? kQBatch * 32 * 16 : 0);
    l.sf = l.kv + stages * l.kv_stage;
    l.info = l.sf + stages * l.sf_stage;
    l.staging = l.info + q_bufs * l.info_buf;
    l.bars = l.staging + 2 * 2 * l.staged * 4;
    l.total = l.bars + (2 * stages + 3 * q_bufs + 2) * 8;
    return l;
}

// An item's query group: its first row, live rows and query tile.
struct Group {
    int row0, nq, tile;
};

__device__ __forceinline__ Group group_of(const Args& p, int gi) {
    Group g;
    g.tile = gi / p.groups_per_tile;
    g.row0 = g.tile * p.rows_per_tile + (gi - g.tile * p.groups_per_tile) * p.qg;
    const int tile_end = min(p.sq, (g.tile + 1) * p.rows_per_tile);
    g.nq = max(0, min(p.qg, tile_end - g.row0));
    return g;
}

__device__ __forceinline__ bool active(int c0, int rows, int win_lo, int win_hi) {
    return win_lo < win_hi && c0 < win_hi && c0 + rows > win_lo;
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2}], [%3];\n"
        :: "r"(sm90::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
           "r"(sm90::smem_u32(bar))
        : "memory");
}

// cp.async of `bytes` (16 or 4) from src, or zeros where !valid.
template <int kBytes>
__device__ __forceinline__ void copy_or_zero(void* dst, const void* src, bool valid) {
    if constexpr (kBytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Waits for the phase of parity `parity` to complete, as sm90::mbar_wait,
// but reads the global timer only once a wait has lasted 4096 polls (a
// stage here is a few hundred cycles of work: a timer read on every short
// wait would cost more than the wait). A wait past kWaitLimitNs traps.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = sm90::smem_u32(bar);
    uint64_t t0 = 0;
    for (uint32_t polls = 1; !sm90::mbar_try_wait(addr, parity); ++polls) {
        if (polls % 4096 == 0) {
            const uint64_t now = sm90::global_ns();
            if (t0 == 0) t0 = now;
            else if (now - t0 > sm90::kWaitLimitNs) __trap();
        }
    }
}

// A k-major 128-byte-swizzled operand's wgmma descriptor (sm90::smem_desc)
// from its low word: the address in 16-byte units, plus a step's offset; the
// high word (1024 bytes between 8-row atoms, the swizzle) is the same for
// every operand here.
__device__ __forceinline__ uint32_t desc_lo(const void* p) {
    return (sm90::smem_u32(p) & 0x3FFFF) >> 4;
}

__device__ __forceinline__ uint64_t desc(uint32_t lo) {
    return (static_cast<uint64_t>(0x40000040u) << 32) | lo;
}

using sm90::wgmma_bf16_rs;   // d[64 x 128] (+)= a (registers) . b (shared memory)^T, bf16
using sm90::wgmma_wait;      // until at most kPending wgmma groups are in flight

// kHp: a query's columns (h rounded up to a power of two, at least 8); N is
// 128 (kHp <= 128) or two n128 halves (kHp 256: one query). kS: the entry
// served (its e4m3 x e4m3 products).
template <Elem kQ, Elem kK, int kHp, Source kS = Source::kLinear>
__global__ void __launch_bounds__(kThreads, 1)
mqa_logits_sm90(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_kv,
                const __grid_constant__ CUtensorMap map_sf, const Args p) {
    constexpr int kNB = kHp > 128 ? 2 : 1;                           // n128 halves of N
    constexpr int kHpb = kHp / 8;                                    // n8 blocks a query
    constexpr int kN = 128 * kNB;
    constexpr int kRows = stage_rows(kNB);                           // kv rows a stage
    constexpr int kHalves = kRows / 64;                              // m64 halves a stage
    constexpr bool kQ8 = kQ == Elem::kE4m3, kKv8 = kK == Elem::kE4m3;
    constexpr bool kMathE4m3 = math_e4m3(kQ8, kKv8, kS);
    constexpr bool kWiden = widen_q(kQ8, kKv8, kS);       // q widened in smem
    constexpr bool kRegA = widen_kv(kQ8, kKv8, kS);       // kv widened in registers
    // m64 halves in flight at once (the register-A form holds one accumulator;
    // two spilled at kHp 8, and at kHp 16 with a bf16 kv on 216 registers)
    constexpr int kSets = (kRegA || kHp == 8 ||
                           (kHp == 16 && kK == Elem::kBf16 && kConsumerRegs < 232))
                              ? 1 : kHalves;
    constexpr int kQB = elem_bytes<kQ>(), kKB = elem_bytes<kK>();
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* base = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
    const int S = p.num_stages, QB = p.q_bufs;
    const Layout L = layout(kNB, p.d, kQB, kKB, kWiden, S, QB, p.qg);
    uint8_t* q_s = base + L.q;
    uint8_t* q16_s = base + L.q16;
    uint8_t* q8_s = base + L.q8;
    uint8_t* kv_s = base + L.kv;
    uint8_t* sf_s = base + L.sf;
    uint8_t* info_s = base + L.info;
    float* staging = reinterpret_cast<float*>(base + L.staging);
    uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
    uint64_t* empty = full + S;
    uint64_t* q_full = empty + S;         // [QB]: an item's w, window and q in place
    uint64_t* q_empty = q_full + QB;      // [QB]: the buffer's item done with
    uint64_t* ready = q_empty + QB;       // [QB]: an item's window and piece rows written
    uint64_t* issued = ready + QB;        // [2]: each consumer warpgroup's wgmma issues

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            sm90::mbar_init(full + s, 1);        // the producer's arrival, with the bytes
            sm90::mbar_init(empty + s, 4);       // the consuming warpgroup's warps
        }
        for (int b = 0; b < QB; ++b) {
            sm90::mbar_init(q_full + b, 64);     // warps 1 and 2's lanes, with q's bytes
            // both consumer warpgroups' warps and warp 0 (past the item's
            // stages, so that warp 1 never writes a buffer warp 0 reads)
            sm90::mbar_init(q_empty + b, 9);
            sm90::mbar_init(ready + b, 32);      // warp 1's lanes
        }
        sm90::mbar_init(issued, 1);
        sm90::mbar_init(issued + 1, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int num_items = p.num_groups * p.num_runs;
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    // an item buffer: w [kN] (slot jq * hp + head), lo, hi [kMaxQg], the
    // window, then the first cache rows of its pieces, [stage][piece]
    auto info_w = [&](int b) { return reinterpret_cast<float*>(info_s + b * L.info_buf); };
    auto info_lo = [&](int b) { return reinterpret_cast<int*>(info_w(b) + kN); };
    auto info_hi = [&](int b) { return info_lo(b) + kMaxQg; };
    auto info_win = [&](int b) { return info_hi(b) + kMaxQg; };
    auto info_rows = [&](int b) { return info_win(b) + 2; };
    // item (group, r)'s stages start at the kv columns c_first(r), c_first(r)
    // + c_step, ... below c_end(r)
    const int c_step = p.stage_step * kRows;
    auto c_first = [&](int r) { return r * p.item_first * kRows; };
    auto c_end = [&](int r) {
        return min(p.out_cols, (r * p.item_first + p.run * p.stage_step) * kRows);
    };

    if (wg == 2) {
        // ---- producer: warps 1 and 2 ready each item, up to q_bufs items
        // ahead of the consumers; warp 0 issues the item's stages once their
        // rows are written ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
        const int pw = (threadIdx.x % 128) / 32;
        if (pw >= 3) return;
        const int n_kv_boxes = boxes(p.d, kKB), n_q_boxes = boxes(p.d, kQB);
        // pieces of 2^sh rows, 2^ksh a stage
        const int sh = p.piece_shift, ksh = (kRows == 128 ? 7 : 6) - sh;
        if (kWiden && pw == 2) {
            // the bf16 q tiles zero once: the rows and columns no item writes
            // (past h and d) stay zero
            for (int i = lane; i < QB * L.q16_tile / 16; i += 32)
                reinterpret_cast<uint4*>(q16_s)[i] = make_uint4(0u, 0u, 0u, 0u);
        }
        int n = 0, used = 0;
        for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
            const int gi = t % p.num_groups, r = t / p.num_groups;
            const Group g = group_of(p, gi);
            if (g.nq == 0) continue;
            const int b = used % QB;
            const uint32_t phase = (used / QB) & 1;
            ++used;
            int* rows_s = info_rows(b);
            const int first = c_first(r), end = c_end(r);
            if (pw == 2) {
                // warp 2: the item's q rows
                wait(q_empty + b, phase ^ 1);
                if constexpr (kWiden) {
                    // the e4m3 rows (contiguous in global memory) widened into
                    // this buffer's bf16 tile, 128-byte swizzled: kQBatch
                    // 16-byte chunks a lane copied at once into the warp's
                    // staging area (cp.async: one load a lane at a time left
                    // ~16 round trips an item, and loads into registers
                    // spilled), then each widened into two bf16 chunks
                    const uint8_t* q8 = p.q + static_cast<int64_t>(g.row0) * p.h * p.d;
                    uint8_t* q16 = q16_s + b * L.q16_tile;
                    const int nc = p.d / 16, chunks = g.nq * p.h * nc;
                    #pragma unroll 1
                    for (int i0 = lane; i0 < chunks; i0 += 32 * kQBatch) {
                        #pragma unroll
                        for (int u = 0; u < kQBatch; ++u)
                            if (i0 + 32 * u < chunks)
                                copy_or_zero<16>(q8_s + (32 * u + lane) * 16,
                                                 q8 + static_cast<int64_t>(i0 + 32 * u) * 16, true);
                        asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
                        // (unrolled, this spilled the producer's registers)
                        #pragma unroll 1
                        for (int u = 0; u < kQBatch; ++u) {
                            const int i = i0 + 32 * u;
                            if (i >= chunks) break;
                            const uint4 v =
                                *reinterpret_cast<const uint4*>(q8_s + (32 * u + lane) * 16);
                            const int qh = i / nc, c = i - qh * nc;
                            const int jq = qh / p.h, row = jq * p.hp + (qh - jq * p.h);
                            const int lc = (c & 3) * 2;            // bf16 chunk in its box
                            uint8_t* dst = q16 + (c >> 2) * kN * 128 + row * 128;
                            *reinterpret_cast<uint4*>(dst + ((lc ^ (row & 7)) << 4)) =
                                make_uint4(dgt::e4m3x2_to_bf16x2(v.x),
                                           dgt::e4m3x2_to_bf16x2(v.x >> 16),
                                           dgt::e4m3x2_to_bf16x2(v.y),
                                           dgt::e4m3x2_to_bf16x2(v.y >> 16));
                            *reinterpret_cast<uint4*>(dst + (((lc + 1) ^ (row & 7)) << 4)) =
                                make_uint4(dgt::e4m3x2_to_bf16x2(v.z),
                                           dgt::e4m3x2_to_bf16x2(v.z >> 16),
                                           dgt::e4m3x2_to_bf16x2(v.w),
                                           dgt::e4m3x2_to_bf16x2(v.w >> 16));
                        }
                    }
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                    sm90::mbar_arrive(q_full + b);
                } else if (lane == 0) {
                    sm90::mbar_arrive_expect_tx(q_full + b, n_q_boxes * p.qg * p.hp * 128);
                    for (int kb = 0; kb < n_q_boxes; ++kb)
                        sm90::tma_load_3d(q_s + b * L.q_buf + kb * kN * 128, &map_q, q_full + b,
                                          kb * 128, 0, g.row0);
                } else {
                    sm90::mbar_arrive(q_full + b);
                }
                continue;
            }
            if (pw == 1) {
                // warp 1: the item's window and piece rows (which warp 0
                // waits for), then its w
                wait(q_empty + b, phase ^ 1);
                int* lo_s = info_lo(b);
                int* hi_s = info_hi(b);
                int wl = INT_MAX, wh = INT_MIN;
                for (int i = lane; i < kMaxQg; i += 32) {
                    const int l = i >= g.nq ? INT_MAX
                                  : p.lo != nullptr ? __ldg(p.lo + g.row0 + i) : 0;
                    const int hgh = i < g.nq ? __ldg(p.hi + g.row0 + i) : INT_MIN;
                    lo_s[i] = l;
                    hi_s[i] = hgh;
                    if (l < hgh) { wl = min(wl, l); wh = max(wh, hgh); }
                }
                #pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    wl = min(wl, __shfl_xor_sync(0xffffffffu, wl, o));
                    wh = max(wh, __shfl_xor_sync(0xffffffffu, wh, o));
                }
                if (lane == 0) {
                    info_win(b)[0] = wl;
                    info_win(b)[1] = wh;
                }
                // the first cache row of each piece of the item's active
                // stages (at and past the cache: cache_rows, wholly out of
                // range, so zeros)
                const int cache_end = p.mb * p.block_kv;
                const int* table = p.block_table != nullptr
                                       ? p.block_table + static_cast<int64_t>(g.tile) * p.mb
                                       : nullptr;
                const int page = p.kv_base != nullptr ? __ldg(p.kv_base + g.tile)
                                                      : g.tile * p.tile_stride;
                const int count = ((end - first + c_step - 1) / c_step) << ksh;
                #pragma unroll 1
                for (int i = lane; i < count; i += 32) {
                    const int c0 = first + (i >> ksh) * c_step;
                    const int c = c0 + ((i & ((1 << ksh) - 1)) << sh);
                    if (!active(c0, kRows, wl, wh)) continue;
                    int row = p.cache_rows;
                    if (c < cache_end) {
                        const int slot = c / p.block_kv;
                        row = (table != nullptr ? __ldg(table + slot) * p.block_kv : page) +
                              (c - slot * p.block_kv);
                    }
                    rows_s[i] = row;
                }
                sm90::mbar_arrive(ready + b);
                float* w_s = info_w(b);
                auto fill_w = [&](int i) {
                    const int jq = i / p.hp, hh = i - jq * p.hp;
                    w_s[i] = (jq < g.nq && hh < p.h)
                                 ? __ldg(p.w + static_cast<int64_t>(g.row0 + jq) * p.h + hh)
                                 : 0.f;
                };
                if constexpr (kN == 128) {
                    #pragma unroll
                    for (int i = lane; i < kN; i += 32) fill_w(i);
                } else {
                    // one load in flight a lane (more spilled)
                    #pragma unroll 1
                    for (int i = lane; i < kN; i += 32) fill_w(i);
                }
                sm90::mbar_arrive(q_full + b);
                continue;
            }
            // warp 0: the item's stages
            wait(ready + b, phase);
            const int wl = info_win(b)[0], wh = info_win(b)[1];
            if (p.tma) {
                // lane 0: a box a piece, and a box of its scales (the other
                // lanes leave: polling for the next items slowed lane 0)
                if (lane != 0) return;
                const bool sf_tma = p.has_sf && p.sf_tma, sf_chunks = p.has_sf && !p.sf_tma;
                const uint32_t kv_bytes =
                    n_kv_boxes * kRows * 128 + (sf_tma ? (p.sf_box << ksh) * 4 : 0);
                for (int c0 = first, k = 0; c0 < end; c0 += c_step, ++k) {
                    if (!active(c0, kRows, wl, wh)) continue;
                    const int s = n % S;
                    wait(empty + s, ((n / S) & 1) ^ 1);
                    ++n;
                    uint8_t* sf_st = sf_s + s * L.sf_stage;
                    if (sf_chunks) {
                        // the pieces' scales, zero past the cache, tracked by
                        // the stage's barrier
                        for (int i = 0; i < (1 << ksh); ++i) {
                            const int row = rows_s[(k << ksh) + i];
                            const bool valid = row < p.cache_rows;
                            for (int j = 0; j < (1 << sh); j += 4)
                                copy_or_zero<16>(sf_st + ((i << sh) + j) * 4,
                                                 p.sf + (valid ? row : 0) + j, valid);
                        }
                        asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
                                     :: "r"(sm90::smem_u32(full + s)) : "memory");
                    }
                    sm90::mbar_arrive_expect_tx(full + s, kv_bytes);
                    for (int i = 0; i < (1 << ksh); ++i) {
                        const int row = rows_s[(k << ksh) + i];
                        for (int kb = 0; kb < n_kv_boxes; ++kb)
                            sm90::tma_load_2d(kv_s + s * L.kv_stage + kb * kRows * 128 +
                                                  (i << sh) * 128,
                                              &map_kv, full + s, kb * 128, row);
                        if (sf_tma)
                            tma_load_1d(sf_st + (i << sh) * 4, &map_sf, full + s, row & ~3);
                    }
                }
                sm90::mbar_arrive(q_empty + b);
                continue;
            }
            // pieces of one row: the warp copies them to their swizzled places
            // (zeros past the cache and past d), then the proxy fence for the
            // wgmma's reads, then one arrival
            for (int c0 = first, k = 0; c0 < end; c0 += c_step, ++k) {
                if (!active(c0, kRows, wl, wh)) continue;
                const int s = n % S;
                wait(empty + s, ((n / S) & 1) ^ 1);
                ++n;
                const int* rows = rows_s + (k << ksh);
                const int row_bytes = p.d * kKB;
                #pragma unroll 1
                for (int rr = 0; rr < kRows; ++rr) {
                    const int row = rows[rr];
                    // a lane a 16-byte chunk of the row's 128-byte boxes
                    if (lane < n_kv_boxes * 8) {
                        const bool valid = row < p.cache_rows && lane * 16 < row_bytes;
                        copy_or_zero<16>(kv_s + s * L.kv_stage + (lane >> 3) * kRows * 128 +
                                             rr * 128 + (((lane & 7) ^ (rr & 7)) << 4),
                                         p.kv + static_cast<int64_t>(valid ? row : 0) *
                                                    row_bytes + lane * 16,
                                         valid);
                    }
                }
                if (p.has_sf) {
                    #pragma unroll 1
                    for (int rr = lane; rr < kRows; rr += 32) {
                        const int row = rows[rr];
                        copy_or_zero<4>(sf_s + s * L.sf_stage + rr * 4,
                                        p.sf + (row < p.cache_rows ? row : 0),
                                        row < p.cache_rows);
                    }
                }
                asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                __syncwarp();
                if (lane == 0) sm90::mbar_arrive(full + s);
            }
            if (lane == 0) sm90::mbar_arrive(q_empty + b);
        }
        return;
    }

    // ---- consumers: warpgroup wg takes the loaded stages n with n % 2 == wg ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int gr = lane / 4, tg = lane % 4;
    const int r0 = warp * 16 + gr;                 // its kv rows of an m64 half: r0, r0 + 8
    const int q2 = 2 * tg;                         // its columns: 8 j + q2, 8 j + q2 + 1
    const int steps = p.d * (kMathE4m3 ? 1 : 2) / 32;   // 32-byte k steps
    float acc[kSets][64];
    float wr[32];                       // w at this thread's columns of one n128 half
    #pragma unroll
    for (int u = 0; u < kSets; ++u)
        #pragma unroll
        for (int i = 0; i < 64; ++i) acc[u][i] = 0.f;
    int n = 0, used = 0, staged = 0;
    for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
        const int gi = t % p.num_groups, r = t / p.num_groups;
        const Group g = group_of(p, gi);
        if (g.nq == 0) continue;
        const int b = used % QB;
        wait(q_full + b, (used / QB) & 1);
        ++used;
        const float* w_s = info_w(b);
        const int* lo_s = info_lo(b);
        const int* hi_s = info_hi(b);
        const int wl = info_win(b)[0], wh = info_win(b)[1];
        const uint8_t* qb_s = kWiden ? q16_s + b * L.q16_tile : q_s + b * L.q_buf;
        const int kv0 = p.kv_base != nullptr ? __ldg(p.kv_base + g.tile) : 0;
        if constexpr (kNB == 1) {
            #pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float2 w2 = *reinterpret_cast<const float2*>(w_s + 8 * j + q2);
                wr[2 * j] = w2.x;
                wr[2 * j + 1] = w2.y;
            }
        }
        const int end = c_end(r);
        for (int c0 = c_first(r), tt = 0; c0 < end; c0 += c_step, ++tt) {
            if (!active(c0, kRows, wl, wh)) {
                // no row of the group sees this stage: the fill, by turns
                if ((tt & 1) == wg)
                    for (int i = tid; i < g.nq * kRows; i += 128) {
                        const int c = c0 + (i & (kRows - 1));
                        if (c < p.out_cols)
                            p.out[static_cast<int64_t>(g.row0 + i / kRows) * p.out_cols + c] =
                                p.fill;
                    }
                continue;
            }
            const int mine = n;
            ++n;
            if ((mine & 1) != wg) continue;
            const int s = mine % S;
            wait(full + s, (mine / S) & 1);
            // the other warpgroup's stage before this one has been issued
            if (mine > 0) wait(issued + (wg ^ 1), ((mine - 1) >> 1) & 1);
            const uint8_t* kv_tile = kv_s + s * L.kv_stage;
            float* st = staging + (wg * 2 + (staged & 1)) * L.staged;   // [query][row]
            ++staged;
            // the scales of its rows, read before the stage is released
            float sf0[kHalves], sf1[kHalves];
            const float* sfs = reinterpret_cast<const float*>(sf_s + s * L.sf_stage) +
                               ((kv0 + c0) & 3);
            #pragma unroll
            for (int h = 0; h < kHalves; ++h) {
                sf0[h] = p.has_sf ? sfs[64 * h + r0] : 1.f;
                sf1[h] = p.has_sf ? sfs[64 * h + r0 + 8] : 1.f;
            }
            // each half's running head sums: rows r0 and r0 + 8, its two
            // columns of a block apart
            float s0[kHalves], s1[kHalves], s2[kHalves], s3[kHalves];
            #pragma unroll
            for (int h = 0; h < kHalves; ++h) s0[h] = s1[h] = s2[h] = s3[h] = 0.f;
            #pragma unroll
            for (int h0 = 0; h0 < kHalves; h0 += kSets) {
                // (two n128 halves unrolled spilled; one iteration at kNB 1)
                #pragma unroll 1
                for (int nb = 0; nb < kNB; ++nb) {
                    // issue halves h0 .. h0 + kSets - 1, a commit group each
                    #pragma unroll
                    for (int u = 0; u < kSets; ++u) {
                        const uint8_t* kv_half = kv_tile + (h0 + u) * 64 * 128;
                        #pragma unroll
                        for (int i = 0; i < 64; ++i) sm90::fence_operand(acc[u][i]);
                        if constexpr (!kRegA) {
                            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                            // step k: 128-byte box k / 4 (kRows or kN rows on), +32
                            // bytes (2 in 16-byte units) a step inside it
                            const uint32_t a0 = desc_lo(kv_half);
                            const uint32_t b0 = desc_lo(qb_s + nb * 128 * 128);
                            auto mma = [&](int k) {
                                const uint32_t a = a0 + (k >> 2) * (kRows * 8) + (k & 3) * 2;
                                const uint32_t b = b0 + (k >> 2) * (kN * 8) + (k & 3) * 2;
                                if constexpr (kMathE4m3)
                                    sm90::wgmma_e4m3(acc[u], desc(a), desc(b), k);
                                else
                                    sm90::wgmma_bf16<0>(acc[u], desc(a), desc(b), k);
                            };
                            for (int k0 = 0; k0 + 4 <= steps; k0 += 4) {
                                #pragma unroll
                                for (int k = 0; k < 4; ++k) mma(k0 + k);
                            }
                            for (int k = steps & ~3; k < steps; ++k) mma(k);
                            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                        } else {
                            // kv e4m3 widened into the A fragment, kGroup k16
                            // steps a group, in two register sets: the next
                            // group widens while this one's wgmmas run (a
                            // fragment's registers are read until its wgmma
                            // completes; four a group spilled beside two
                            // n128 halves)
                            constexpr int kGroup = kNB == 1 ? 4 : 2;
                            const uint64_t db = sm90::smem_desc(qb_s + nb * 128 * 128);
                            uint32_t a0[kGroup][4], a1[kGroup][4];
                            auto widen_a = [&](int k0, uint32_t (&a)[kGroup][4]) {
                                #pragma unroll
                                for (int v = 0; v < kGroup; ++v) {
                                    const int k = k0 + v;
                                    const int box = k >> 3, ch = k & 7;
                                    const uint8_t* row = kv_half + box * kRows * 128 + r0 * 128 +
                                                         ((ch ^ (r0 & 7)) << 4) + q2;
                                    // rows r0 and r0 + 8, elements k, k + 8
                                    #pragma unroll
                                    for (int e = 0; e < 4; ++e)
                                        a[v][e] = dgt::e4m3x2_to_bf16x2(dgt::ld_shared_u16(
                                            row + (e & 1) * 8 * 128 + (e >> 1) * 8));
                                }
                            };
                            auto issue_a = [&](int k0, uint32_t (&a)[kGroup][4]) {
                                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                                #pragma unroll
                                for (int v = 0; v < kGroup; ++v) {
                                    const int k = k0 + v;
                                    const uint64_t ob = ((k >> 2) * kN * 128 + (k & 3) * 32) >> 4;
                                    if (k < steps) wgmma_bf16_rs(acc[u], a[v], db + ob, k);
                                }
                                asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                            };
                            widen_a(0, a0);
                            for (int k0 = 0; k0 < steps; k0 += 2 * kGroup) {
                                issue_a(k0, a0);
                                if (k0 + kGroup < steps) {
                                    wgmma_wait<1>();       // the group before, on a1, is done
                                    widen_a(k0 + kGroup, a1);
                                    issue_a(k0 + kGroup, a1);
                                }
                                if (k0 + 2 * kGroup < steps) {
                                    wgmma_wait<1>();       // a0's group is done
                                    widen_a(k0 + 2 * kGroup, a0);
                                }
                            }
                            wgmma_wait<0>();
                        }
                    }
                    if (h0 == 0 && nb == 0 && tid == 0) sm90::mbar_arrive(issued + wg);
                    // sum each half as its wgmmas finish (the operand fences after
                    // the wait keep every read of the half's accumulator behind it:
                    // without them the compiler hoisted the second half's reads
                    // above its wait)
                    #pragma unroll
                    for (int u = 0; u < kSets; ++u) {
                        const int h = h0 + u;
                        if (u + 1 < kSets) wgmma_wait<kSets - 1>();
                        else wgmma_wait<0>();
                        #pragma unroll
                        for (int i = 0; i < 64; ++i) sm90::fence_operand(acc[u][i]);
                        if (h == kHalves - 1 && nb == kNB - 1) {
                            __syncwarp();
                            if (lane == 0) sm90::mbar_arrive(empty + s);
                        }
                        if constexpr (kNB == 2) {
                            // this n128 half's w (loaded as the epilogue needs it,
                            // a half at a time: both halves' spilled)
                            #pragma unroll
                            for (int j = 0; j < 16; ++j) {
                                const float2 w2 =
                                    *reinterpret_cast<const float2*>(w_s + nb * 128 + 8 * j + q2);
                                wr[2 * j] = w2.x;
                                wr[2 * j + 1] = w2.y;
                            }
                        }
                        #pragma unroll
                        for (int j = 0; j < 16; ++j) {
                            const float* a = acc[u] + 4 * j;
                            const float w0 = wr[2 * j], w1 = wr[2 * j + 1];
                            s0[h] = fmaf(fmaxf(a[0], 0.f), w0, s0[h]);
                            s1[h] = fmaf(fmaxf(a[1], 0.f), w1, s1[h]);
                            s2[h] = fmaf(fmaxf(a[2], 0.f), w0, s2[h]);
                            s3[h] = fmaf(fmaxf(a[3], 0.f), w1, s3[h]);
                            const int J = nb * 16 + j;       // the block's place in N
                            if ((J + 1) % kHpb == 0) {
                                // query J / kHpb: the quad's four lanes in a fixed
                                // order (every lane gets the same bits), times sf
                                const int jq = J / kHpb;
                                float x = __fadd_rn(s0[h], s1[h]), y = __fadd_rn(s2[h], s3[h]);
                                x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
                                y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, 1));
                                x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
                                y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, 2));
                                if (jq < g.nq && (jq & 3) == tg) {
                                    st[jq * kRows + 64 * h + r0] = __fmul_rn(x, sf0[h]);
                                    st[jq * kRows + 64 * h + r0 + 8] = __fmul_rn(y, sf1[h]);
                                }
                                s0[h] = s1[h] = s2[h] = s3[h] = 0.f;
                            }
                        }
                    }
                }
            }
            sm90::named_barrier(2 + wg, 128);
            for (int i = tid; i < g.nq * kRows; i += 128) {
                const int rq = i / kRows, c = c0 + (i & (kRows - 1));
                if (c < p.out_cols)
                    p.out[static_cast<int64_t>(g.row0 + rq) * p.out_cols + c] =
                        (c >= lo_s[rq] && c < hi_s[rq]) ? st[i] : p.fill;
            }
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(q_empty + b);
    }
}

// ---- host side ----

constexpr int kSmemLimit = sm90::kSmemLimit;

// The item's shape for h heads: hp (h rounded up to a power of two, at
// least 8: the instance's kHp), the n128 halves, query rows an item (inside
// one tile of rows_per_tile rows; at most max_qg unless 0), kv rows a stage.
struct Shape {
    int hp, nb, qg, groups_per_tile, rows;
};

inline Shape shape_of(int h, int rows_per_tile, int max_qg) {
    Shape s;
    for (s.hp = 8; s.hp < h; s.hp *= 2) {}
    s.nb = s.hp > 128 ? 2 : 1;
    s.qg = rows_per_tile < 128 * s.nb / s.hp ? rows_per_tile : 128 * s.nb / s.hp;
    if (max_qg > 0 && s.qg > max_qg) s.qg = max_qg;
    s.groups_per_tile = (rows_per_tile + s.qg - 1) / s.qg;
    s.rows = stage_rows(s.nb);
    return s;
}

// The stages and q buffers that fit: two q buffers and up to kMaxStages
// stages, one q buffer where two leave fewer than 3 stages; 0 stages where
// not even 2 fit.
inline void fit(int nb, int d, int q_bytes, int kv_bytes, bool widen, int qg, int* stages,
                int* q_bufs) {
    for (int qb = 2; qb >= 1; --qb) {
        int s = kMaxStages;
        while (s >= 2 &&
               layout(nb, d, q_bytes, kv_bytes, widen, s, qb, qg).total + 1024 >
                   kSmemLimit)
            --s;
        if (s >= 3 || (qb == 1 && s >= 2)) {
            *stages = s;
            *q_bufs = qb;
            return;
        }
    }
    *stages = *q_bufs = 0;
}

// sf [skv] f32 in boxes of box_rows values (Args' sf_box); zero past skv.
inline bool make_map_sf(CUtensorMap* map, const void* sf, uint64_t skv, uint32_t box_rows) {
    const sm90::EncodeTiled encode = sm90::encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[1] = {skv};
    const cuuint64_t strides[1] = {skv * 4};     // not read at rank 1
    const cuuint32_t box[1] = {box_rows};
    const cuuint32_t elem[1] = {1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(sf), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q [sq, h, row_bytes] in boxes of [qg, hp, 128 bytes], 128-byte swizzled;
// zero past h and sq.
inline bool make_map_q(CUtensorMap* map, const void* q, uint64_t row_bytes, uint64_t h,
                       uint64_t sq, uint32_t hp, uint32_t qg) {
    const sm90::EncodeTiled encode = sm90::encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {row_bytes, h, sq};
    const cuuint64_t strides[2] = {row_bytes, row_bytes * h};
    const cuuint32_t box[3] = {128, hp, qg};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(q), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// static: each library keeps its own opt-in flags (see gemm_sm90.cuh launch)
template <Elem kQ, Elem kK, int kHp, Source kS>
static inline cudaError_t launch(const CUtensorMap& map_q, const CUtensorMap& map_kv,
                                 const CUtensorMap& map_sf, const Args& p, int num_sms,
                                 cudaStream_t stream) {
    constexpr bool kWiden = widen_q(kQ == Elem::kE4m3, kK == Elem::kE4m3, kS);
    constexpr int kNB = kHp > 128 ? 2 : 1;
    const int smem = layout(kNB, p.d, elem_bytes<kQ>(), elem_bytes<kK>(), kWiden, p.num_stages,
                            p.q_bufs, p.qg).total + 1024;
    if (p.hp != kHp) return cudaErrorInvalidValue;
    auto kernel = mqa_logits_sm90<kQ, kK, kHp, kS>;
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !opted_in[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
        if (err != cudaSuccess) return err;
        if (dev < 64) opted_in[dev] = true;
    }
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    const long long items = static_cast<long long>(p.num_groups) * p.num_runs;
    const int grid = static_cast<int>(items < num_sms ? items : num_sms);
    kernel<<<grid, kThreads, smem, stream>>>(map_q, map_kv, map_sf, p);
    return cudaGetLastError();
}

template <Elem kQ, Elem kK, Source kS = Source::kLinear>
inline cudaError_t launch_hp(const CUtensorMap& map_q, const CUtensorMap& map_kv,
                             const CUtensorMap& map_sf, const Args& p, int num_sms,
                             cudaStream_t stream) {
    switch (p.hp) {
        case 8: return launch<kQ, kK, 8, kS>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 16: return launch<kQ, kK, 16, kS>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 32: return launch<kQ, kK, 32, kS>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 64: return launch<kQ, kK, 64, kS>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 128: return launch<kQ, kK, 128, kS>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 256: return launch<kQ, kK, 256, kS>(map_q, map_kv, map_sf, p, num_sms, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The instance for the operands' types: q_bf16 / kv_bf16 nonzero for bf16,
// zero for e4m3.
template <Source kS>
inline cudaError_t launch_typed(const CUtensorMap& map_q, const CUtensorMap& map_kv,
                                const CUtensorMap& map_sf, const Args& p, int q_bf16, int kv_bf16,
                                int num_sms, cudaStream_t s) {
    if (!q_bf16 && !kv_bf16)
        return launch_hp<Elem::kE4m3, Elem::kE4m3, kS>(map_q, map_kv, map_sf, p, num_sms, s);
    if (q_bf16 && kv_bf16)
        return launch_hp<Elem::kBf16, Elem::kBf16, kS>(map_q, map_kv, map_sf, p, num_sms, s);
    if (q_bf16)
        return launch_hp<Elem::kBf16, Elem::kE4m3, kS>(map_q, map_kv, map_sf, p, num_sms, s);
    return launch_hp<Elem::kE4m3, Elem::kBf16, kS>(map_q, map_kv, map_sf, p, num_sms, s);
}

}  // namespace dgt_mqa90
