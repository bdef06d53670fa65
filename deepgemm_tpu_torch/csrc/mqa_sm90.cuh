// MQA ("lightning indexer") logits of the prefill side on Hopper:
//
//   logits[i, c] = sum_h w[i, h] * relu(q[i, h, :] . kv[base_i + c, :]) * sf[base_i + c]
//
// for the output columns c in [lo[i], hi[i]) of each query row i, and the
// fill (-inf, or 0 in the compressed layout) elsewhere.
//
// Replaces the body of deepgemm_tpu/kernels/mqa_logits.py:_build_mqa_logits
// (pl.pallas_call at mqa_logits.py:133; its body at :100-125). The paged
// entries (paged_mqa.cu) stay on mqa_tile.cuh.
//
// What bounds it on the H100: the prefill bench shape (2048 x 8192, 64 heads
// x 128) does ~1000 fp8 operations a byte: the tensor cores, at wgmma's rate
// only (e4m3 mma.sync runs as f16 HMMA on sm_90a). The head sum costs two
// CUDA-core instructions an accumulator element, half the wgmma time of an
// element at d = 128: it must run under wgmmas in flight.
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
//   * Work items: (query group, run of kv stages), the groups of one run
//     neighbours in the item order, so the blocks running at once read the
//     same kv rows from L2. A query group lies inside one query tile of
//     rows_per_tile rows (the compressed layout's unit: one kv base a tile,
//     as JAX's host check of the layout, kernels/mqa_logits.py:176-200). A
//     persistent grid of at most one block an SM walks the items.
//   * One producer warp (its lane 0 issues every TMA): an item's q rows (3-D
//     tensor map [sq, h, d bytes], boxes of [qg, hp, 128 bytes], zero past
//     h and sq) into one of two q buffers, its w, lo and hi (the 32 lanes)
//     and the union of its rows' windows; then each stage of kRows kv rows
//     (128; 64 at h > 128) that meets the window (128-byte swizzled boxes,
//     zero past skv) and its scales (a 1-D map read from the 16-byte
//     boundary at or before the stage's first row: a compressed stage
//     starts at any kv row, and a tensor copy from an unaligned start
//     faulted on the card) into a ring with full and empty mbarriers. A
//     stage outside every row's [lo, hi) loads nothing: its warpgroup
//     writes the fill.
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

template <Elem kE>
__host__ __device__ constexpr int elem_bytes() { return kE == Elem::kBf16 ? 2 : 1; }

constexpr int kThreads = 384;        // two consumer warpgroups, then the producer's
constexpr int kMaxQg = 16;           // query rows an item (N 128 / 8 columns)
constexpr int kMaxStages = 8;

// kv rows a stage: two m64 halves, one where a query's heads take two n128
// halves (h > 128) and the q tile takes the shared memory.
__host__ __device__ constexpr int stage_rows(int nb) { return nb == 1 ? 128 : 64; }

struct Args {
    const uint8_t* q;        // [sq, h, d] (read directly by the widening instance)
    const float* w;          // f32 [sq, h]
    const int* lo;           // [sq] first valid output column
    const int* hi;           // [sq] end of the valid output columns
    const int* kv_base;      // [query tiles] or nullptr (0)
    float* out;              // f32 [sq, out_cols]
    float fill;
    int has_sf;
    int sq, h, hp, d;
    int rows_per_tile, qg, groups_per_tile, num_groups;
    int out_cols, run, num_runs;   // run: kv stages an item
    int num_stages, q_bufs;
};

// Shared memory, from a 1024-aligned base: the q buffers (none where e4m3 q
// is widened from global memory into the one bf16 tile), the bf16 q tile
// (e4m3 q with bf16 kv), the kv stages, their scales (rows + 4 from the
// 16-byte boundary), each q buffer's w / lo / hi / window, each consumer
// warpgroup's two staged output tiles, the barriers.
struct Layout {
    int q, q16, kv, sf, info, staging, bars, total;
    int q_buf, kv_stage, sf_stage, info_buf, staged;
};

__host__ __device__ inline int boxes(int d, int bytes) { return (d * bytes + 127) / 128; }

__host__ __device__ inline Layout layout(int nb, int d, int q_bytes, int kv_bytes, bool widen,
                                         int stages, int q_bufs, int qg) {
    const int n = 128 * nb, rows = stage_rows(nb);
    Layout l;
    l.q_buf = widen ? 0 : boxes(d, q_bytes) * n * 128;
    l.kv_stage = boxes(d, kv_bytes) * rows * 128;
    l.sf_stage = ((rows + 4) * 4 + 127) / 128 * 128;     // tensor copies land 128-aligned
    l.info_buf = ((n + 2 * kMaxQg + 2) * 4 + 15) / 16 * 16;
    l.staged = qg * rows;                // floats of one staged tile
    l.q = 0;
    l.q16 = l.q + q_bufs * l.q_buf;
    l.kv = l.q16 + (widen ? boxes(d, 2) * n * 128 : 0);
    l.sf = l.kv + stages * l.kv_stage;
    l.info = l.sf + stages * l.sf_stage;
    l.staging = l.info + q_bufs * l.info_buf;
    l.bars = l.staging + 2 * 2 * l.staged * 4;
    l.total = l.bars + (2 * stages + 2 * q_bufs + 2) * 8;
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
// 128 (kHp <= 128) or two n128 halves (kHp 256: one query).
template <Elem kQ, Elem kK, int kHp>
__global__ void __launch_bounds__(kThreads, 1)
mqa_logits_sm90(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_kv,
                const __grid_constant__ CUtensorMap map_sf, const Args p) {
    constexpr int kNB = kHp > 128 ? 2 : 1;                           // n128 halves of N
    constexpr int kHpb = kHp / 8;                                    // n8 blocks a query
    constexpr int kN = 128 * kNB;
    constexpr int kRows = stage_rows(kNB);                           // kv rows a stage
    constexpr int kHalves = kRows / 64;                              // m64 halves a stage
    constexpr bool kMathE4m3 = kQ == Elem::kE4m3 && kK == Elem::kE4m3;
    constexpr bool kWiden = kQ == Elem::kE4m3 && kK == Elem::kBf16;     // q widened in smem
    constexpr bool kRegA = kQ == Elem::kBf16 && kK == Elem::kE4m3;      // kv widened in registers
    // m64 halves in flight at once (the register-A form holds one accumulator)
    constexpr int kSets = (kRegA || kHp == 8) ? 1 : kHalves;   // (kHp 8: two spilled)
    constexpr int kQB = elem_bytes<kQ>(), kKB = elem_bytes<kK>();
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* base = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
    const int S = p.num_stages, QB = p.q_bufs;
    const Layout L = layout(kNB, p.d, kQB, kKB, kWiden, S, QB, p.qg);
    uint8_t* q_s = base + L.q;
    uint8_t* q16_s = base + L.q16;
    uint8_t* kv_s = base + L.kv;
    uint8_t* sf_s = base + L.sf;
    uint8_t* info_s = base + L.info;
    float* staging = reinterpret_cast<float*>(base + L.staging);
    uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
    uint64_t* empty = full + S;
    uint64_t* q_full = empty + S;
    uint64_t* q_empty = q_full + QB;
    uint64_t* issued = q_empty + QB;      // [2]: each consumer warpgroup's wgmma issues

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            sm90::mbar_init(full + s, 1);        // the producer's arrival, with the bytes
            sm90::mbar_init(empty + s, 4);       // the consuming warpgroup's warps
        }
        for (int b = 0; b < QB; ++b) {
            sm90::mbar_init(q_full + b, 32);     // the producer warp's lanes, with the bytes
            sm90::mbar_init(q_empty + b, 8);     // both consumer warpgroups' warps
        }
        sm90::mbar_init(issued, 1);
        sm90::mbar_init(issued + 1, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int num_items = p.num_groups * p.num_runs;
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int n_kv_boxes = boxes(p.d, kKB), n_q_boxes = boxes(p.d, kQB);
    // an item buffer: w [kN] (slot jq * hp + head), lo, hi [kMaxQg], the window
    auto info_w = [&](int b) { return reinterpret_cast<float*>(info_s + b * L.info_buf); };
    auto info_lo = [&](int b) { return reinterpret_cast<int*>(info_w(b) + kN); };
    auto info_hi = [&](int b) { return info_lo(b) + kMaxQg; };
    auto info_win = [&](int b) { return info_hi(b) + kMaxQg; };

    if (wg == 2) {
        // ---- producer: one warp; lane 0 issues the TMA loads ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(sm90::kProducerRegs));
        if (threadIdx.x % 128 >= 32) return;
        const uint32_t q_bytes = n_q_boxes * p.qg * p.hp * 128;    // qg x hp rows a box
        const uint32_t kv_bytes = n_kv_boxes * kRows * 128 + (p.has_sf ? (kRows + 4) * 4 : 0);
        int n = 0, used = 0;
        for (int t = blockIdx.x; t < num_items; t += gridDim.x) {
            const int gi = t % p.num_groups, r = t / p.num_groups;
            const Group g = group_of(p, gi);
            if (g.nq == 0) continue;
            const int b = used % QB;
            wait(q_empty + b, ((used / QB) & 1) ^ 1);
            ++used;
            float* w_s = info_w(b);
            int* lo_s = info_lo(b);
            int* hi_s = info_hi(b);
            auto fill_w = [&](int i) {
                const int jq = i / p.hp, hh = i - jq * p.hp;
                w_s[i] = (jq < g.nq && hh < p.h)
                             ? __ldg(p.w + static_cast<int64_t>(g.row0 + jq) * p.h + hh) : 0.f;
            };
            if constexpr (kN == 128) {
                #pragma unroll
                for (int i = lane; i < kN; i += 32) fill_w(i);
            } else {
                // one load in flight a lane: more spilled the producer's 40 registers
                #pragma unroll 1
                for (int i = lane; i < kN; i += 32) fill_w(i);
            }
            int wl = INT_MAX, wh = INT_MIN;
            for (int i = lane; i < kMaxQg; i += 32) {
                const int l = i < g.nq ? __ldg(p.lo + g.row0 + i) : INT_MAX;
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
            if (lane == 0 && !kWiden) {
                sm90::mbar_arrive_expect_tx(q_full + b, q_bytes);
                for (int kb = 0; kb < n_q_boxes; ++kb)
                    sm90::tma_load_3d(q_s + b * L.q_buf + kb * kN * 128, &map_q, q_full + b,
                                      kb * 128, 0, g.row0);
            } else {
                sm90::mbar_arrive(q_full + b);
            }
            if (lane != 0) continue;
            const int kv0 = p.kv_base != nullptr ? __ldg(p.kv_base + g.tile) : 0;
            const int c_end = min(p.out_cols, (r + 1) * p.run * kRows);
            for (int c0 = r * p.run * kRows; c0 < c_end; c0 += kRows) {
                if (!active(c0, kRows, wl, wh)) continue;
                const int s = n % S;
                wait(empty + s, ((n / S) & 1) ^ 1);
                ++n;
                sm90::mbar_arrive_expect_tx(full + s, kv_bytes);
                for (int kb = 0; kb < n_kv_boxes; ++kb)
                    sm90::tma_load_2d(kv_s + s * L.kv_stage + kb * kRows * 128, &map_kv, full + s,
                                      kb * 128, kv0 + c0);
                if (p.has_sf)
                    tma_load_1d(sf_s + s * L.sf_stage, &map_sf, full + s, (kv0 + c0) & ~3);
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg takes the loaded stages n with n % 2 == wg ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(sm90::kConsumerRegs));
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
        const uint8_t* qb_s = q_s + b * L.q_buf;
        const int kv0 = p.kv_base != nullptr ? __ldg(p.kv_base + g.tile) : 0;
        if constexpr (kWiden) {
            // the item's e4m3 q rows from global memory into the bf16 tile
            // (zero past d, h and the group's rows), once both warpgroups'
            // wgmmas on the last item's tile have finished (each waited for
            // its own)
            sm90::named_barrier(1, 256);
            const int nb16 = boxes(p.d, 2);
            for (int i = threadIdx.x; i < nb16 * kN * 8; i += 256) {
                const int box = i / (kN * 8), rem = i - box * kN * 8;
                const int row = rem / 8, lc = rem % 8;
                const int e0 = box * 64 + lc * 8;                  // first element of the chunk
                const int jq = row / p.hp, hh = row - jq * p.hp;
                uint2 v = make_uint2(0u, 0u);
                if (jq < g.nq && hh < p.h && e0 < p.d)
                    v = __ldg(reinterpret_cast<const uint2*>(
                        p.q + (static_cast<int64_t>(g.row0 + jq) * p.h + hh) * p.d + e0));
                uint4 o;
                o.x = dgt::e4m3x2_to_bf16x2(v.x);
                o.y = dgt::e4m3x2_to_bf16x2(v.x >> 16);
                o.z = dgt::e4m3x2_to_bf16x2(v.y);
                o.w = dgt::e4m3x2_to_bf16x2(v.y >> 16);
                *reinterpret_cast<uint4*>(q16_s + box * kN * 128 + row * 128 +
                                          ((lc ^ (row & 7)) << 4)) = o;
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            sm90::named_barrier(1, 256);
            qb_s = q16_s;
        }
        if constexpr (kNB == 1) {
            #pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float2 w2 = *reinterpret_cast<const float2*>(w_s + 8 * j + q2);
                wr[2 * j] = w2.x;
                wr[2 * j + 1] = w2.y;
            }
        }
        const int c_end = min(p.out_cols, (r + 1) * p.run * kRows);
        for (int c0 = r * p.run * kRows, tt = 0; c0 < c_end; c0 += kRows, ++tt) {
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
            {
                const float* sfs = reinterpret_cast<const float*>(sf_s + s * L.sf_stage) +
                                   ((kv0 + c0) & 3);
                #pragma unroll
                for (int h = 0; h < kHalves; ++h) {
                    sf0[h] = p.has_sf ? sfs[64 * h + r0] : 1.f;
                    sf1[h] = p.has_sf ? sfs[64 * h + r0 + 8] : 1.f;
                }
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
                            // steps a group (a fragment's registers are read
                            // until its wgmma completes; four spilled beside
                            // two n128 halves)
                            constexpr int kGroup = kNB == 1 ? 4 : 2;
                            const uint64_t db = sm90::smem_desc(qb_s + nb * 128 * 128);
                            for (int k0 = 0; k0 < steps; k0 += kGroup) {
                                uint32_t a[kGroup][4];
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
                                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                                #pragma unroll
                                for (int v = 0; v < kGroup; ++v) {
                                    const int k = k0 + v;
                                    const uint64_t ob = ((k >> 2) * kN * 128 + (k & 3) * 32) >> 4;
                                    if (k < steps) wgmma_bf16_rs(acc[u], a[v], db + ob, k);
                                }
                                asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                                wgmma_wait<0>();
                            }
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
               layout(nb, d, q_bytes, kv_bytes, widen, s, qb, qg).total + 1024 > kSmemLimit)
            --s;
        if (s >= 3 || (qb == 1 && s >= 2)) {
            *stages = s;
            *q_bufs = qb;
            return;
        }
    }
    *stages = *q_bufs = 0;
}

// sf [skv] f32 in boxes of rows + 4 (a stage's scales from the 16-byte
// boundary at or before its first row); zero past skv.
inline bool make_map_sf(CUtensorMap* map, const void* sf, uint64_t skv, uint32_t rows) {
    const sm90::EncodeTiled encode = sm90::encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[1] = {skv};
    const cuuint64_t strides[1] = {skv * 4};     // not read at rank 1
    const cuuint32_t box[1] = {rows + 4};
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
template <Elem kQ, Elem kK, int kHp>
static inline cudaError_t launch(const CUtensorMap& map_q, const CUtensorMap& map_kv,
                                 const CUtensorMap& map_sf, const Args& p, int num_sms,
                                 cudaStream_t stream) {
    constexpr bool kWiden = kQ == Elem::kE4m3 && kK == Elem::kBf16;
    const int smem = layout(kHp > 128 ? 2 : 1, p.d, elem_bytes<kQ>(), elem_bytes<kK>(), kWiden,
                            p.num_stages, p.q_bufs, p.qg).total + 1024;
    if (p.hp != kHp) return cudaErrorInvalidValue;
    auto kernel = mqa_logits_sm90<kQ, kK, kHp>;
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

template <Elem kQ, Elem kK>
inline cudaError_t launch_hp(const CUtensorMap& map_q, const CUtensorMap& map_kv,
                             const CUtensorMap& map_sf, const Args& p, int num_sms,
                             cudaStream_t stream) {
    switch (p.hp) {
        case 8: return launch<kQ, kK, 8>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 16: return launch<kQ, kK, 16>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 32: return launch<kQ, kK, 32>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 64: return launch<kQ, kK, 64>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 128: return launch<kQ, kK, 128>(map_q, map_kv, map_sf, p, num_sms, stream);
        case 256: return launch<kQ, kK, 256>(map_q, map_kv, map_sf, p, num_sms, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace dgt_mqa90
