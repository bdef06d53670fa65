// Body of the paged indexer logits kernels (paged_mqa.cu; the prefill
// logits, mqa_logits.cu, run on mqa_sm90.cuh):
//
//   logits[r, c] = sum_h w[r, h] * relu(q[r, h, :] . kv[row(c), :]) * sf[row(c)]
//
// for the output columns c in [lo[r], hi[r]) of each query row r, and the
// fill (-inf, or 0 in the compressed layout) elsewhere.
//
// Replaces the bodies of deepgemm_tpu/kernels/paged_mqa.py:_build_paged_mqa
// and _build_paged_mqa_zerocopy.
//
// Design (simple and right first):
//   * Heads are folded into M, as in the TPU kernels. A block owns one tile of
//     query rows (blockIdx.x) and kTilesPerBlock consecutive kv tiles of kBN
//     output columns (blockIdx.y). The tile's q2 rows [rows * h, d] stay in
//     shared memory for all its kv tiles. Consecutive query tiles may share
//     one kv row (y_per_row > 1): a batch row's next_n tokens split into
//     several tiles when they do not fit one, each reading the same pages.
//   * Per kv tile: cp.async brings the tile's kBN kv rows and their scales,
//     double-buffered (tile i+1 is in flight while tile i computes). The row
//     of output column c comes from the Source: kLinear (a base row plus c:
//     the prefill kv, or the paged cache linearised by the wrapper's gather)
//     or kPaged (through the block table, the pages read in place; the
//     block's table entries are read once, into shared memory, so no load
//     waits on a table lookup). Rows out of range load as zeros.
//   * 8 warps compute S = q2 . kv^T, one m16 x n32 task at a time, and store
//     relu(S) * sf to shared memory. Operands are e4m3 or bf16 (Elem), each
//     kept in shared memory in its own type: e4m3 x e4m3 runs mma.sync
//     m16n8k32 e4m3 -> f32; any bf16 operand runs m16n8k16 bf16 -> f32, an
//     e4m3 operand widened to bf16 as its fragment is loaded (exact). The bf16
//     instances take the FP4 indexer operands, which the op layer decodes
//     into bf16 exactly (e2m1 times a power of two), as JAX does.
//   * One thread per (query row, column) sums w * S over the heads in order
//     h = 0, 1, ..., selects the fill outside [lo, hi) and stores the logit.
//   * A tile outside every row's [lo, hi) writes the fill and loads nothing.
//   * No atomics; a logit is the same sequence of operations whichever block,
//     tile or batch computes it, so a row's result never depends on the other
//     rows (the serving engine's batch invariance rests on this), and the
//     kLinear and kPaged sources give the same bits on the same data.
//
// Bound on the H100: decode (one query row of 64 heads per batch row) reads
// each cache row (d + 4 bytes) once for 2 * 64 * d operations: bytes bound.
// The prefill bench shape (2048 x 8192, 64 heads, d 128) does ~1000 fp8
// operations a byte: tensor-core bound. mma.sync reaches a fraction of the
// wgmma rate, and the head sum runs on CUDA cores; both are later work.

#pragma once

#include <limits.h>

#include "convert.cuh"
#include "gemm_mainloop.cuh"

namespace dgt_mqa {

constexpr int kThreads = 256;
constexpr int kBN = 64;               // output columns per kv tile
constexpr int kMaxRows = 256;         // q2 rows (query rows x heads) per block
constexpr int kMaxDim = 256;          // head_dim: a multiple of 32 up to this
constexpr int kTilesPerBlock = 4;
constexpr int kSPitch = kBN + 4;      // f32 pitch of the score tile in shared memory

enum class Source { kLinear, kPaged };

enum class Elem { kE4m3, kBf16 };

template <Elem kE>
__host__ __device__ constexpr int elem_bytes() { return kE == Elem::kBf16 ? 2 : 1; }

struct MqaArgs {
    const uint8_t* q;        // q2 [num_query_rows * h, d], e4m3 or bf16
    const float* w;          // f32 [num_query_rows, h]
    const uint8_t* kv;       // [kv rows, d], e4m3 or bf16
    const float* sf;         // f32 [kv rows], or nullptr (every scale 1)
    const int* lo;           // [num_query_rows] first valid output column
    const int* hi;           // [num_query_rows] end of the valid output columns
    float* out;              // f32 [num_query_rows, out_cols]
    // Query tile y reads kv row ky = y / y_per_row (1: one tile a kv row).
    // kLinear: column c reads kv row ky * kv_y_stride + base + c,
    // base = kv_base ? kv_base[y] : 0, when base + c < kv_limit.
    const int* kv_base;
    int64_t kv_y_stride;
    int kv_limit;
    int y_per_row;
    // kPaged: column c (ky one batch row) reads kv row
    // block_table[ky * mb + min(c / block_kv, mb - 1)] * block_kv + c % block_kv,
    // when c < mb * block_kv. The wrapper clamps the table to valid pages.
    const int* block_table;
    int mb, block_kv;
    int num_query_rows;      // sq, or batch * next_n
    int rows_per_tile;       // query rows per block
    int h, d;
    int out_cols;
    float fill;
};

__host__ __device__ inline int padded_rows(int rows_per_tile, int h) {
    return (rows_per_tile * h + 15) / 16 * 16;
}

// Block-table entries a kPaged block reads: its columns span at most
// kTilesPerBlock * kBN pages (block_kv >= 1), plus one for a page boundary.
constexpr int kMaxBlockPages = kTilesPerBlock * kBN + 1;

constexpr int kMaxSmem = 232448;      // what one block may use on the H100

// Dynamic shared memory: q2 tile, two kv tiles (rows padded by 16 bytes), the
// score tile, two scale tiles, the weights, lo/hi of the tile's query rows,
// the block's pages. q_bytes / kv_bytes: 1 (e4m3) or 2 (bf16).
__host__ __device__ inline int smem_bytes(int rows_per_tile, int h, int d, int q_bytes,
                                          int kv_bytes) {
    const int rp = padded_rows(rows_per_tile, h);
    return rp * (d * q_bytes + 16) + 2 * kBN * (d * kv_bytes + 16) + rp * kSPitch * 4 +
           2 * kBN * 4 + rows_per_tile * h * 4 + 2 * rows_per_tile * 4 + kMaxBlockPages * 4;
}

using dgt::e4m3x2_to_bf16x2;
using dgt::ld_shared_u16;

// Elements e, e + 1 of a shared-memory row as a bf16x2 fragment register.
template <Elem kE>
__device__ __forceinline__ uint32_t bf16_pair(const uint8_t* row, int e) {
    if constexpr (kE == Elem::kBf16) return dgt::ld_shared_u32(row + 2 * e);
    else return e4m3x2_to_bf16x2(ld_shared_u16(row + e));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    const int src_size = valid ? 4 : 0;    // 0 -> zero-filled
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_size));
}

template <Source kSource, Elem kQ, Elem kK>
__global__ void __launch_bounds__(kThreads) mqa_logits_kernel(const MqaArgs p) {
    constexpr int kQB = elem_bytes<kQ>(), kKB = elem_bytes<kK>();
    extern __shared__ __align__(16) uint8_t smem[];
    const int y = blockIdx.x;
    const int ky = y / p.y_per_row;                     // the kv row of this query tile
    const int qr = p.rows_per_tile;
    const int row0 = y * qr;                            // first query row
    const int nq = min(qr, p.num_query_rows - row0);    // live query rows
    const int live = nq * p.h;                          // live q2 rows
    const int rp = padded_rows(qr, p.h);
    const int q_row = p.d * kQB, kv_row_bytes = p.d * kKB;   // bytes of a row in memory
    const int q_pitch = q_row + 16, kv_pitch = kv_row_bytes + 16;
    const int q_chunks = q_row / 16, kv_chunks = kv_row_bytes / 16;   // 16-byte chunks

    uint8_t* q_s = smem;
    uint8_t* kv_s = q_s + rp * q_pitch;
    float* s_s = reinterpret_cast<float*>(kv_s + 2 * kBN * kv_pitch);
    float* sf_s = s_s + rp * kSPitch;
    float* w_s = sf_s + 2 * kBN;
    int* lo_s = reinterpret_cast<int*>(w_s + qr * p.h);
    int* hi_s = lo_s + qr;
    int* pages_s = hi_s + qr;

    const int num_tiles = (p.out_cols + kBN - 1) / kBN;
    const int t_begin = blockIdx.y * kTilesPerBlock;
    const int t_end = min(num_tiles, t_begin + kTilesPerBlock);
    // kPaged: the logical pages [page_lo, page_hi] of the block's columns
    int page_lo = 0, page_hi = -1;
    if constexpr (kSource == Source::kPaged) {
        page_lo = min(t_begin * kBN / p.block_kv, p.mb - 1);
        page_hi = min((t_end * kBN - 1) / p.block_kv, p.mb - 1);
    }

    const int tid = threadIdx.x;
    const uint8_t* q_g = p.q + static_cast<int64_t>(row0) * p.h * q_row;
    for (int i = tid; i < rp * q_chunks; i += kThreads) {
        const int r = i / q_chunks, ch = i % q_chunks;
        const bool valid = r < live;
        dgt::cp_async16(dgt::smem_addr(q_s + r * q_pitch + ch * 16),
                        valid ? q_g + static_cast<int64_t>(r) * q_row + ch * 16 : q_g, valid);
    }
    dgt::cp_async_commit();
    for (int i = tid; i < qr * p.h; i += kThreads)
        w_s[i] = i < live ? p.w[static_cast<int64_t>(row0) * p.h + i] : 0.f;
    for (int i = tid; i < qr; i += kThreads) {
        lo_s[i] = i < nq ? p.lo[row0 + i] : INT_MAX;
        hi_s[i] = i < nq ? p.hi[row0 + i] : INT_MIN;
    }
    for (int i = tid; i <= page_hi - page_lo; i += kThreads)
        pages_s[i] = p.block_table[static_cast<int64_t>(ky) * p.mb + page_lo + i];
    __syncthreads();
    int win_lo = INT_MAX, win_hi = INT_MIN;     // the union of the rows' windows
    for (int i = 0; i < nq; ++i) {
        win_lo = min(win_lo, lo_s[i]);
        win_hi = max(win_hi, hi_s[i]);
    }
    const int kv_base = (kSource == Source::kLinear && p.kv_base != nullptr) ? p.kv_base[y] : 0;

    auto active = [&](int t) {
        const int c0 = t * kBN;
        return win_lo < win_hi && c0 < win_hi && c0 + kBN > win_lo;
    };
    // The kv row of output column c, or -1 (zeros).
    auto kv_row = [&](int c) -> int64_t {
        if (c >= p.out_cols) return -1;
        if constexpr (kSource == Source::kLinear) {
            if (kv_base + c >= p.kv_limit) return -1;
            return static_cast<int64_t>(ky) * p.kv_y_stride + kv_base + c;
        } else {
            if (c >= p.mb * p.block_kv) return -1;
            const int page = pages_s[min(c / p.block_kv, p.mb - 1) - page_lo];
            return static_cast<int64_t>(page) * p.block_kv + c % p.block_kv;
        }
    };
    auto issue = [&](int t, int buf) {
        uint8_t* dst = kv_s + buf * kBN * kv_pitch;
        const int c0 = t * kBN;
        for (int i = tid; i < kBN * kv_chunks; i += kThreads) {
            const int r = i / kv_chunks, ch = i % kv_chunks;
            const int64_t row = kv_row(c0 + r);
            dgt::cp_async16(dgt::smem_addr(dst + r * kv_pitch + ch * 16),
                            row >= 0 ? p.kv + row * kv_row_bytes + ch * 16 : p.kv, row >= 0);
        }
        if (tid < kBN) {
            const int64_t row = kv_row(c0 + tid);
            float* dst_sf = sf_s + buf * kBN + tid;
            if (p.sf == nullptr) *dst_sf = row >= 0 ? 1.f : 0.f;
            else cp_async4(dgt::smem_addr(dst_sf), row >= 0 ? p.sf + row : p.sf, row >= 0);
        }
    };

    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tg = lane & 3;
    const int num_tasks = (rp / 16) * 2;        // m16 x n32 pieces of the score tile

    if (t_begin < t_end && active(t_begin)) issue(t_begin, 0);
    dgt::cp_async_commit();
    for (int t = t_begin; t < t_end; ++t) {
        const int buf = (t - t_begin) & 1;
        if (t + 1 < t_end && active(t + 1)) issue(t + 1, buf ^ 1);
        dgt::cp_async_commit();
        dgt::cp_async_wait<1>();                // q and tile t have landed
        __syncthreads();
        const int c0 = t * kBN;
        if (!active(t)) {
            for (int i = tid; i < nq * kBN; i += kThreads) {
                const int r = i / kBN, c = c0 + i % kBN;
                if (c < p.out_cols) p.out[static_cast<int64_t>(row0 + r) * p.out_cols + c] = p.fill;
            }
            continue;                           // no shared memory was touched
        }

        // S = relu(q2 . kv^T) * sf over the [rp, kBN] tile
        const uint8_t* kvb = kv_s + buf * kBN * kv_pitch;
        const float* sfb = sf_s + buf * kBN;
        for (int task = warp; task < num_tasks; task += kThreads / 32) {
            const int m0 = (task >> 1) * 16, n0 = (task & 1) * 32;
            if (m0 >= live) continue;
            float acc[4][4];
            #pragma unroll
            for (int j = 0; j < 4; ++j)
                #pragma unroll
                for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
            if constexpr (kQ == Elem::kE4m3 && kK == Elem::kE4m3) {
                for (int kk = 0; kk < p.d; kk += 32) {
                    uint32_t a[4], b[4][2];
                    const uint8_t* pa = q_s + (m0 + gr) * q_pitch + kk + tg * 4;
                    a[0] = dgt::ld_shared_u32(pa);
                    a[1] = dgt::ld_shared_u32(pa + 8 * q_pitch);
                    a[2] = dgt::ld_shared_u32(pa + 16);
                    a[3] = dgt::ld_shared_u32(pa + 8 * q_pitch + 16);
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const uint8_t* pb = kvb + (n0 + j * 8 + gr) * kv_pitch + kk + tg * 4;
                        b[j][0] = dgt::ld_shared_u32(pb);
                        b[j][1] = dgt::ld_shared_u32(pb + 16);
                    }
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) dgt::MmaE4m3::mma(acc[j], a, b[j]);
                }
            } else {
                // m16n8k16 bf16: A regs are rows {g, g+8} x elements {2t, 8+2t}
                // of a 16-deep k slice, B regs row n=g at elements {2t, 8+2t}
                for (int kk = 0; kk < p.d; kk += 16) {
                    uint32_t a[4], b[4][2];
                    const uint8_t* ra = q_s + (m0 + gr) * q_pitch;
                    const int e = kk + tg * 2;
                    a[0] = bf16_pair<kQ>(ra, e);
                    a[1] = bf16_pair<kQ>(ra + 8 * q_pitch, e);
                    a[2] = bf16_pair<kQ>(ra, e + 8);
                    a[3] = bf16_pair<kQ>(ra + 8 * q_pitch, e + 8);
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const uint8_t* rb = kvb + (n0 + j * 8 + gr) * kv_pitch;
                        b[j][0] = bf16_pair<kK>(rb, e);
                        b[j][1] = bf16_pair<kK>(rb, e + 8);
                    }
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) dgt::MmaBf16::mma(acc[j], a, b[j]);
                }
            }
            #pragma unroll
            for (int j = 0; j < 4; ++j)
                #pragma unroll
                for (int v = 0; v < 4; ++v) {
                    const int r = m0 + gr + (v >> 1) * 8;
                    const int c = n0 + j * 8 + tg * 2 + (v & 1);
                    s_s[r * kSPitch + c] = __fmul_rn(fmaxf(acc[j][v], 0.f), sfb[c]);
                }
        }
        __syncthreads();

        // the weighted sum over the heads, the mask, the store
        for (int i = tid; i < nq * kBN; i += kThreads) {
            const int r = i / kBN, cl = i % kBN, c = c0 + cl;
            if (c >= p.out_cols) continue;
            const float* srow = s_s + r * p.h * kSPitch + cl;
            const float* wr = w_s + r * p.h;
            float sum = 0.f;
            for (int hh = 0; hh < p.h; ++hh)
                sum = __fadd_rn(sum, __fmul_rn(wr[hh], srow[hh * kSPitch]));
            const bool valid = c >= lo_s[r] && c < hi_s[r];
            p.out[static_cast<int64_t>(row0 + r) * p.out_cols + c] = valid ? sum : p.fill;
        }
        __syncthreads();                        // S and this buffer are free again
    }
    dgt::cp_async_wait<0>();
}

// grid: (query tiles, kv tile groups)
template <Source kSource, Elem kQ, Elem kK>
inline cudaError_t launch(const MqaArgs& p, cudaStream_t stream) {
    const int smem = smem_bytes(p.rows_per_tile, p.h, p.d, elem_bytes<kQ>(), elem_bytes<kK>());
    if (p.d % 32 != 0 || p.d < 32 || p.d > kMaxDim || p.rows_per_tile < 1 ||
        p.rows_per_tile * p.h > kMaxRows || p.num_query_rows < 1 || p.out_cols < 1 ||
        p.y_per_row < 1 || smem > kMaxSmem)
        return cudaErrorInvalidValue;
    auto kernel = mqa_logits_kernel<kSource, kQ, kK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int num_tiles = (p.out_cols + kBN - 1) / kBN;
    const dim3 grid((p.num_query_rows + p.rows_per_tile - 1) / p.rows_per_tile,
                    (num_tiles + kTilesPerBlock - 1) / kTilesPerBlock);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// The instance for the operands' types: q_bf16 / kv_bf16 nonzero for bf16,
// zero for e4m3.
template <Source kSource>
inline cudaError_t launch_typed(const MqaArgs& p, int q_bf16, int kv_bf16,
                                cudaStream_t stream) {
    if (!q_bf16 && !kv_bf16) return launch<kSource, Elem::kE4m3, Elem::kE4m3>(p, stream);
    if (q_bf16 && kv_bf16) return launch<kSource, Elem::kBf16, Elem::kBf16>(p, stream);
    if (q_bf16) return launch<kSource, Elem::kBf16, Elem::kE4m3>(p, stream);
    return launch<kSource, Elem::kE4m3, Elem::kBf16>(p, stream);
}

}  // namespace dgt_mqa
