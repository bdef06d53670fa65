// Shared mainloop of the port's NT GEMM kernels: dense FP8, masked grouped,
// contiguous grouped and k-grouped.
//
// Replaces the Pallas mainloops of deepgemm_tpu/kernels/dense.py
// (_build_dense_gemm), kernels/grouped.py (_build_masked, _build_contiguous)
// and kernels/k_grouped.py (_build_k_grouped), including the exact f32
// promotion step of deepgemm_tpu/kernels/common.py:27-52:
//     acc += (p * sfb[n]) * sfa[m]   for each 128-deep k block p.
//
// d[m, n] = c[m, n] + sum_k a[m, k] * b[n, k]   (a, b k-major; c optional)
//
// Design (simple and right first; wgmma/TMA/warp specialisation come later):
//   * One block computes a kBM x BN output tile of one problem; 8 warps in a
//     2 (m) x 4 (n) layout, each warp a 32 x (BN/4) sub-tile made of
//     mma.sync m16n8 tiles with f32 accumulation (bf16: m16n8k16, fp8 e4m3:
//     m16n8k32, sm_89+).
//   * A stage holds 128 BYTES of k for every row of A and B (64 bf16 or 128
//     fp8 values), so a scaled stage is exactly one 128-deep scale block.
//     kStages stages are kept in flight with cp.async (zero-filled past the
//     row count and past the problem's depth), rows padded by 16 bytes so
//     the fragment loads hit 32 distinct banks.
//   * Scaled (fp8) instantiation: each stage's product goes to a fresh f32
//     partial that is scaled and added to the accumulator in the reference
//     multiply order, with explicit _rn intrinsics so nothing is contracted
//     into an FMA. A stage's scales are read after its MMAs. SFB holds one
//     f32 per gran_n rows of B (128: the 128x128 block scales; 1: per
//     channel). Where the scales lie is fixed by the Layout at compile time:
//     m-major as the casts make them (SFA [.., M, ksf], SFB [.., nsf, ksf])
//     for kBatched and kContiguous, k-first [nsf_total, M|N] for kKGrouped.
//   * Which problem a block computes is the Layout's business, read on the
//     device only (no call syncs the host, every launch is graph safe):
//       kBatched    grid z = group; a, b, d advance by a group stride. With
//                   masked_m the block returns at once when its first row is
//                   at or past masked_m[g]; rows past it inside a live tile
//                   are unspecified, as in the masked contract.
//       kContiguous A and d are the concatenated row blocks of all groups;
//                   the m-tile's group is tile_gid[m-tile] (B's group), and
//                   rows at or past tile_row_end[m-tile] are written as
//                   zero (a tile wholly past it skips the mainloop).
//       kContiguousDual  the same rows in 256-row tiles (the dual-B variant):
//                   the top and the bottom 128 rows of tile t take the
//                   groups tile_gid[2t] and tile_gid[2t + 1]. A stage holds
//                   a second B slab for a tile whose halves differ (loaded
//                   only then), and the tile runs as four 64-row passes over
//                   each stage, each pass exactly kContiguous's 64-row tile
//                   (the same fragments, the same k order, the same
//                   promotion per row), so its bits are kContiguous's.
//       kKGrouped   grid z = group; the group's depth is k_size[g] columns
//                   of A and B from column k_start[g] (16-element aligned),
//                   its scales start at scale block sf_start[g]; an empty
//                   group writes c (or zero).
//   * Output bf16 or f32 (OutT). With c (k-grouped), the accumulator starts
//     from c, as the JAX kernel starts its. What only one layout needs (c,
//     the zero rows, k-first scales, a row stride apart from the depth) is
//     decided at compile time, so the other layouts carry no branch or
//     runtime stride for it.
//
// What bounds it on the H100: the model's grouped GEMMs stream each expert's
// weights once at a few hundred operations per weight byte or fewer (bytes
// bound, 3.35 TB/s); the k-grouped wgrad writes a [G, m, n] output at 256
// operations per written element (bytes bound); a dense 4096^3 product is
// tensor-core bound. mma.sync reaches a fraction of the wgmma peak; that is
// later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dgt {

constexpr int kBM = 64;                 // output rows per block
constexpr int kKBytes = 128;            // bytes of k per stage per row
constexpr int kPitch = kKBytes + 16;    // padded shared-memory row pitch
constexpr int kStages = 4;
constexpr int kThreads = 256;

enum class Layout { kBatched, kContiguous, kKGrouped, kContiguousDual };

// Rows of A a block computes, and the B slabs a stage holds.
template <Layout kLayout>
__host__ __device__ constexpr int block_rows() {
    return kLayout == Layout::kContiguousDual ? 4 * kBM : kBM;
}
template <Layout kLayout>
__host__ __device__ constexpr int b_slabs() {
    return kLayout == Layout::kContiguousDual ? 2 : 1;
}

template <int BN, Layout kLayout>
constexpr int smem_bytes() {
    return kStages * (block_rows<kLayout>() + b_slabs<kLayout>() * BN) * kPitch;
}

struct GemmArgs {
    const uint8_t* a;        // bf16 or e4m3, k-major: [G, M, K] or [M, K]; kKGrouped [M, ldk]
    const uint8_t* b;        // same type as a, k-major: [G, N, K]; kKGrouped [N, ldk]
    const float* sfa;        // f32 scales of A, or nullptr (unscaled)
    const float* sfb;        // f32 scales of B, or nullptr
    const float* c;          // kKGrouped: f32 [G, M, N] accumulator input, or nullptr
    void* d;                 // OutT; [G, M, N] (kBatched, kKGrouped) or [M, N]
    int M, N, K;             // K: the depth of every problem (not kKGrouped)
    int sfb_shift;           // log2(gran_n): rows of B per scale (128 -> 7, 1 -> 0)
    int64_t ldk;             // kKGrouped: row stride of A and of B, elements
    const int* masked_m;     // kBatched: [G] live rows, or nullptr (all rows live)
    const int* tile_gid;     // kContiguous: [ceil(M / kBM)] group of each m-tile;
                             // kContiguousDual: [M / 128] group of each half tile
    const int* tile_row_end; // kContiguous: [ceil(M / kBM)] rows at or past it are zero, or nullptr
    const int* k_start;      // kKGrouped: [G] first column of the group in A and B
    const int* k_size;       // kKGrouped: [G] depth of the group
    const int* sf_start;     // kKGrouped: [G] first scale block of the group
};

// Offset of the scale of (row r, k block kb) within one problem's scales:
// m-major [rows, ksf], or k-first [nsf_total, rows] for kKGrouped.
template <Layout kLayout>
__device__ __forceinline__ int64_t sf_offset(int r, int kb, int ksf, int rows) {
    if constexpr (kLayout == Layout::kKGrouped) return static_cast<int64_t>(kb) * rows + r;
    else return static_cast<int64_t>(r) * ksf + kb;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    const int src_size = valid ? 16 : 0;   // 0 -> the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld_shared_u32(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Both instructions take the same fragment bytes: per thread (group g = lane/4,
// t = lane%4) A regs are rows {g, g+8} x byte offsets {4t, 16+4t} of a
// 32-byte k slice, B regs are row n=g at byte offsets {4t, 16+4t}.
struct MmaBf16 {     // m16n8k16, bf16 in, f32 accumulate
    static constexpr int kElemBytes = 2;
    __device__ __forceinline__ static void mma(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
};

struct MmaE4m3 {     // m16n8k32, e4m3 in, f32 accumulate
    static constexpr int kElemBytes = 1;
    __device__ __forceinline__ static void mma(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
};

template <class OutT>
__device__ __forceinline__ void store_pair(OutT* dst, float x, float y) {
    if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(x, y);
    } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
    }
}

template <class Mma, bool kScaled, int BN, Layout kLayout, class OutT>
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(const GemmArgs p) {
    static_assert(!kScaled || Mma::kElemBytes == 1, "scales go with fp8 operands");
    static_assert(BN % 32 == 0, "each warp owns BN/4 columns in n8 tiles");
    constexpr int kWN = BN / 4;          // warp tile width
    constexpr int kNT = kWN / 8;         // n8 tiles per warp
    constexpr int kE = Mma::kElemBytes;
    constexpr bool kDual = kLayout == Layout::kContiguousDual;
    constexpr int kRows = block_rows<kLayout>();
    constexpr int kQ = kRows / kBM;      // 64-row passes over each stage
    constexpr int kStageRows = kRows + b_slabs<kLayout>() * BN;
    extern __shared__ __align__(16) uint8_t smem[];

    const int m0 = blockIdx.y * kRows;
    const int n0 = blockIdx.x * BN;

    // The block's problem: operands, depth, scales and output. b_bot and
    // sfb_bot: the bottom half's B and SFB (kContiguousDual), else b and sfb.
    const uint8_t* a = p.a;
    const uint8_t* b = p.b;
    const float* sfa = p.sfa;
    const float* sfb = p.sfb;
    const uint8_t* b_bot = p.b;
    const float* sfb_bot = p.sfb;
    bool straddle = false;               // the halves' groups differ
    int depth = p.K;
    int row_end = p.M;
    int64_t d_off = 0;                   // elements of d (and c) before this problem
    const int ksf = (p.K + 127) / 128;   // m-major scales: k blocks per row
    const int nsf = ((p.N - 1) >> p.sfb_shift) + 1;
    if constexpr (kLayout == Layout::kBatched) {
        const int g = blockIdx.z;
        if (p.masked_m != nullptr && m0 >= p.masked_m[g]) return;
        a += static_cast<int64_t>(g) * p.M * p.K * kE;
        b += static_cast<int64_t>(g) * p.N * p.K * kE;
        if constexpr (kScaled) {
            sfa += static_cast<int64_t>(g) * p.M * ksf;
            sfb += static_cast<int64_t>(g) * nsf * ksf;
        }
        d_off = static_cast<int64_t>(g) * p.M * p.N;
    } else if constexpr (kLayout == Layout::kContiguous) {
        const int gid = p.tile_gid[blockIdx.y];
        b += static_cast<int64_t>(gid) * p.N * p.K * kE;
        if constexpr (kScaled) sfb += static_cast<int64_t>(gid) * nsf * ksf;
        if (p.tile_row_end != nullptr) row_end = min(row_end, p.tile_row_end[blockIdx.y]);
        if (m0 >= row_end) depth = 0;    // the whole tile is written as zero
    } else if constexpr (kDual) {
        const int top = p.tile_gid[2 * blockIdx.y];
        const int bot = p.tile_gid[2 * blockIdx.y + 1];
        straddle = top != bot;
        b += static_cast<int64_t>(top) * p.N * p.K * kE;
        b_bot += static_cast<int64_t>(bot) * p.N * p.K * kE;
        if constexpr (kScaled) {
            sfb += static_cast<int64_t>(top) * nsf * ksf;
            sfb_bot += static_cast<int64_t>(bot) * nsf * ksf;
        }
    } else {
        const int g = blockIdx.z;
        const int64_t k0 = p.k_start[g];
        depth = p.k_size[g];
        a += k0 * kE;
        b += k0 * kE;
        if constexpr (kScaled) {
            sfa += static_cast<int64_t>(p.sf_start[g]) * p.M;
            sfb += static_cast<int64_t>(p.sf_start[g]) * p.N;
        }
        d_off = static_cast<int64_t>(g) * p.M * p.N;
    }

    const int64_t ld_bytes = (kLayout == Layout::kKGrouped ? p.ldk : p.K) * kE;
    const int64_t k_bytes = static_cast<int64_t>(depth) * kE;
    const int num_kt = static_cast<int>((k_bytes + kKBytes - 1) / kKBytes);

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = (warp / 4) * 32;
    const int wn = (warp % 4) * kWN;
    const int gr = lane >> 2, tg = lane & 3;

    // One stage: rows [0, kRows) are A's tile rows, [kRows, kRows + BN) B's,
    // and on a straddling dual tile [kRows + BN, kRows + 2 BN) the bottom
    // half's B; each row is 8 chunks of 16 bytes.
    const int stage_rows = kRows + (straddle ? 2 : 1) * BN;
    auto load_stage = [&](int slot, int kt) {
        uint8_t* s = smem + slot * kStageRows * kPitch;
        const int64_t kb0 = static_cast<int64_t>(kt) * kKBytes;
        #pragma unroll
        for (int c = tid; c < stage_rows * 8; c += kThreads) {
            const int r = c >> 3, ch = c & 7;
            const int64_t kb = kb0 + ch * 16;
            const bool is_a = r < kRows;
            const bool is_bot = r >= kRows + BN;
            const int grow = is_a ? m0 + r : n0 + (r - kRows - (is_bot ? BN : 0));
            const uint8_t* base = is_a ? a : (is_bot ? b_bot : b);
            const bool valid = grow < (is_a ? p.M : p.N) && kb < k_bytes;
            const uint8_t* src = valid ? base + grow * ld_bytes + kb : base;
            cp_async16(smem_addr(s + r * kPitch + ch * 16), src, valid);
        }
    };

    float acc[kQ][2][kNT][4];
    float part[2][kNT][4];
    // C fragment: v = 0,1 -> row gr, cols 2tg, 2tg+1; v = 2,3 -> row gr + 8.
    #pragma unroll
    for (int q = 0; q < kQ; ++q)
        #pragma unroll
        for (int i = 0; i < 2; ++i)
            #pragma unroll
            for (int j = 0; j < kNT; ++j)
                #pragma unroll
                for (int v = 0; v < 4; ++v) {
                    float init = 0.f;
                    if (kLayout == Layout::kKGrouped && p.c != nullptr) {
                        const int row = m0 + wm + i * 16 + gr + (v >> 1) * 8;
                        const int col = n0 + wn + j * 8 + tg * 2 + (v & 1);
                        if (row < p.M && col < p.N)
                            init = __ldg(p.c + d_off + static_cast<int64_t>(row) * p.N + col);
                    }
                    acc[q][i][j][v] = init;
                }

    #pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < num_kt) load_stage(s, s);
        cp_async_commit();
    }

    for (int kt = 0; kt < num_kt; ++kt) {
        cp_async_wait<kStages - 2>();
        __syncthreads();   // stage kt landed; every warp is done with kt - 1
        {
            const int nk = kt + kStages - 1;
            if (nk < num_kt) load_stage(nk % kStages, nk);
            cp_async_commit();
        }
        const uint8_t* stage = smem + (kt % kStages) * kStageRows * kPitch;
        const uint8_t* sb_top = stage + kRows * kPitch;
        const uint8_t* sb_bot = straddle ? sb_top + BN * kPitch : sb_top;

        #pragma unroll
        for (int q = 0; q < kQ; ++q) {
            // pass q: rows [q * kBM, (q + 1) * kBM) of the tile, with the
            // bottom half's B from the third pass on
            const uint8_t* sa = stage + q * kBM * kPitch;
            const bool bottom = kDual && q >= kQ / 2;
            const uint8_t* sb = bottom ? sb_bot : sb_top;
            const int q0 = m0 + q * kBM;

            if constexpr (kScaled) {
                #pragma unroll
                for (int i = 0; i < 2; ++i)
                    #pragma unroll
                    for (int j = 0; j < kNT; ++j)
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
            }

            #pragma unroll
            for (int kk = 0; kk < kKBytes; kk += 32) {
                uint32_t af[2][4], bfr[kNT][2];
                #pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const uint8_t* pa = sa + (wm + i * 16 + gr) * kPitch + kk + tg * 4;
                    af[i][0] = ld_shared_u32(pa);
                    af[i][1] = ld_shared_u32(pa + 8 * kPitch);
                    af[i][2] = ld_shared_u32(pa + 16);
                    af[i][3] = ld_shared_u32(pa + 8 * kPitch + 16);
                }
                #pragma unroll
                for (int j = 0; j < kNT; ++j) {
                    const uint8_t* pb = sb + (wn + j * 8 + gr) * kPitch + kk + tg * 4;
                    bfr[j][0] = ld_shared_u32(pb);
                    bfr[j][1] = ld_shared_u32(pb + 16);
                }
                #pragma unroll
                for (int i = 0; i < 2; ++i)
                    #pragma unroll
                    for (int j = 0; j < kNT; ++j) {
                        if constexpr (kScaled) Mma::mma(part[i][j], af[i], bfr[j]);
                        else Mma::mma(acc[q][i][j], af[i], bfr[j]);
                    }
            }

            if constexpr (kScaled) {
                // stage kt is scale block kt: acc += (p * sfb[n]) * sfa[m]; a
                // row or column past the edge reads its scale as zero
                const float* sfb_q = bottom ? sfb_bot : sfb;
                float sa_v[2][2], sb_v[kNT][2];
                #pragma unroll
                for (int i = 0; i < 2; ++i)
                    #pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = q0 + wm + i * 16 + gr + h * 8;
                        sa_v[i][h] = row < p.M
                            ? __ldg(sfa + sf_offset<kLayout>(row, kt, ksf, p.M)) : 0.f;
                    }
                #pragma unroll
                for (int j = 0; j < kNT; ++j)
                    #pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = n0 + wn + j * 8 + tg * 2 + e;
                        sb_v[j][e] = col < p.N
                            ? __ldg(sfb_q + sf_offset<kLayout>(col >> p.sfb_shift, kt, ksf, p.N))
                            : 0.f;
                    }
                #pragma unroll
                for (int i = 0; i < 2; ++i)
                    #pragma unroll
                    for (int j = 0; j < kNT; ++j)
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const float t = __fmul_rn(__fmul_rn(part[i][j][v], sb_v[j][v & 1]),
                                                      sa_v[i][v >> 1]);
                            acc[q][i][j][v] = __fadd_rn(acc[q][i][j][v], t);
                        }
            }
        }
    }
    cp_async_wait<0>();

    OutT* d = static_cast<OutT*>(p.d) + d_off;
    #pragma unroll
    for (int q = 0; q < kQ; ++q)
        #pragma unroll
        for (int i = 0; i < 2; ++i)
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + q * kBM + wm + i * 16 + gr + h * 8;
                if (row >= p.M) continue;
                const bool zero = kLayout == Layout::kContiguous && row >= row_end;
                #pragma unroll
                for (int j = 0; j < kNT; ++j) {
                    const int col = n0 + wn + j * 8 + tg * 2;
                    if (col >= p.N) continue;   // N is even: col + 1 < N too
                    store_pair(d + static_cast<int64_t>(row) * p.N + col,
                               zero ? 0.f : acc[q][i][j][2 * h],
                               zero ? 0.f : acc[q][i][j][2 * h + 1]);
                }
            }
}

template <class Mma, bool kScaled, int BN, Layout kLayout, class OutT>
inline cudaError_t launch_gemm_nt(const GemmArgs& p, int grid_z, cudaStream_t stream) {
    auto kernel = gemm_nt_kernel<Mma, kScaled, BN, kLayout, OutT>;
    constexpr int smem = smem_bytes<BN, kLayout>();
    constexpr int rows = block_rows<kLayout>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BN - 1) / BN, (p.M + rows - 1) / rows, grid_z);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// block_n is 128 or 64 (the tile chooser's two widths).
template <class Mma, bool kScaled, Layout kLayout, class OutT>
inline cudaError_t launch_gemm_nt_bn(const GemmArgs& p, int grid_z, int block_n,
                                     cudaStream_t stream) {
    if (block_n == 128) return launch_gemm_nt<Mma, kScaled, 128, kLayout, OutT>(p, grid_z, stream);
    if (block_n == 64) return launch_gemm_nt<Mma, kScaled, 64, kLayout, OutT>(p, grid_z, stream);
    return cudaErrorInvalidValue;
}

// The arguments of a k-major A [.., m, k] and B [.., n, k] with the scales as
// the casts make them: SFA [.., m, ksf], SFB [.., ceil(n / gran_n), ksf].
inline GemmArgs nt_args(const void* a, const void* b, const void* sfa, const void* sfb,
                        void* d, int m, int n, int k, int sfb_shift) {
    GemmArgs p = {};
    p.a = static_cast<const uint8_t*>(a);
    p.b = static_cast<const uint8_t*>(b);
    p.sfa = static_cast<const float*>(sfa);
    p.sfb = static_cast<const float*>(sfb);
    p.d = d;
    p.M = m;
    p.N = n;
    p.K = k;
    p.sfb_shift = sfb_shift;
    return p;
}

}  // namespace dgt

extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
