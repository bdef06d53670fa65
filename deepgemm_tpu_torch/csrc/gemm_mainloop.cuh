// Shared mainloop of the port's mma.sync GEMM kernels: masked grouped, the
// bf16 k-grouped kernel, and the block body of the mega MoE kernels
// (mega_ep.cu). Every dense form, the FP8 k-grouped kernel and the
// contiguous grouped kernels run the Hopper mainloop of gemm_sm90.cuh.
//
// Replaces the Pallas mainloops of kernels/grouped.py (_build_masked) and
// kernels/k_grouped.py (_build_k_grouped) of deepgemm_tpu, including the
// exact f32 promotion step of deepgemm_tpu/kernels/common.py:27-52:
//     acc += (p * sfb[n]) * sfa[m]   for each 128-deep k block p.
//
// d[m, n] = sum_k a[m, k] * b[n, k]   (+ c: the k-grouped kernel starts its
// sum from c, as JAX's k-grouped kernel does)
//
// Design (simple and right first; wgmma/TMA/warp specialisation come later):
//   * One block computes a kBM x BN output tile of one problem; 8 warps in a
//     2 (m) x 4 (n) layout, each warp a 32 x (BN/4) sub-tile made of
//     mma.sync m16n8 tiles with f32 accumulation.
//   * What an instance computes is its Form, fixed at compile time: the
//     operands' element type (e4m3 with the 'promote' scale step, or bf16
//     unscaled), both k-major. e4m3 runs m16n8k32 e4m3, bf16 m16n8k16 bf16.
//   * A stage holds kKE elements of k for every row of A and B: 128 (one
//     scale block) for e4m3, 64 for bf16. kStages stages are kept in flight
//     with cp.async (zero-filled past the row count and past the problem's
//     depth), k-major rows padded by 16 bytes so the fragment loads hit 32
//     distinct banks.
//   * 'promote': each stage's product goes to a fresh f32 partial that is
//     scaled and added to the accumulator in the reference multiply order,
//     with explicit _rn intrinsics so nothing is contracted into an FMA.
//     SFB holds one f32 per gran_n rows of B (128: the
//     128x128 block scales; 1: per channel), m-major as the casts make them
//     (SFA [.., M, ksf], SFB [.., nsf, ksf]).
//   * Which problem a block computes is the Layout's business, read on the
//     device only (no call syncs the host, every launch is graph safe):
//       kBatched    grid z = group; a, b, d advance by a group stride. With
//                   masked_m the block returns at once when its first row is
//                   at or past masked_m[g]; rows past it inside a live tile
//                   are unspecified, as in the masked contract.
//       kKGrouped   (bf16) grid z = group; the group's depth is k_size[g]
//                   columns of A and B from column k_start[g] (16-element
//                   aligned); an empty group writes c (or zero).
//   * Output bf16 or f32 (OutT). What only one layout needs (c, a row
//     stride apart from the depth) is decided at
//     compile time, so the other layouts carry no branch or runtime stride
//     for it.
//
// What bounds it on the H100: the model's grouped GEMMs stream each expert's
// weights once at a few hundred operations per weight byte or fewer (bytes
// bound, 3.35 TB/s); the k-grouped wgrad writes a [G, m, n] output at 256
// operations per written element (bytes bound). mma.sync reaches a fraction
// of the wgmma peak; that is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"

namespace dgt {

constexpr int kBM = 64;                 // output rows per block
constexpr int kKBytes = 128;            // bytes of k per stage per row (one-byte operands)
constexpr int kPitch = kKBytes + 16;    // padded shared-memory row pitch
constexpr int kStages = 4;
constexpr int kThreads = 256;

enum class Layout { kBatched, kKGrouped };
enum class Scale { kNone, kPromote };

template <Layout kLayout>
__host__ __device__ constexpr bool k_grouped() {
    return kLayout == Layout::kKGrouped;
}

// What an instance computes. kEA / kEB: bytes per element of A and B (1:
// e4m3; 2: bf16), one type for both.
template <int kEA_, int kEB_, Scale kScale_>
struct Form {
    static constexpr int kEA = kEA_;
    static constexpr int kEB = kEB_;
    static constexpr Scale kScale = kScale_;
    static constexpr bool kMmaE4m3 = kEA == 1;
    static constexpr int kKE = kEA == 2 ? 64 : 128;                 // k elements per stage
    static constexpr bool kScaleA = kScale != Scale::kNone;
    static constexpr bool kScaleB = kScale != Scale::kNone;
    static constexpr int kPitchA = kKE * kEA + 16;                  // k-major row pitches
    static constexpr int kPitchB = kKE * kEB + 16;
    static_assert((kEA == 1 || kEA == 2) && kEA == kEB, "e4m3 or bf16 operands, one type");
    static_assert((kScale == Scale::kNone) == (kEA == 2),
                  "scales go with e4m3 operands; bf16 is unscaled");
};

using FormE4m3 = Form<1, 1, Scale::kPromote>;   // the promoted e4m3 NT form
using FormBf16 = Form<2, 2, Scale::kNone>;      // the unscaled bf16 NT form

// Shared memory of an instance: kStages stages of A and B, padded k-major
// rows.
template <class F, int BN, Layout kLayout>
struct SmemPlan {
    static constexpr int kA = kBM * F::kPitchA;
    static constexpr int kB = BN * F::kPitchB;
    static constexpr int kStage = kA + kB;
    static constexpr int kBytes = kStages * kStage;
};

template <class F, int BN, Layout kLayout>
constexpr int smem_bytes() {
    return SmemPlan<F, BN, kLayout>::kBytes;
}

struct GemmArgs {
    const uint8_t* a;        // A: k-major [G, M, K] or [M, K] (k-grouped [M, ldk])
    const uint8_t* b;        // B: k-major [G, N, K]
    const float* sfa;        // f32 scales of A, or nullptr (unscaled)
    const float* sfb;        // f32 scales of B, or nullptr
    const float* c;          // f32: k-grouped [G, M, N], the sum's start; or nullptr
    void* d;                 // OutT; [G, M, N]
    int M, N, K;             // K: the depth of every problem (not k-grouped)
    int sfb_shift;           // log2(gran_n): rows of B per scale (128 -> 7, 1 -> 0)
    int64_t ldk;             // kKGrouped: row stride of A and of B, elements
    const int* masked_m;     // kBatched: [G] live rows, or nullptr (all rows live)
    const int* k_start;      // k-grouped: [G] first column of the group
    const int* k_size;       // k-grouped: [G] depth of the group
};

// Offset of the scale of (row r, k block kb) within one problem's scales:
// m-major [rows, ksf].
__device__ __forceinline__ int64_t sf_offset(int r, int kb, int ksf) {
    return static_cast<int64_t>(r) * ksf + kb;
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

__device__ __forceinline__ void st_shared_u32(uint8_t* p, uint32_t v) {
    *reinterpret_cast<uint32_t*>(p) = v;
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

// One block's output tile: column tile bx, row tile by, problem bz (the
// kernel's blockIdx; a persistent kernel passes its own, mega_ep.cu).
template <class F, int BN, Layout kLayout, class OutT>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p, const int bx, const int by,
                                          const int bz) {
    static_assert(BN % 32 == 0, "each warp owns BN/4 columns in n8 tiles");
    using Plan = SmemPlan<F, BN, kLayout>;
    constexpr int kWN = BN / 4;          // warp tile width
    constexpr int kNT = kWN / 8;         // n8 tiles per warp
    constexpr int kEA = F::kEA, kEB = F::kEB, kKE = F::kKE;
    constexpr bool kKG = k_grouped<kLayout>();
    static_assert(!kKG || F::kScale == Scale::kNone,
                  "the FP8 k-grouped kernel runs the Hopper mainloop (gemm_sm90.cuh)");
    constexpr bool kPromote = F::kScale == Scale::kPromote;
    extern __shared__ __align__(16) uint8_t smem[];

    const int m0 = by * kBM;
    const int n0 = bx * BN;

    // The block's problem: operands, depth, scales and output.
    const uint8_t* a = p.a;
    const uint8_t* b = p.b;
    const float* sfa = p.sfa;
    const float* sfb = p.sfb;
    int depth = p.K;
    int64_t d_off = 0;                   // elements of d (and c) before this problem
    int64_t ld_k = p.K;                  // row stride of a k-major operand, elements
    const int ksf = (p.K + 127) / 128;   // m-major scales: k blocks per row
    const int nsf = ((p.N - 1) >> p.sfb_shift) + 1;
    const int kb_row = p.K * kEB;        // bytes of one row of B
    if constexpr (kLayout == Layout::kBatched) {
        const int g = bz;
        if (p.masked_m != nullptr && m0 >= p.masked_m[g]) return;
        a += static_cast<int64_t>(g) * p.M * p.K * kEA;
        b += static_cast<int64_t>(g) * p.N * kb_row;
        if constexpr (F::kScaleA) sfa += static_cast<int64_t>(g) * p.M * ksf;
        if constexpr (F::kScaleB) sfb += static_cast<int64_t>(g) * nsf * ksf;
        d_off = static_cast<int64_t>(g) * p.M * p.N;
    } else {
        const int g = bz;
        const int64_t k0 = p.k_start[g];
        depth = p.k_size[g];
        a += k0 * kEA;
        b += k0 * kEB;
        ld_k = p.ldk;
        d_off = static_cast<int64_t>(g) * p.M * p.N;
    }

    // Row strides (bytes) and the bytes of k each row holds.
    const int64_t lda = ld_k * kEA;
    const int64_t ka_bytes = static_cast<int64_t>(depth) * kEA;
    const int num_kt = static_cast<int>((ka_bytes + kKE * kEA - 1) / (kKE * kEA));

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = (warp / 4) * 32;
    const int wn = (warp % 4) * kWN;
    const int gr = lane >> 2, tg = lane & 3;

    // One stage: A's region, then B's, loaded in one pass over the stage's
    // rows (8 chunks of 16 bytes a row), which ran ~15% faster at 4096^3
    // than a pass per operand.
    auto load_stage = [&](int slot, int kt) {
        uint8_t* s = smem + slot * Plan::kStage;
        const int64_t kb0 = static_cast<int64_t>(kt) * kKBytes;
        #pragma unroll
        for (int c = tid; c < (kBM + BN) * 8; c += kThreads) {
            const int r = c >> 3, ch = c & 7;
            const int64_t kb = kb0 + ch * 16;
            const bool is_a = r < kBM;
            const int grow = is_a ? m0 + r : n0 + (r - kBM);
            const uint8_t* base = is_a ? a : b;
            const bool valid = grow < (is_a ? p.M : p.N) && kb < ka_bytes;
            const uint8_t* src = valid ? base + grow * lda + kb : base;
            cp_async16(smem_addr(s + r * kPitch + ch * 16), src, valid);
        }
    };

    float acc[2][kNT][4];
    float part[2][kNT][4];
    // C fragment: v = 0,1 -> row gr, cols 2tg, 2tg+1; v = 2,3 -> row gr + 8.
    #pragma unroll
    for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int j = 0; j < kNT; ++j)
            #pragma unroll
            for (int v = 0; v < 4; ++v) {
                float init = 0.f;
                if (kKG && p.c != nullptr) {
                    const int row = m0 + wm + i * 16 + gr + (v >> 1) * 8;
                    const int col = n0 + wn + j * 8 + tg * 2 + (v & 1);
                    if (row < p.M && col < p.N)
                        init = __ldg(p.c + d_off + static_cast<int64_t>(row) * p.N + col);
                }
                acc[i][j][v] = init;
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
        uint8_t* const stage = smem + (kt % kStages) * Plan::kStage;
        const uint8_t* sa = stage;
        const uint8_t* sb = stage + Plan::kA;

        if constexpr (kPromote) {
            #pragma unroll
            for (int i = 0; i < 2; ++i)
                #pragma unroll
                for (int j = 0; j < kNT; ++j)
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
        }

        if constexpr (F::kMmaE4m3) {
            #pragma unroll
            for (int kk = 0; kk < kKBytes; kk += 32) {
                uint32_t af[2][4], bfr[kNT][2];
                #pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const uint8_t* pa = sa + (wm + i * 16 + gr) * F::kPitchA + kk + tg * 4;
                    af[i][0] = ld_shared_u32(pa);
                    af[i][1] = ld_shared_u32(pa + 8 * F::kPitchA);
                    af[i][2] = ld_shared_u32(pa + 16);
                    af[i][3] = ld_shared_u32(pa + 8 * F::kPitchA + 16);
                }
                #pragma unroll
                for (int j = 0; j < kNT; ++j) {
                    const uint8_t* pb = sb + (wn + j * 8 + gr) * F::kPitchB + kk + tg * 4;
                    bfr[j][0] = ld_shared_u32(pb);
                    bfr[j][1] = ld_shared_u32(pb + 16);
                }
                #pragma unroll
                for (int i = 0; i < 2; ++i)
                    #pragma unroll
                    for (int j = 0; j < kNT; ++j) {
                        if constexpr (kPromote) MmaE4m3::mma(part[i][j], af[i], bfr[j]);
                        else MmaE4m3::mma(acc[i][j], af[i], bfr[j]);
                    }
            }
        } else {
            // bf16 MMA
            #pragma unroll
            for (int kk = 0; kk < kKE; kk += 16) {
                uint32_t af[2][4], bfr[kNT][2];
                #pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const uint8_t* ra = sa + (wm + i * 16 + gr) * F::kPitchA;
                    af[i][0] = ld_shared_u32(ra + 2 * (kk + 2 * tg));
                    af[i][1] = ld_shared_u32(ra + 8 * F::kPitchA + 2 * (kk + 2 * tg));
                    af[i][2] = ld_shared_u32(ra + 2 * (kk + 8 + 2 * tg));
                    af[i][3] = ld_shared_u32(ra + 8 * F::kPitchA + 2 * (kk + 8 + 2 * tg));
                }
                #pragma unroll
                for (int j = 0; j < kNT; ++j) {
                    const uint8_t* rb = sb + (wn + j * 8 + gr) * F::kPitchB;
                    bfr[j][0] = ld_shared_u32(rb + 2 * (kk + 2 * tg));
                    bfr[j][1] = ld_shared_u32(rb + 2 * (kk + 8 + 2 * tg));
                }
                #pragma unroll
                for (int i = 0; i < 2; ++i)
                    #pragma unroll
                    for (int j = 0; j < kNT; ++j) {
                        if constexpr (kPromote) MmaBf16::mma(part[i][j], af[i], bfr[j]);
                        else MmaBf16::mma(acc[i][j], af[i], bfr[j]);
                    }
            }
        }

        if constexpr (kPromote) {
            // stage kt is scale block kt: acc += (p * sfb[n]) * sfa[m]; a
            // row or column past the edge reads its scale as zero
            float sa_v[2][2], sb_v[kNT][2];
            #pragma unroll
            for (int i = 0; i < 2; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = m0 + wm + i * 16 + gr + h * 8;
                    sa_v[i][h] = F::kScaleA && row < p.M
                        ? __ldg(sfa + sf_offset(row, kt, ksf)) : 0.f;
                }
            #pragma unroll
            for (int j = 0; j < kNT; ++j)
                #pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + wn + j * 8 + tg * 2 + e;
                    sb_v[j][e] = F::kScaleB && col < p.N
                        ? __ldg(sfb + sf_offset(col >> p.sfb_shift, kt, ksf))
                        : 0.f;
                }
            #pragma unroll
            for (int i = 0; i < 2; ++i)
                #pragma unroll
                for (int j = 0; j < kNT; ++j)
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) {
                        float t = part[i][j][v];
                        if constexpr (F::kScaleB) t = __fmul_rn(t, sb_v[j][v & 1]);
                        if constexpr (F::kScaleA) t = __fmul_rn(t, sa_v[i][v >> 1]);
                        acc[i][j][v] = __fadd_rn(acc[i][j][v], t);
                    }
        }
    }
    cp_async_wait<0>();

    OutT* d = static_cast<OutT*>(p.d) + d_off;
    #pragma unroll
    for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm + i * 16 + gr + h * 8;
            if (row >= p.M) continue;
            #pragma unroll
            for (int j = 0; j < kNT; ++j) {
                const int col = n0 + wn + j * 8 + tg * 2;
                if (col >= p.N) continue;   // N is even: col + 1 < N too
                store_pair(d + static_cast<int64_t>(row) * p.N + col, acc[i][j][2 * h],
                           acc[i][j][2 * h + 1]);
            }
        }
}

template <class F, int BN, Layout kLayout, class OutT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const GemmArgs p) {
    gemm_tile<F, BN, kLayout, OutT>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <class F, int BN, Layout kLayout, class OutT>
inline cudaError_t launch_gemm(const GemmArgs& p, int grid_z, cudaStream_t stream) {
    auto kernel = gemm_kernel<F, BN, kLayout, OutT>;
    constexpr int smem = smem_bytes<F, BN, kLayout>();
    static_assert(smem <= 232448, "an H100 block may use 227 KiB of shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM, grid_z);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// block_n is 128 or 64 (the tile chooser's two widths).
template <class F, Layout kLayout, class OutT>
inline cudaError_t launch_gemm_bn(const GemmArgs& p, int grid_z, int block_n,
                                  cudaStream_t stream) {
    if (block_n == 128) return launch_gemm<F, 128, kLayout, OutT>(p, grid_z, stream);
    if (block_n == 64) return launch_gemm<F, 64, kLayout, OutT>(p, grid_z, stream);
    return cudaErrorInvalidValue;
}

// An instance with a bf16 or an f32 output.
template <class F, Layout kLayout>
inline cudaError_t launch_gemm_out(const GemmArgs& p, int grid_z, int block_n, int out_f32,
                                   cudaStream_t stream) {
    return out_f32 ? launch_gemm_bn<F, kLayout, float>(p, grid_z, block_n, stream)
                   : launch_gemm_bn<F, kLayout, __nv_bfloat16>(p, grid_z, block_n, stream);
}

// The arguments of A [.., m, k] and B [.., n, k] with the scales as the
// casts make them: SFA [.., m, ksf], SFB [.., ceil(n / gran_n), ksf].
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

#ifndef DGT_ERROR_STRING_DEFINED
#define DGT_ERROR_STRING_DEFINED
extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
