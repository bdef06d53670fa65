// The mma.sync mainloop of the bf16 k-grouped kernel, and the cp.async
// helpers of the HC prenorm kernel (hc_prenorm.cu). Every dense form, the
// FP8 k-grouped kernel, the contiguous and masked grouped kernels, the fused
// dispatch + L1 and the mega MoE block run the Hopper mainloop of
// gemm_sm90.cuh (the mega block its own body on its helpers,
// mega_sm90.cuh); the indexer logits (prefill and paged) run mqa_sm90.cuh.
//
// Replaces the Pallas mainloop of kernels/k_grouped.py (_build_k_grouped)
// of deepgemm_tpu for bf16 operands:
//     d[g] = c[g] + sum over group g's k of a[m, k] * b[n, k]
// (the sum starts from c, as JAX's k-grouped kernel starts it).
//
// Design (simple and right first):
//   * One block computes a kBM x BN output tile of one group (grid z); 8
//     warps in a 2 (m) x 4 (n) layout, each warp a 32 x (BN/4) sub-tile made
//     of mma.sync m16n8k16 bf16 tiles with f32 accumulation.
//   * A stage holds 64 bf16 elements of k for every row of A and B. kStages
//     stages are kept in flight with cp.async (zero-filled past the row
//     count and past the group's depth), k-major rows padded by 16 bytes so
//     the fragment loads hit 32 distinct banks.
//   * Group g's depth is k_size[g] columns of A and B from column
//     k_start[g] (16-element aligned), read on the device only (no call
//     syncs the host, every launch is graph safe); an empty group writes c
//     (or zero).
//   * Output bf16 or f32 (OutT).
//
// What bounds it on the H100: the k-grouped wgrad writes a [G, m, n] output
// at 256 operations per written element (bytes bound). mma.sync reaches a
// fraction of the wgmma peak.

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

// Shared memory of an instance: kStages stages of A and B, padded k-major
// rows of 64 bf16 elements.
template <int BN>
struct SmemPlan {
    static constexpr int kA = kBM * kPitch;
    static constexpr int kB = BN * kPitch;
    static constexpr int kStage = kA + kB;
    static constexpr int kBytes = kStages * kStage;
};

template <int BN>
constexpr int smem_bytes() {
    return SmemPlan<BN>::kBytes;
}

struct GemmArgs {
    const uint8_t* a;        // A: k-major [M, ldk]
    const uint8_t* b;        // B: k-major [N, ldk]
    const float* c;          // f32 [G, M, N], the sum's start; or nullptr
    void* d;                 // OutT; [G, M, N]
    int M, N;
    int64_t ldk;             // row stride of A and of B, elements
    const int* k_start;      // [G] first column of the group
    const int* k_size;       // [G] depth of the group
};

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

// The fragment bytes of m16n8k16: per thread (group g = lane/4, t =
// lane%4) A regs are rows {g, g+8} x byte offsets {4t, 16+4t} of a 32-byte
// k slice, B regs are row n=g at byte offsets {4t, 16+4t}.
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

template <class OutT>
__device__ __forceinline__ void store_pair(OutT* dst, float x, float y) {
    if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(x, y);
    } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
    }
}

// One block's output tile: column tile bx, row tile by, group bz.
template <int BN, class OutT>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p, const int bx, const int by,
                                          const int bz) {
    static_assert(BN % 32 == 0, "each warp owns BN/4 columns in n8 tiles");
    using Plan = SmemPlan<BN>;
    constexpr int kWN = BN / 4;          // warp tile width
    constexpr int kNT = kWN / 8;         // n8 tiles per warp
    constexpr int kE = 2, kKE = 64;      // bytes a bf16 element, k elements a stage
    extern __shared__ __align__(16) uint8_t smem[];

    const int m0 = by * kBM;
    const int n0 = bx * BN;

    // The block's group: its columns of A and B, its depth and its output.
    const int g = bz;
    const int64_t k0 = p.k_start[g];
    const int depth = p.k_size[g];
    const uint8_t* a = p.a + k0 * kE;
    const uint8_t* b = p.b + k0 * kE;
    const int64_t d_off = static_cast<int64_t>(g) * p.M * p.N;   // elements of d (and c) before it

    // Row strides (bytes) and the bytes of k each row holds.
    const int64_t lda = p.ldk * kE;
    const int64_t ka_bytes = static_cast<int64_t>(depth) * kE;
    const int num_kt = static_cast<int>((ka_bytes + kKE * kE - 1) / (kKE * kE));

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
    // C fragment: v = 0,1 -> row gr, cols 2tg, 2tg+1; v = 2,3 -> row gr + 8.
    #pragma unroll
    for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int j = 0; j < kNT; ++j)
            #pragma unroll
            for (int v = 0; v < 4; ++v) {
                float init = 0.f;
                if (p.c != nullptr) {
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

        #pragma unroll
        for (int kk = 0; kk < kKE; kk += 16) {
            uint32_t af[2][4], bfr[kNT][2];
            #pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint8_t* ra = sa + (wm + i * 16 + gr) * kPitch;
                af[i][0] = ld_shared_u32(ra + 2 * (kk + 2 * tg));
                af[i][1] = ld_shared_u32(ra + 8 * kPitch + 2 * (kk + 2 * tg));
                af[i][2] = ld_shared_u32(ra + 2 * (kk + 8 + 2 * tg));
                af[i][3] = ld_shared_u32(ra + 8 * kPitch + 2 * (kk + 8 + 2 * tg));
            }
            #pragma unroll
            for (int j = 0; j < kNT; ++j) {
                const uint8_t* rb = sb + (wn + j * 8 + gr) * kPitch;
                bfr[j][0] = ld_shared_u32(rb + 2 * (kk + 2 * tg));
                bfr[j][1] = ld_shared_u32(rb + 2 * (kk + 8 + 2 * tg));
            }
            #pragma unroll
            for (int i = 0; i < 2; ++i)
                #pragma unroll
                for (int j = 0; j < kNT; ++j) MmaBf16::mma(acc[i][j], af[i], bfr[j]);
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

template <int BN, class OutT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const GemmArgs p) {
    gemm_tile<BN, OutT>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int BN, class OutT>
inline cudaError_t launch_gemm(const GemmArgs& p, int grid_z, cudaStream_t stream) {
    auto kernel = gemm_kernel<BN, OutT>;
    constexpr int smem = smem_bytes<BN>();
    static_assert(smem <= 232448, "an H100 block may use 227 KiB of shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM, grid_z);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// block_n is 128 or 64 (the tile chooser's two widths).
template <class OutT>
inline cudaError_t launch_gemm_bn(const GemmArgs& p, int grid_z, int block_n,
                                  cudaStream_t stream) {
    if (block_n == 128) return launch_gemm<128, OutT>(p, grid_z, stream);
    if (block_n == 64) return launch_gemm<64, OutT>(p, grid_z, stream);
    return cudaErrorInvalidValue;
}

}  // namespace dgt

#ifndef DGT_ERROR_STRING_DEFINED
#define DGT_ERROR_STRING_DEFINED
extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
