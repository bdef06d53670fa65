// HyperConnection prenorm GEMM in TF32, with the per-row square sum:
//   d[s, m, n]   = sum over k in chunk s of a[m, k] * b[n, k]
//   sqr[s, m]    = sum over k in chunk s of a[m, k]^2
// a bf16 [m, k], b f32 [n, k], d and sqr f32; chunk s is the k range
// [s * chunk, min((s + 1) * chunk, k)) (one chunk: the whole depth).
//
// Replaces deepgemm_tpu/kernels/hc_prenorm.py:_build_hc_prenorm
// (pl.pallas_call at hc_prenorm.py:89), and the split form of
// deepgemm_tpu/ops/hyperconnection.py:34-47, which JAX leaves to XLA: the
// grid's z dimension is the split, so one launch writes every partial.
//
// Bound on the H100: at the mHC shape (m = 4096, k = 4 x 7168, n = 24) the
// kernel must read 234.9 MB of a, 2.75 MB of b and write 0.39 MB of d: ~0.071
// ms at 3.35 TB/s; its 5.6 GFLOP take ~0.011 ms at TF32's 495 TFLOP/s. So a's
// bytes bound it, and a is read from device memory once: the square sum is
// taken from the same shared-memory stage as the product.
//
// Design (simple and right first):
//   * A block owns a kBM x kBN tile of d for one split: kBM rows of a stream
//     through a kStages cp.async ring of kBK-deep stages beside the matching
//     kBN rows of b (b is small and stays in L2 across the m-tiles).
//   * mma.sync m16n8k8 TF32 (the reference's sm90_tf32_hc_prenorm_gemm takes
//     TF32 too): a bf16 value is exact in TF32 (its 8 mantissa bits shifted
//     up), b rounds to nearest. Each of the 8 warps takes its own 16-deep
//     slice of every stage for the whole tile; at the end the 8 partial
//     tiles are summed in shared memory in warp order (no atomics).
//   * The block of n-tile 0 also sums a^2 from the same stage, f32, 8 threads
//     a row, combined by shuffles in a fixed order.
//   * Stages start on a 16-byte boundary of a's row at or before the chunk's
//     first k; the few elements before it are zeroed in the first stage, and
//     cp.async zero-fills every element at or past the chunk's end.

#include "gemm_mainloop.cuh"

namespace {

constexpr int kBM = 32;                      // rows of a (and d) per block
constexpr int kBN = 32;                      // rows of b (columns of d) per block
constexpr int kBK = 128;                     // k per stage
constexpr int kStages = 4;
constexpr int kThreads = 256;                // 8 warps, each a 16-deep slice of a stage
constexpr int kAPitch = kBK * 2 + 16;        // bytes a row of a takes in a stage
constexpr int kBPitch = kBK * 4 + 16;        // bytes a row of b takes in a stage
constexpr int kStageBytes = kBM * kAPitch + kBN * kBPitch;
constexpr int kSmem = kStages * kStageBytes;
constexpr int kRedPitch = kBN + 4;           // floats a row of a warp's partial tile
static_assert(8 * kBM * kRedPitch * 4 <= kSmem, "the partial tiles fit in the ring");

struct HcArgs {
    const uint8_t* a;    // bf16 [m, k]
    const uint8_t* b;    // f32 [n, k]
    float* d;            // [splits, m, n]
    float* sqr;          // [splits, m]
    int m, n, k, chunk;
};

// 16 bytes from global to shared memory, of which the first `bytes` are
// copied and the rest zero-filled.
__device__ __forceinline__ void cp_async_partial(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ uint32_t bf16_bits_to_tf32(uint16_t h) {
    return static_cast<uint32_t>(h) << 16;      // exact: the f32 of the bf16
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
hc_prenorm_kernel(const HcArgs p) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int n0 = blockIdx.x * kBN;
    const int m0 = blockIdx.y * kBM;
    const int split = blockIdx.z;
    const bool with_sqr = blockIdx.x == 0;
    const int k_begin = min(split * p.chunk, p.k);
    const int k_end = min(k_begin + p.chunk, p.k);
    const int k_lo = k_begin & ~7;               // 16-byte boundary of a's row
    const int num_kt = k_end > k_begin ? (k_end - k_lo + kBK - 1) / kBK : 0;

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tg = lane & 3;

    // a stage: kBM rows of a (16 chunks of 8 bf16), then kBN rows of b (32
    // chunks of 4 f32); chunks past the row count or the chunk's end are zero
    auto load_stage = [&](int slot, int kt) {
        uint8_t* s = smem + slot * kStageBytes;
        const int kb0 = k_lo + kt * kBK;
        for (int c = tid; c < kBM * 16 + kBN * 32; c += kThreads) {
            const bool is_a = c < kBM * 16;
            const int cc = is_a ? c : c - kBM * 16;
            const int r = is_a ? cc >> 4 : cc >> 5;
            const int ch = is_a ? cc & 15 : cc & 31;
            const int per = is_a ? 8 : 4;                // elements a chunk
            const int kk = kb0 + ch * per;
            const int row = (is_a ? m0 : n0) + r;
            const int elems = row < (is_a ? p.m : p.n) ? max(0, min(per, k_end - kk)) : 0;
            const int esize = is_a ? 2 : 4;
            const uint8_t* base = is_a ? p.a : p.b;
            const uint8_t* src = elems > 0
                ? base + (static_cast<int64_t>(row) * p.k + kk) * esize : base;
            uint8_t* dst = is_a ? s + r * kAPitch + ch * 16
                                : s + kBM * kAPitch + r * kBPitch + ch * 16;
            cp_async_partial(dgt::smem_addr(dst), src, elems * esize);
        }
    };

    float acc[2][4][4];
    #pragma unroll
    for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
            #pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    float sq = 0.f;
    const int sq_row = tid >> 3, sq_part = tid & 7;   // 8 threads a row of a

    #pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < num_kt) load_stage(s, s);
        dgt::cp_async_commit();
    }

    for (int kt = 0; kt < num_kt; ++kt) {
        dgt::cp_async_wait<kStages - 2>();
        __syncthreads();   // stage kt landed; every warp is done with kt - 1
        {
            const int nk = kt + kStages - 1;
            if (nk < num_kt) load_stage(nk % kStages, nk);
            dgt::cp_async_commit();
        }
        uint8_t* sa = smem + (kt % kStages) * kStageBytes;
        uint8_t* sb = sa + kBM * kAPitch;
        if (kt == 0 && k_begin > k_lo) {
            // the elements before the chunk's first k belong to another chunk
            for (int c = tid; c < (kBM + kBN) * 8; c += kThreads) {
                const int r = c >> 3, e = c & 7;
                if (e >= k_begin - k_lo) continue;
                if (r < kBM) reinterpret_cast<uint16_t*>(sa + r * kAPitch)[e] = 0;
                else reinterpret_cast<float*>(sb + (r - kBM) * kBPitch)[e] = 0.f;
            }
            __syncthreads();
        }

        #pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            const int kc = warp * 16 + ks * 8;
            uint32_t af[2][4], bfr[4][2];
            #pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint16_t* r0 = reinterpret_cast<const uint16_t*>(sa + (i * 16 + gr) * kAPitch);
                const uint16_t* r8 = reinterpret_cast<const uint16_t*>(sa + (i * 16 + gr + 8) * kAPitch);
                af[i][0] = bf16_bits_to_tf32(r0[kc + tg]);
                af[i][1] = bf16_bits_to_tf32(r8[kc + tg]);
                af[i][2] = bf16_bits_to_tf32(r0[kc + tg + 4]);
                af[i][3] = bf16_bits_to_tf32(r8[kc + tg + 4]);
            }
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float* rb = reinterpret_cast<const float*>(sb + (j * 8 + gr) * kBPitch);
                bfr[j][0] = to_tf32(rb[kc + tg]);
                bfr[j][1] = to_tf32(rb[kc + tg + 4]);
            }
            #pragma unroll
            for (int i = 0; i < 2; ++i)
                #pragma unroll
                for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], af[i], bfr[j]);
        }

        if (with_sqr) {
            // this thread's two 8-element chunks of its row: 16B loads, a
            // quarter warp on 128 contiguous bytes
            const uint8_t* row = sa + sq_row * kAPitch;
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint4 v = *reinterpret_cast<const uint4*>(row + (h * 8 + sq_part) * 16);
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
                #pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float lo = __uint_as_float(w[q] << 16);
                    const float hi = __uint_as_float(w[q] & 0xffff0000u);
                    sq = __fmaf_rn(lo, lo, sq);
                    sq = __fmaf_rn(hi, hi, sq);
                }
            }
        }
    }
    dgt::cp_async_wait<0>();
    __syncthreads();       // every warp is done with the ring: reuse it

    // each warp's partial tile into shared memory, then summed in warp order
    float* red = reinterpret_cast<float*>(smem);
    #pragma unroll
    for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int h = 0; h < 2; ++h)
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = i * 16 + gr + h * 8;
                const int c = j * 8 + tg * 2;
                *reinterpret_cast<float2*>(red + (warp * kBM + r) * kRedPitch + c) =
                    make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            }
    __syncthreads();

    float* d = p.d + static_cast<int64_t>(split) * p.m * p.n;
    for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
        const int r = idx / kBN, c = idx % kBN;
        float sum = 0.f;
        #pragma unroll
        for (int w = 0; w < 8; ++w) sum = __fadd_rn(sum, red[(w * kBM + r) * kRedPitch + c]);
        if (m0 + r < p.m && n0 + c < p.n)
            d[static_cast<int64_t>(m0 + r) * p.n + n0 + c] = sum;
    }

    if (with_sqr) {
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        sq += __shfl_xor_sync(0xffffffffu, sq, 4);
        if (sq_part == 0 && m0 + sq_row < p.m)
            p.sqr[static_cast<int64_t>(split) * p.m + m0 + sq_row] = sq;
    }
}

}  // namespace

// a bf16 [m, k] (k % 8 == 0), b f32 [n, k], d f32 [splits, m, n], sqr f32
// [splits, m]; split s covers k in [s * chunk, min((s + 1) * chunk, k)).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_hc_prenorm_gemm(const void* a, const void* b, void* d, void* sqr, int m,
                                   int n, int k, int splits, int chunk, void* stream) {
    HcArgs p;
    p.a = static_cast<const uint8_t*>(a);
    p.b = static_cast<const uint8_t*>(b);
    p.d = static_cast<float*>(d);
    p.sqr = static_cast<float*>(sqr);
    p.m = m;
    p.n = n;
    p.k = k;
    p.chunk = chunk;
    cudaError_t err = cudaFuncSetAttribute(
        hc_prenorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
    hc_prenorm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
