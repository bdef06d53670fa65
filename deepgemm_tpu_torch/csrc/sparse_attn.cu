// Attention over the top-k rows that the indexer selected, per row r and head:
//   out[r, h] = sum_t p[t] * v_sel[r, t, h, :],
//   p = softmax over the valid t of scale * q[r, h, :] . k_sel[r, t, h, :]
// in f32, a row with no valid t giving 0. Replaces deepgemm_tpu/kernels/
// sparse_attn.py:_build (pl.pallas_call at sparse_attn.py:104).
//
// Masking is by select: an invalid t is skipped, never added as -inf, so a
// NaN or Inf in an unselected cache row cannot reach the output.
//
// Design: each head of a row has its own K/V and one query vector, so the
// work is a matvec streamed from HBM. One warp owns one (row, head); lane l
// holds the d/32 elements [l * d/32, (l + 1) * d/32) of q, of each k and v row
// and of the f32 accumulator. A block is 8 warps: 8 consecutive heads of one
// row (blockIdx.x is the row, blockIdx.y the group of heads), whose k (and
// v) rows for one t are 8 * d * 2 contiguous bytes. The warp walks t in
// chunks of kChunk: it loads the chunk's k and v rows (all in flight
// together, kept as packed bf16 until used to spare registers), reduces each
// score across the warp with xor shuffles, and folds the chunk into an
// online softmax (one rescale a chunk). No atomics; a (row, head) is the
// same sequence of operations whatever the other rows are.
//
// Bound on the H100: every selected k and v element is read once, 4 * topk
// * h * d bytes a row against ~4 operations a bf16 element: bytes bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 8;

template <int kVec>
struct BfVec;
template <> struct BfVec<2> { using T = uint32_t; };
template <> struct BfVec<4> { using T = uint2; };
template <> struct BfVec<8> { using T = uint4; };

template <int kVec>
__device__ __forceinline__ typename BfVec<kVec>::T load_raw(const __nv_bfloat16* src) {
    return __ldg(reinterpret_cast<const typename BfVec<kVec>::T*>(src));
}

template <int kVec>
__device__ __forceinline__ void unpack(const typename BfVec<kVec>::T& raw, float (&dst)[kVec]) {
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
    #pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
        const float2 f = __bfloat1622float2(pairs[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
    }
}

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
sparse_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                   __nv_bfloat16* __restrict__ out, int topk, int h, float scale) {
    constexpr int kD = 32 * kVec;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int head = blockIdx.y * kWarps + warp;
    const int64_t row = blockIdx.x;
    if (head >= h) return;

    float qf[kVec];
    unpack<kVec>(load_raw<kVec>(q + (row * h + head) * kD + lane * kVec), qf);
    const int64_t t_stride = static_cast<int64_t>(h) * kD;
    const __nv_bfloat16* k_row = k + row * topk * t_stride + head * kD + lane * kVec;
    const __nv_bfloat16* v_row = v + row * topk * t_stride + head * kD + lane * kVec;
    const uint8_t* ok_row = valid + row * topk;

    float m = -INFINITY, den = 0.f, acc[kVec];
    #pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

    for (int t0 = 0; t0 < topk; t0 += kChunk) {
        // the chunk's rows stay packed bf16 in registers until used
        typename BfVec<kVec>::T kraw[kChunk], vraw[kChunk];
        float s[kChunk];
        bool ok[kChunk];
        #pragma unroll
        for (int c = 0; c < kChunk; ++c) {
            const int t = t0 + c;
            ok[c] = t < topk && ok_row[t] != 0;
            if (ok[c]) {
                kraw[c] = load_raw<kVec>(k_row + t * t_stride);
                vraw[c] = load_raw<kVec>(v_row + t * t_stride);
            }
        }
        float chunk_max = -INFINITY;
        #pragma unroll
        for (int c = 0; c < kChunk; ++c) {
            float part = 0.f;
            if (ok[c]) {
                float kf[kVec];
                unpack<kVec>(kraw[c], kf);
                #pragma unroll
                for (int i = 0; i < kVec; ++i) part = __fmaf_rn(qf[i], kf[i], part);
            }
            #pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
            s[c] = __fmul_rn(part, scale);
            if (ok[c]) chunk_max = fmaxf(chunk_max, s[c]);
        }
        if (chunk_max == -INFINITY) continue;   // no valid t in the chunk
        const float m_new = fmaxf(m, chunk_max);
        const float alpha = expf(m - m_new);   // 0 while nothing was valid
        den = __fmul_rn(den, alpha);
        #pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = __fmul_rn(acc[i], alpha);
        #pragma unroll
        for (int c = 0; c < kChunk; ++c) {
            if (!ok[c]) continue;
            const float pc = expf(s[c] - m_new);
            den = __fadd_rn(den, pc);
            float vf[kVec];
            unpack<kVec>(vraw[c], vf);
            #pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] = __fmaf_rn(pc, vf[i], acc[i]);
        }
        m = m_new;
    }

    __nv_bfloat16* dst = out + (row * h + head) * kD + lane * kVec;
    const float inv = den > 0.f ? 1.f / den : 0.f;
    #pragma unroll
    for (int i = 0; i < kVec; i += 2) {
        const float x = den > 0.f ? __fmul_rn(acc[i], inv) : 0.f;
        const float y = den > 0.f ? __fmul_rn(acc[i + 1], inv) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(x, y);
    }
}

template <int kVec>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                   int rows, int topk, int h, float scale, cudaStream_t stream) {
    const dim3 grid(rows, (h + kWarps - 1) / kWarps);
    sparse_attn_kernel<kVec><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(valid),
        static_cast<__nv_bfloat16*>(out), topk, h, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [rows, h, d] bf16, k_sel/v_sel [rows, topk, h, d] bf16, valid [rows, topk]
// uint8 (0 or 1), out [rows, h, d] bf16; d is 64, 128 or 256. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int dgt_sparse_attention(const void* q, const void* k_sel, const void* v_sel,
                                    const void* valid, void* out, int rows, int topk, int h,
                                    int d, float scale, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (rows < 1 || topk < 1 || h < 1 || h > 65535 * kWarps) return static_cast<int>(err);
    if (d == 64) err = launch<2>(q, k_sel, v_sel, valid, out, rows, topk, h, scale, s);
    else if (d == 128) err = launch<4>(q, k_sel, v_sel, valid, out, rows, topk, h, scale, s);
    else if (d == 256) err = launch<8>(q, k_sel, v_sel, valid, out, rows, topk, h, scale, s);
    return static_cast<int>(err);
}
