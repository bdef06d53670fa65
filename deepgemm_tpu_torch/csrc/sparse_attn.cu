// Attention over the top-k rows that the indexer selected, per row r and head:
//   out[r, h] = sum_t p[t] * V[r, t, h, :],
//   p = softmax over the valid t of scale * q[r, h, :] . K[r, t, h, :]
// in f32, a row with no valid t giving 0. Two entries on one warp body:
//
//   dgt_sparse_attention replaces deepgemm_tpu/kernels/sparse_attn.py:_build
//     (pl.pallas_call at sparse_attn.py:104): K and V are the gathered rows,
//     k_sel/v_sel [rows, topk, h, d].
//   dgt_sparse_attention_paged replaces sparse_attn.py:_build_paged
//     (pl.pallas_call at sparse_attn.py:274): K[r, t] and V[r, t] are rows
//     tok[r, t] of the flat cache views k_rows/v_rows [N, h, d], read in place
//     (tok clipped to [0, N) here), so the selected rows are never copied.
//
// Masking is by select: an invalid t is skipped, never added as -inf, and
// its row is never loaded, so a NaN or Inf in an unselected cache row, or a
// tok entry pointing anywhere, cannot reach the output.
//
// Design: each head of a row has its own K/V and one query vector, so the
// work is a matvec streamed from HBM. One warp owns one (row, head); lane l
// holds the d/32 elements [l * d/32, (l + 1) * d/32) of q, of each k and v row
// and of the f32 accumulator. A block is 8 warps: 8 consecutive heads of one
// row (blockIdx.x is the row, blockIdx.y the group of heads), whose k (and
// v) rows for one t are 8 * d * 2 contiguous bytes, in the gathered layout
// and in the cache alike. The warp walks t in chunks of kChunk: it reads the
// chunk's valid flags (and, in the paged entry, its tok entries) into
// registers, loads the valid k and v rows (all in flight together, kept as
// packed bf16 until used to spare registers), reduces each score across the
// warp with xor shuffles, and folds the chunk into an online softmax (one
// rescale a chunk). The two entries differ only in the address of a row, so
// on the same rows they give the same bits. No atomics; a (row, head) is the
// same sequence of operations whatever the other rows are.
//
// Bound on the H100: every valid selected k and v element is read once,
// 4 * h * d bytes a valid (row, t) against ~4 operations a bf16 element:
// bytes bound. The paged entry moves the same bytes without the gather's
// write and re-read of the selected rows.

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

// kPaged: K and V rows come from the flat cache views through tok, clipped
// to [0, n_rows); otherwise from the gathered [rows, topk, h, d] layout.
template <int kVec, bool kPaged>
__global__ void __launch_bounds__(kWarps * 32)
sparse_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ tok,
                   const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                   int topk, int h, int n_rows, float scale) {
    constexpr int kD = 32 * kVec;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int head = blockIdx.y * kWarps + warp;
    const int64_t row = blockIdx.x;
    if (head >= h) return;

    float qf[kVec];
    unpack<kVec>(load_raw<kVec>(q + (row * h + head) * kD + lane * kVec), qf);
    const int64_t t_stride = static_cast<int64_t>(h) * kD;
    const int64_t lane_off = head * kD + lane * kVec;
    const int* tok_row = kPaged ? tok + row * topk : nullptr;
    const uint8_t* ok_row = valid + row * topk;
    // the offset of the (row, t) k and v rows' first element
    auto row_offset = [&](int t) -> int64_t {
        if constexpr (kPaged) {
            const int n = min(max(__ldg(tok_row + t), 0), n_rows - 1);
            return static_cast<int64_t>(n) * t_stride;
        } else {
            return (row * topk + t) * t_stride;
        }
    };

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
                const int64_t off = row_offset(t) + lane_off;
                kraw[c] = load_raw<kVec>(k + off);
                vraw[c] = load_raw<kVec>(v + off);
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

template <int kVec, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tok,
                   const void* valid, void* out, int rows, int topk, int h, int n_rows,
                   float scale, cudaStream_t stream) {
    const dim3 grid(rows, (h + kWarps - 1) / kWarps);
    sparse_attn_kernel<kVec, kPaged><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tok),
        static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out), topk, h, n_rows,
        scale);
    return cudaGetLastError();
}

template <bool kPaged>
int launch_d(const void* q, const void* k, const void* v, const void* tok, const void* valid,
             void* out, int rows, int topk, int h, int d, int n_rows, float scale,
             void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (rows < 1 || topk < 1 || h < 1 || h > 65535 * kWarps || n_rows < 1)
        return static_cast<int>(err);
    if (d == 64)
        err = launch<2, kPaged>(q, k, v, tok, valid, out, rows, topk, h, n_rows, scale, s);
    else if (d == 128)
        err = launch<4, kPaged>(q, k, v, tok, valid, out, rows, topk, h, n_rows, scale, s);
    else if (d == 256)
        err = launch<8, kPaged>(q, k, v, tok, valid, out, rows, topk, h, n_rows, scale, s);
    return static_cast<int>(err);
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
    return launch_d<false>(q, k_sel, v_sel, nullptr, valid, out, rows, topk, h, d, 1, scale,
                           stream);
}

// q [rows, h, d] bf16, k_rows/v_rows [n_rows, h, d] bf16 (the flat cache
// views), tok [rows, topk] int32 (clipped to [0, n_rows) here), valid [rows,
// topk] uint8, out [rows, h, d] bf16; d is 64, 128 or 256.
extern "C" int dgt_sparse_attention_paged(const void* q, const void* k_rows, const void* v_rows,
                                          const void* tok, const void* valid, void* out,
                                          int rows, int topk, int h, int d, int n_rows,
                                          float scale, void* stream) {
    return launch_d<true>(q, k_rows, v_rows, tok, valid, out, rows, topk, h, d, n_rows, scale,
                          stream);
}
