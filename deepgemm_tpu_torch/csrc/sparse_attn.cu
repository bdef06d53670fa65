// Attention over the top-k rows that the indexer selected, per row r and head:
//   out[r, h] = sum_t p[t] * V[r, t, h, :],
//   p = softmax over the valid t of scale * q[r, h, :] . K[r, t, h, :]
// in f32, a row with no valid t giving 0. Two entries on one body:
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
// its rows are never copied, so a NaN or Inf in an unselected cache row, or a
// tok entry pointing anywhere, cannot reach the output.
//
// What bounds it on the H100: each head of a row has its own K/V and one
// query vector, so the work is a matvec streamed from HBM. Every valid
// selected k and v element is read once, 4 * h * d bytes a valid (row, t),
// against ~4 operations a bf16 element: three orders of magnitude below the
// card's ~295 bf16 tensor-core operations a byte, so the bytes bound it and
// tensor cores are no lever. At the decode shape (64 rows x top-2048 x 128
// heads x d 128) that is 8.59 GB, 2.57 ms at 3.35 TB/s.
//
// Design: a block is one (row, head group); the group's heads' k (and v) row
// for one t is one contiguous run of h_blk * d * 2 bytes, in the gathered
// layout and in the cache alike (kTileBytes = 4 KB: 16 heads at d 128). One
// producer warp walks the row's t in windows of 32 positions, a lane a
// position (its valid flag and, paged, its tok entry fetched a window
// ahead), and fills a ring of kStages stages of kStagePositions positions
// in shared memory: each valid position's k and v runs go in as two 1-D bulk
// async copies (cp.async.bulk) that complete on the stage's mbarrier, the
// stage's valid positions beside them as a bit mask. Hopper has no TMA row
// gather, and a tensor map over the gathered layout would part the two
// entries, so the copies are 1-D, one a (position, k or v). The two
// entries differ only in the address the producer computes, so on the same
// rows they give the same bits. The consumer warps read 16 bytes a lane
// from the ring: kLanes = d / 8 lanes hold one (head, t) row, so a warp
// instruction covers 256 / d heads and a score takes log2(d / 8) xor
// shuffles (4 at d 128). They fold each chunk of kChunk positions into an
// online softmax (one rescale a chunk). A block's ring is 96 KB, two blocks
// an SM: up to 192 KB of copies in flight an SM, so the loads of the next
// stages overlap the math of this one (chip_smoke.py --attn-variants times
// the ring at 2 and 4 stages, 8 positions a stage and 32-head groups).
//
// Invariance: a (row, head) is the same sequence of operations whatever
// the other rows and heads are and whatever the ring's shape: the chunks are
// fixed by t alone, the lanes by d, and nothing is split over t or summed
// with atomics.

#include <math.h>

#include "gemm_sm90.cuh"

namespace dgt_attn {

namespace sm90 = dgt::sm90;

constexpr int kConsumerWarps = 8;
constexpr int kStagePositions = 4;
constexpr int kStages = 3;
constexpr int kChunk = 4;                              // positions a softmax rescale
constexpr int kTileBytes = kConsumerWarps * 32 * 16;   // one head group's k (or v) row
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kRingBytes = kStages * kStagePositions * 2 * kTileBytes;
// the ring, then each stage's full and empty barriers and valid bits: all
// dynamic, as the opt-in to the block's limit leaves no static room
constexpr int kSmemBytes = kRingBytes + kStages * (8 + 8 + 4);
static_assert(kStagePositions % kChunk == 0 && 32 % kStagePositions == 0 && kStagePositions < 32,
              "a stage is whole chunks, a producer window whole stages");
static_assert(kSmemBytes <= sm90::kSmemLimit, "the ring fits in shared memory");

__device__ __forceinline__ void unpack8(const uint4& raw, float (&dst)[8]) {
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pairs[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
    }
}

// q . k over one (head, t) row held by kLanes lanes, 8 elements a lane: an
// f32 FMA chain in the lane, then xor shuffles within the lane group (every
// lane of the group ends with the same sum).
template <int kLanes>
__device__ __forceinline__ float score(const float (&qf)[8], const uint4& raw) {
    float kf[8];
    unpack8(raw, kf);
    float part = 0.f;
    #pragma unroll
    for (int i = 0; i < 8; ++i) part = __fmaf_rn(qf[i], kf[i], part);
    #pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    return part;
}

// One chunk's valid scores (the invalid ones -inf) folded into the online
// softmax: one rescale, then p = exp(s - m) and p * v for each valid t in
// order. A chunk with no valid t leaves the state as it is.
__device__ __forceinline__ void fold_chunk(const float (&sc)[kChunk], uint32_t bits,
                                           const uint8_t* v_tile, float& m, float& den,
                                           float (&acc)[8]) {
    float chunk_max = -INFINITY;
    #pragma unroll
    for (int c = 0; c < kChunk; ++c) chunk_max = fmaxf(chunk_max, sc[c]);
    if (chunk_max == -INFINITY) return;
    const float m_new = fmaxf(m, chunk_max);
    const float alpha = expf(m - m_new);   // 0 while nothing was valid
    den = __fmul_rn(den, alpha);
    #pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fmul_rn(acc[i], alpha);
    #pragma unroll
    for (int c = 0; c < kChunk; ++c) {
        if (!(bits >> c & 1u)) continue;
        const float pc = expf(sc[c] - m_new);
        den = __fadd_rn(den, pc);
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(v_tile + c * 2 * kTileBytes), vf);
        #pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fmaf_rn(pc, vf[i], acc[i]);
    }
    m = m_new;
}

// kD: the head dim (64, 128 or 256); kPaged: K and V rows come from the flat
// cache views through tok, clipped to [0, n_rows); otherwise from the
// gathered [rows, topk, h, d] layout.
template <int kD, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
sparse_attn_ring(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ tok,
                 const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out, int topk,
                 int h, int groups, int n_rows, float scale) {
    constexpr int kLanes = kD / 8;               // lanes on one (head, t) row
    constexpr int kHeads = kConsumerWarps * 32 / kLanes;
    extern __shared__ __align__(128) uint8_t ring[];
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
    uint64_t* empty = full + kStages;
    uint32_t* stage_bits = reinterpret_cast<uint32_t*>(empty + kStages);

    const int64_t row = blockIdx.x / groups;
    const int head0 = (blockIdx.x % groups) * kHeads;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_stages = (topk + kStagePositions - 1) / kStagePositions;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full + s, 1);
            sm90::mbar_init(empty + s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == kConsumerWarps) {
        // ---- producer: lane l holds position w0 + l of a window of 32 (its
        // flag and, paged, its tok entry, fetched a window ahead) and copies
        // it in the window's stage l / kStagePositions
        const uint8_t* ok_row = valid + row * topk;
        const int* tok_row = kPaged ? tok + row * topk : nullptr;
        const int64_t t_stride = static_cast<int64_t>(h) * kD;
        const uint32_t copy_bytes = static_cast<uint32_t>(min(kHeads, h - head0) * kD * 2);
        uint8_t ok_raw = 0;
        int tok_raw = 0;
        auto fetch = [&](int t, uint8_t& ok_t, int& tok_t) {
            ok_t = t < topk ? ok_row[t] : 0;
            if constexpr (kPaged) tok_t = t < topk ? tok_row[t] : 0;
        };
        fetch(lane, ok_raw, tok_raw);
        for (int w0 = 0; w0 < topk; w0 += 32) {
            uint8_t ok_next = 0;
            int tok_next = 0;
            fetch(w0 + 32 + lane, ok_next, tok_next);     // in flight under this window
            const bool ok = ok_raw != 0;
            int64_t src;
            if constexpr (kPaged)
                src = static_cast<int64_t>(min(max(tok_raw, 0), n_rows - 1)) * t_stride;
            else
                src = (row * topk + w0 + lane) * t_stride;
            src += static_cast<int64_t>(head0) * kD;
            const uint32_t window = __ballot_sync(0xffffffffu, ok);
            for (int j = 0; j < 32 / kStagePositions; ++j) {
                const int i = w0 / kStagePositions + j;
                if (i >= n_stages) break;
                const int s = i % kStages;
                sm90::mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
                const uint32_t bits =
                    (window >> (j * kStagePositions)) & ((1u << kStagePositions) - 1u);
                if (lane == 0) {
                    stage_bits[s] = bits;
                    sm90::mbar_arrive_expect_tx(full + s, __popc(bits) * 2 * copy_bytes);
                }
                __syncwarp();
                if (ok && lane / kStagePositions == j) {
                    uint8_t* dst =
                        ring + (s * kStagePositions + lane % kStagePositions) * 2 * kTileBytes;
                    sm90::bulk_load(dst, k + src, copy_bytes, full + s);
                    sm90::bulk_load(dst + kTileBytes, v + src, copy_bytes, full + s);
                }
            }
            ok_raw = ok_next;
            tok_raw = tok_next;
        }
        return;
    }

    // ---- consumers: thread x holds bytes [16 x, 16 x + 16) of every tile
    const int head = head0 + threadIdx.x / kLanes;
    const bool live = head < h;
    float qf[8];
    {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (live)
            raw = *reinterpret_cast<const uint4*>(q + (row * h + head) * kD +
                                                  (threadIdx.x % kLanes) * 8);
        unpack8(raw, qf);
    }
    float m = -INFINITY, den = 0.f, acc[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;

    for (int i = 0; i < n_stages; ++i) {
        const int s = i % kStages;
        sm90::mbar_wait(full + s, (i / kStages) & 1);
        const uint32_t bits = stage_bits[s];
        const uint8_t* base = ring + s * kStagePositions * 2 * kTileBytes + threadIdx.x * 16;
        #pragma unroll
        for (int c0 = 0; c0 < kStagePositions; c0 += kChunk) {
            const uint8_t* tile = base + c0 * 2 * kTileBytes;
            const uint32_t chunk_bits = bits >> c0;
            uint4 kr[kChunk];
            #pragma unroll
            for (int c = 0; c < kChunk; ++c)
                kr[c] = *reinterpret_cast<const uint4*>(tile + c * 2 * kTileBytes);
            float sc[kChunk];
            #pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                const float dot = score<kLanes>(qf, kr[c]);
                sc[c] = (chunk_bits >> c & 1u) ? __fmul_rn(dot, scale) : -INFINITY;
            }
            fold_chunk(sc, chunk_bits, tile + kTileBytes, m, den, acc);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + s);
    }

    if (!live) return;
    const float inv = den > 0.f ? 1.f / den : 0.f;
    uint4 res;
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&res);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float x = den > 0.f ? __fmul_rn(acc[2 * i], inv) : 0.f;
        const float y = den > 0.f ? __fmul_rn(acc[2 * i + 1], inv) : 0.f;
        pairs[i] = __floats2bfloat162_rn(x, y);
    }
    *reinterpret_cast<uint4*>(out + (row * h + head) * kD + (threadIdx.x % kLanes) * 8) = res;
}

template <int kD, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tok,
                   const void* valid, void* out, int rows, int topk, int h, int n_rows,
                   float scale, cudaStream_t stream) {
    constexpr int kHeads = kConsumerWarps * 32 / (kD / 8);
    const int groups = (h + kHeads - 1) / kHeads;
    if (static_cast<int64_t>(rows) * groups > INT_MAX) return cudaErrorInvalidValue;
    constexpr auto kernel = sparse_attn_ring<kD, kPaged>;
    const cudaError_t err = sm90::opt_in<kernel>();
    if (err != cudaSuccess) return err;
    kernel<<<rows * groups, kThreads, kSmemBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tok),
        static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out), topk, h, groups,
        n_rows, scale);
    return cudaGetLastError();
}

template <bool kPaged>
int launch_d(const void* q, const void* k, const void* v, const void* tok, const void* valid,
             void* out, int rows, int topk, int h, int d, int n_rows, float scale,
             void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (rows < 1 || topk < 1 || h < 1 || n_rows < 1) return static_cast<int>(err);
    if (d == 64)
        err = launch<64, kPaged>(q, k, v, tok, valid, out, rows, topk, h, n_rows, scale, s);
    else if (d == 128)
        err = launch<128, kPaged>(q, k, v, tok, valid, out, rows, topk, h, n_rows, scale, s);
    else if (d == 256)
        err = launch<256, kPaged>(q, k, v, tok, valid, out, rows, topk, h, n_rows, scale, s);
    return static_cast<int>(err);
}

}  // namespace dgt_attn

// q [rows, h, d] bf16, k_sel/v_sel [rows, topk, h, d] bf16, valid [rows, topk]
// uint8 (0 or 1), out [rows, h, d] bf16; d is 64, 128 or 256; every pointer
// 16-byte aligned. Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_sparse_attention(const void* q, const void* k_sel, const void* v_sel,
                                    const void* valid, void* out, int rows, int topk, int h,
                                    int d, float scale, void* stream) {
    return dgt_attn::launch_d<false>(q, k_sel, v_sel, nullptr, valid, out, rows, topk, h, d, 1,
                                     scale, stream);
}

// q [rows, h, d] bf16, k_rows/v_rows [n_rows, h, d] bf16 (the flat cache
// views), tok [rows, topk] int32 (clipped to [0, n_rows) here), valid [rows,
// topk] uint8, out [rows, h, d] bf16; d is 64, 128 or 256; every pointer
// 16-byte aligned.
extern "C" int dgt_sparse_attention_paged(const void* q, const void* k_rows, const void* v_rows,
                                          const void* tok, const void* valid, void* out,
                                          int rows, int topk, int h, int d, int n_rows,
                                          float scale, void* stream) {
    return dgt_attn::launch_d<true>(q, k_rows, v_rows, tok, valid, out, rows, topk, h, d, n_rows,
                                    scale, stream);
}
