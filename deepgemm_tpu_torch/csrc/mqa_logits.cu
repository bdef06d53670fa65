// MQA ("lightning indexer") logits of the prefill side:
//   logits[i, c] = sum_h w[i, h] * relu(q[i, h, :] . kv[base + c, :]) * sf[base + c]
// for c in [lo[i], hi[i]), the fill elsewhere.
// Replaces deepgemm_tpu/kernels/mqa_logits.py:_build_mqa_logits (pl.pallas_call
// at mqa_logits.py:133). The full layout passes base 0, lo = ks, hi = ke and
// the fill -inf; the compressed layout (max_seqlen_k) one base per query
// tile (the tile's common ks), lo = 0, hi = ke - ks and the fill 0. The body
// and its notes are in mqa_tile.cuh; this file is the C entry point, bound
// with ctypes.

#include "mqa_tile.cuh"

// q [sq * h, d], w [sq, h] f32, kv [skv, d], sf [skv] f32 or null, lo/hi
// [sq] int32, kv_base [ceil(sq / rows_per_tile)] int32 or null, out [sq,
// out_cols] f32; q_bf16 / kv_bf16 nonzero for a bf16 operand, zero for e4m3.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_mqa_logits(const void* q, const void* w, const void* kv, const void* sf,
                              const void* lo, const void* hi, const void* kv_base, void* out,
                              int sq, int rows_per_tile, int h, int d, int skv, int out_cols,
                              float fill, int q_bf16, int kv_bf16, void* stream) {
    dgt_mqa::MqaArgs p = {};
    p.q = static_cast<const uint8_t*>(q);
    p.w = static_cast<const float*>(w);
    p.kv = static_cast<const uint8_t*>(kv);
    p.sf = static_cast<const float*>(sf);
    p.lo = static_cast<const int*>(lo);
    p.hi = static_cast<const int*>(hi);
    p.out = static_cast<float*>(out);
    p.kv_base = static_cast<const int*>(kv_base);
    p.kv_y_stride = 0;
    p.kv_limit = skv;
    p.y_per_row = 1;
    p.num_query_rows = sq;
    p.rows_per_tile = rows_per_tile;
    p.h = h;
    p.d = d;
    p.out_cols = out_cols;
    p.fill = fill;
    return static_cast<int>(dgt_mqa::launch_typed<dgt_mqa::Source::kLinear>(
        p, q_bf16, kv_bf16, static_cast<cudaStream_t>(stream)));
}
