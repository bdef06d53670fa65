// Paged MQA logits of the decode side, two entries on one body (mqa_tile.cuh):
//   logits[b * next_n + t, c] = sum_h w * relu(q[b, t, h, :] . kv(b, c)) * sf(b, c)
// for c below the row's bound (the causal offset ctx - next_n + 1 + t with a
// 1-D context, the token's own context with a 2-D one), -inf elsewhere.
//
//   dgt_paged_mqa_logits_gather replaces deepgemm_tpu/kernels/paged_mqa.py:
//     _build_paged_mqa (pl.pallas_call at paged_mqa.py:166): it reads the
//     cache linearised by the wrapper's gather, kv_lin [B, mb * block_kv, d]
//     with sf_lin [B, mb * block_kv].
//   dgt_paged_mqa_logits_paged replaces _build_paged_mqa_zerocopy
//     (pl.pallas_call at paged_mqa.py:382): it reads the pages and their
//     scales in place, kv_cache [num_blocks, block_kv, d] and kv_sf
//     [num_blocks, block_kv], through the clamped block table [B, mb].
// The two differ only in where a kv row is read from, so they give the same
// bits. q and the cache are e4m3 or bf16 each (the bf16 instances take the
// decoded FP4 operands). A batch row's next_n tokens form next_n /
// rows_per_tile query tiles that read the same pages (the op layer picks
// rows_per_tile so that a tile's q2 rows fit the block), so any next_n runs.
// The TPU kernel's DMA knobs (DGT_ZC_SLOTS, DGT_ZC_COALESCE and the page
// adjacency levels) tune its DMA engines and change nothing computed; they
// have no counterpart here.

#include <math.h>

#include "mqa_tile.cuh"

namespace {

dgt_mqa::MqaArgs paged_args(const void* q, const void* w, const void* kv, const void* sf,
                            const void* lo, const void* hi, void* out, int batch,
                            int next_n, int rows_per_tile, int h, int d, int out_cols) {
    dgt_mqa::MqaArgs p = {};
    p.q = static_cast<const uint8_t*>(q);
    p.w = static_cast<const float*>(w);
    p.kv = static_cast<const uint8_t*>(kv);
    p.sf = static_cast<const float*>(sf);
    p.lo = static_cast<const int*>(lo);
    p.hi = static_cast<const int*>(hi);
    p.out = static_cast<float*>(out);
    p.num_query_rows = batch * next_n;
    p.rows_per_tile = rows_per_tile;
    p.y_per_row = rows_per_tile > 0 && next_n % rows_per_tile == 0 ? next_n / rows_per_tile : 0;
    p.h = h;
    p.d = d;
    p.out_cols = out_cols;
    p.fill = -INFINITY;
    return p;
}

}  // namespace

// q [B, next_n, h, d], w [B * next_n, h] f32, kv_lin [B, kv_len, d], sf_lin
// [B, kv_len] f32, lo/hi [B * next_n] int32, out [B * next_n, out_cols] f32;
// rows_per_tile divides next_n; q_bf16 / kv_bf16 nonzero for a bf16 operand,
// zero for e4m3.
extern "C" int dgt_paged_mqa_logits_gather(const void* q, const void* w, const void* kv_lin,
                                           const void* sf_lin, const void* lo, const void* hi,
                                           void* out, int batch, int next_n, int rows_per_tile,
                                           int h, int d, int kv_len, int out_cols, int q_bf16,
                                           int kv_bf16, void* stream) {
    dgt_mqa::MqaArgs p = paged_args(q, w, kv_lin, sf_lin, lo, hi, out, batch, next_n,
                                    rows_per_tile, h, d, out_cols);
    p.kv_y_stride = kv_len;
    p.kv_limit = kv_len;
    return static_cast<int>(dgt_mqa::launch_typed<dgt_mqa::Source::kLinear>(
        p, q_bf16, kv_bf16, static_cast<cudaStream_t>(stream)));
}

// kv_cache [num_blocks, block_kv, d], kv_sf [num_blocks, block_kv] f32,
// block_table [B, mb] int32 (every entry a valid page); the rest as above.
extern "C" int dgt_paged_mqa_logits_paged(const void* q, const void* w, const void* kv_cache,
                                          const void* kv_sf, const void* block_table,
                                          const void* lo, const void* hi, void* out, int batch,
                                          int next_n, int rows_per_tile, int h, int d, int mb,
                                          int block_kv, int out_cols, int q_bf16, int kv_bf16,
                                          void* stream) {
    dgt_mqa::MqaArgs p = paged_args(q, w, kv_cache, kv_sf, lo, hi, out, batch, next_n,
                                    rows_per_tile, h, d, out_cols);
    p.block_table = static_cast<const int*>(block_table);
    p.mb = mb;
    p.block_kv = block_kv;
    return static_cast<int>(dgt_mqa::launch_typed<dgt_mqa::Source::kPaged>(
        p, q_bf16, kv_bf16, static_cast<cudaStream_t>(stream)));
}
