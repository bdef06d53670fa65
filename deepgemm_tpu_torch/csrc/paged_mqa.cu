// Paged MQA logits of the decode side, two entries on one body (mqa_sm90.cuh,
// Source::kPaged):
//   logits[b * next_n + t, c] = sum_h w * relu(q[b, t, h, :] . kv(b, c)) * sf(b, c)
// for c below the row's bound (the causal offset ctx - next_n + 1 + t with a
// 1-D context, the token's own context with a 2-D one), -inf elsewhere.
//
//   dgt_paged_mqa_logits_gather replaces deepgemm_tpu/kernels/paged_mqa.py:
//     _build_paged_mqa (pl.pallas_call at paged_mqa.py:166): it reads the
//     cache linearised by the wrapper's gather, kv_lin [B, kv_len, d] with
//     sf_lin [B, kv_len], as one page of kv_len rows a batch row.
//   dgt_paged_mqa_logits_paged replaces _build_paged_mqa_zerocopy
//     (pl.pallas_call at paged_mqa.py:382): it reads the pages and their
//     scales in place, kv_cache [num_blocks, block_kv, d] and kv_sf
//     [num_blocks, block_kv], through the clamped block table [B, mb].
// Columns at and past the cache (mb * block_kv, or kv_len) read zero rows.
// The two differ only in where the producer reads a kv row, so they give
// the same bits. q and the cache are e4m3 or bf16 each (the bf16 instances
// take the decoded FP4 operands). A batch row's next_n tokens are one query
// tile, run as groups of as many queries as N's 128 columns take, so any
// next_n runs. The TPU kernel's DMA knobs (DGT_ZC_SLOTS, DGT_ZC_COALESCE and
// the page adjacency levels) tune its DMA engines and change nothing
// computed; they have no counterpart here.

#include <math.h>

#include "mqa_sm90.cuh"

namespace {

using namespace dgt_mqa90;

int gcd(int a, int b) {
    while (b != 0) {
        const int t = a % b;
        a = b;
        b = t;
    }
    return a;
}

int log2_of(int x) {
    int k = 0;
    while ((1 << (k + 1)) <= x) ++k;
    return k;
}

// kv [num_pages * block_kv, d], sf [num_pages * block_kv]; table [B, mb], or
// null: batch row b's one page is page b (mb 1).
int paged_logits(const void* q, const void* w, const void* kv, const void* sf, const int* table,
                 const void* lo, const void* hi, void* out, int batch, int next_n, int h, int d,
                 int mb, int block_kv, int num_pages, int out_cols, int q_bf16, int kv_bf16,
                 int num_sms, cudaStream_t stream) {
    const long long cache_rows = static_cast<long long>(num_pages) * block_kv;
    if (d % 32 != 0 || d < 32 || d > 256 || h < 1 || h > 256 || batch < 1 || next_n < 1 ||
        out_cols < 1 || mb < 1 || block_kv < 1 || num_pages < 1 || num_sms < 1 ||
        cache_rows >= INT_MAX || static_cast<long long>(mb) * block_kv >= INT_MAX ||
        static_cast<long long>(batch) * next_n >= INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int q_bytes = q_bf16 ? 2 : 1, kv_bytes = kv_bf16 ? 2 : 1;
    const bool widen = widen_q(!q_bf16, !kv_bf16, Source::kPaged);
    const int sq = batch * next_n;
    Args p = {};
    Shape sh = shape_of(h, next_n, 0);
    // pieces: the rows of one page inside a stage; TMA boxes where a piece
    // is whole 8-row swizzle atoms (its scales by a box where it is 32 rows
    // or more, else by 16-byte chunks), else pieces of one row that the
    // producer warp copies
    int piece = gcd(block_kv, sh.rows);
    p.tma = piece % 8 == 0;
    if (!p.tma) piece = 1;
    p.piece_shift = log2_of(piece);
    p.sf_tma = piece >= 32;
    p.sf_box = piece;
    // fewer query rows an item where the staged tiles leave too few stages
    for (;;) {
        fit(sh.nb, d, q_bytes, kv_bytes, widen, sh.qg, &p.num_stages, &p.q_bufs);
        if (p.num_stages > 0 || sh.qg == 1) break;
        sh = shape_of(h, next_n, sh.qg / 2);
    }
    if (p.num_stages == 0) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap map_q = {}, map_kv = {}, map_sf = {};
    if (!make_map_q(&map_q, q, static_cast<uint64_t>(d) * q_bytes, h, sq, sh.hp, sh.qg))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p.tma &&
        (!sm90::make_map(&map_kv, kv, static_cast<uint64_t>(d) * kv_bytes, cache_rows,
                         static_cast<uint64_t>(d) * kv_bytes, piece) ||
         (p.sf_tma && !make_map_sf(&map_sf, sf, cache_rows, piece))))
        return static_cast<int>(cudaErrorInvalidValue);
    p.q = static_cast<const uint8_t*>(q);
    p.w = static_cast<const float*>(w);
    p.lo = static_cast<const int*>(lo);
    p.hi = static_cast<const int*>(hi);
    p.out = static_cast<float*>(out);
    p.fill = -INFINITY;
    p.has_sf = 1;
    p.sq = sq;
    p.h = h;
    p.hp = sh.hp;
    p.d = d;
    p.rows_per_tile = next_n;
    p.qg = sh.qg;
    p.groups_per_tile = sh.groups_per_tile;
    p.num_groups = batch * sh.groups_per_tile;
    p.out_cols = out_cols;
    p.block_table = table;
    p.kv = static_cast<const uint8_t*>(kv);
    p.sf = static_cast<const float*>(sf);
    p.mb = mb;
    p.block_kv = block_kv;
    p.tile_stride = block_kv;     // without a table: page b at row b * block_kv
    p.cache_rows = static_cast<int>(cache_rows);
    // num_runs items a group, each every num_runs-th stage of its columns:
    // about kPagedItemsPerSm items an SM, so that an SM's items come from
    // many groups; no more stages an item than the pieces' rows fit
    const int kv_stages = (out_cols + sh.rows - 1) / sh.rows;
    const long long want =
        (static_cast<long long>(kPagedItemsPerSm) * num_sms + p.num_groups - 1) / p.num_groups;
    int runs = static_cast<int>(want < 1 ? 1 : (want > kv_stages ? kv_stages : want));
    const int per_stage = sh.rows / piece;
    const int least = (kv_stages * per_stage + kMaxPieces - 1) / kMaxPieces;
    if (runs < least) runs = least;
    p.num_runs = runs;
    p.run = (kv_stages + runs - 1) / runs;
    if (p.run * per_stage > kMaxPieces) return static_cast<int>(cudaErrorInvalidValue);
    p.item_first = 1;
    p.stage_step = runs;
    return static_cast<int>(
        launch_typed<Source::kPaged>(map_q, map_kv, map_sf, p, q_bf16, kv_bf16, num_sms, stream));
}

}  // namespace

// q [B, next_n, h, d], w [B * next_n, h] f32, kv_lin [B, kv_len, d], sf_lin
// [B, kv_len] f32, lo [B * next_n] int32 or null (0), hi [B * next_n] int32,
// out [B * next_n, out_cols] f32;
// q_bf16 / kv_bf16 nonzero for a bf16 operand, zero for e4m3; q, kv_lin and
// sf_lin 16-byte aligned. num_sms: the persistent grid's size. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int dgt_paged_mqa_logits_gather(const void* q, const void* w, const void* kv_lin,
                                           const void* sf_lin, const void* lo, const void* hi,
                                           void* out, int batch, int next_n, int h, int d,
                                           int kv_len, int out_cols, int q_bf16, int kv_bf16,
                                           int num_sms, void* stream) {
    return paged_logits(q, w, kv_lin, sf_lin, nullptr, lo, hi, out, batch, next_n, h, d, 1, kv_len,
                        batch, out_cols, q_bf16, kv_bf16, num_sms,
                        static_cast<cudaStream_t>(stream));
}

// kv_cache [num_blocks, block_kv, d], kv_sf [num_blocks, block_kv] f32,
// block_table [B, mb] int32 (every entry a valid page); kv_cache and kv_sf
// 16-byte aligned; the rest as above.
extern "C" int dgt_paged_mqa_logits_paged(const void* q, const void* w, const void* kv_cache,
                                          const void* kv_sf, const void* block_table,
                                          const void* lo, const void* hi, void* out, int batch,
                                          int next_n, int h, int d, int num_blocks, int mb,
                                          int block_kv, int out_cols, int q_bf16, int kv_bf16,
                                          int num_sms, void* stream) {
    return paged_logits(q, w, kv_cache, kv_sf, static_cast<const int*>(block_table), lo, hi, out,
                        batch, next_n, h, d, mb, block_kv, num_blocks, out_cols, q_bf16, kv_bf16,
                        num_sms, static_cast<cudaStream_t>(stream));
}
