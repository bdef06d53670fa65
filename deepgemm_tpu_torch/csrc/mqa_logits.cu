// MQA ("lightning indexer") logits of the prefill side:
//   logits[i, c] = sum_h w[i, h] * relu(q[i, h, :] . kv[base + c, :]) * sf[base + c]
// for c in [lo[i], hi[i]), the fill elsewhere.
// Replaces deepgemm_tpu/kernels/mqa_logits.py:_build_mqa_logits (pl.pallas_call
// at mqa_logits.py:133). The full layout passes base 0, lo = ks, hi = ke and
// the fill -inf; the compressed layout (max_seqlen_k) one base per query
// tile (the tile's common ks), lo = 0, hi = ke - ks and the fill 0. The body
// and its notes are in mqa_sm90.cuh (wgmma + TMA); this file is the C entry
// point, bound with ctypes.

#include "mqa_sm90.cuh"

// q [sq, h, d], w [sq, h] f32, kv [skv, d], sf [skv] f32 or null, lo/hi [sq]
// int32, kv_base [ceil(sq / rows_per_tile)] int32 or null, out [sq, out_cols]
// f32; q_bf16 / kv_bf16 nonzero for a bf16 operand, zero for e4m3; q, kv and
// sf 16-byte aligned. num_sms: the persistent grid's size. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int dgt_mqa_logits(const void* q, const void* w, const void* kv, const void* sf,
                              const void* lo, const void* hi, const void* kv_base, void* out,
                              int sq, int rows_per_tile, int h, int d, int skv, int out_cols,
                              float fill, int q_bf16, int kv_bf16, int num_sms, void* stream) {
    using namespace dgt_mqa90;
    if (d % 32 != 0 || d < 32 || d > 256 || h < 1 || h > 256 || rows_per_tile < 1 ||
        rows_per_tile * h > 256 || sq < 1 || skv < 1 || out_cols < 1 || num_sms < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int q_bytes = q_bf16 ? 2 : 1, kv_bytes = kv_bf16 ? 2 : 1;
    const bool widen = widen_q(!q_bf16, !kv_bf16, Source::kLinear);
    Args p = {};
    Shape sh = shape_of(h, rows_per_tile, 0);
    // one piece a stage: its rows in one box from row kv_base[tile] + c0,
    // its scales in a box of rows + 4 from the 16-byte boundary at or before
    p.tma = p.sf_tma = 1;
    p.piece_shift = sh.rows == 128 ? 7 : 6;
    p.sf_box = sh.rows + 4;
    // fewer query rows an item where the staged tiles leave too few stages
    for (;;) {
        fit(sh.nb, d, q_bytes, kv_bytes, widen, sh.qg, &p.num_stages, &p.q_bufs);
        if (p.num_stages > 0 || sh.qg == 1) break;
        sh = shape_of(h, rows_per_tile, sh.qg / 2);
    }
    if (p.num_stages == 0) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap map_q = {}, map_kv = {}, map_sf = {};
    if (!make_map_q(&map_q, q, static_cast<uint64_t>(d) * q_bytes, h, sq, sh.hp, sh.qg) ||
        !dgt::sm90::make_map(&map_kv, kv, static_cast<uint64_t>(d) * kv_bytes, skv,
                             static_cast<uint64_t>(d) * kv_bytes, sh.rows) ||
        (sf != nullptr && !make_map_sf(&map_sf, sf, skv, p.sf_box)))
        return static_cast<int>(cudaErrorInvalidValue);
    p.w = static_cast<const float*>(w);
    p.lo = static_cast<const int*>(lo);
    p.hi = static_cast<const int*>(hi);
    p.kv_base = static_cast<const int*>(kv_base);
    p.out = static_cast<float*>(out);
    p.fill = fill;
    p.has_sf = sf != nullptr;
    p.q = static_cast<const uint8_t*>(q);
    p.sq = sq;
    p.h = h;
    p.hp = sh.hp;
    p.d = d;
    p.rows_per_tile = rows_per_tile;
    p.qg = sh.qg;
    p.groups_per_tile = sh.groups_per_tile;
    p.num_groups = (sq + rows_per_tile - 1) / rows_per_tile * sh.groups_per_tile;
    p.out_cols = out_cols;
    // a query tile's one page from row kv_base[tile] (0 without kv_base), as
    // long as any column
    p.kv = static_cast<const uint8_t*>(kv);
    p.sf = static_cast<const float*>(sf);
    p.mb = 1;
    p.block_kv = INT_MAX;
    p.cache_rows = skv;
    // runs of neighbouring kv stages long enough for ~2 items an SM (the q
    // rows load once an item; 4 and 8 items an SM ran the prefill path's
    // call slower on the H100), the groups of a run neighbours in the item
    // order; at most kMaxPieces stages a run (its pieces' rows in shared
    // memory)
    const int kv_stages = (out_cols + sh.rows - 1) / sh.rows;
    const long long pairs = static_cast<long long>(p.num_groups) * kv_stages;
    long long run = (pairs + 2LL * num_sms - 1) / (2LL * num_sms);
    if (run > kv_stages) run = kv_stages;
    if (run > kMaxPieces) run = kMaxPieces;
    p.run = static_cast<int>(run < 1 ? 1 : run);
    p.num_runs = (kv_stages + p.run - 1) / p.run;
    p.item_first = p.run;
    p.stage_step = 1;
    return static_cast<int>(launch_typed<Source::kLinear>(map_q, map_kv, map_sf, p, q_bf16,
                                                          kv_bf16, num_sms,
                                                          static_cast<cudaStream_t>(stream)));
}
