// Contiguous m-grouped GEMM, bf16 or scaled FP8, NT or NN:
//   d[m, n] = a[m, k] . b[gid(m-tile)][n, k]^T   (fp8: the f32 promotion per 128-k block)
// Replaces deepgemm_tpu/kernels/grouped.py:_build_contiguous (pl.pallas_call at
// grouped.py:240) and its dual-B variant _build_contiguous_dual_b
// (pl.pallas_call at grouped.py:401). The rows of a and d are the groups' row
// blocks, each starting on a multiple of the mk alignment, so no tile
// straddles two groups. Each tile's group and its group's end row come from
// tile_gid / tile_row_end, which the wrapper computes on the device from
// grouped_layout (kernels/grouped.py:compute_tile_gids): the host never reads
// the layout.
//
// All forms run the Hopper mainloop of gemm_sm90.cuh (its notes say how):
// 128-row tiles where the mk alignment is a multiple of 128, 64-row ones
// otherwise; the NN form (B [G, k, n], B's BlockSpec at grouped.py:139-145)
// reads B as it lies and is bitwise NT on b.transpose(1, 2).contiguous();
// the dual-B form (256-row tiles whose 128-row halves may belong to two
// groups, tile_gid [m/256][2]) is bitwise the contiguous form.

#include "gemm_sm90.cuh"

using namespace dgt::sm90;

namespace {

using Bf16 = __nv_bfloat16;

template <int kBM, int kBN, Kind kKind, BForm kBForm, bool kBMn>
cudaError_t launch_contiguous(const CUtensorMap& map_a, const CUtensorMap& map_b,
                              const CUtensorMap& map_d, const Args& p, int num_sms,
                              cudaStream_t s) {
    return launch<kBM, kBN, Bf16, kKind, kBForm, kBMn>(map_a, map_b, map_d, p, num_sms, s);
}

// The 64- or 128-row instance of one form.
template <BForm kBForm, bool kBMn>
cudaError_t launch_rows(const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const CUtensorMap& map_d, const Args& p, int block_m, int num_sms,
                        cudaStream_t s) {
    constexpr Kind kC = Kind::kContiguous;
    if (block_m == 128)
        return launch_contiguous<128, 128, kC, kBForm, kBMn>(map_a, map_b, map_d, p, num_sms, s);
    if (block_m == 64)
        return launch_contiguous<64, 128, kC, kBForm, kBMn>(map_a, map_b, map_d, p, num_sms, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// a [m, k] and b [G, n, k] (b_mn: [G, k, n]), both bf16, or both e4m3 with
// sfa [m, ceil(k/128)] f32 and sfb [G, ceil(n/gran_n), ceil(k/128)] f32
// (gran_n = 1 << sfb_shift) and scratch ceil(k/128) * (sfa_ld + G sfb_ld) f32
// for their k-first copies (sfa_ld, sfb_ld: m and ceil(n/gran_n) rounded up
// to 4); k % 16 == 0, n even (b_mn: n % 16 == 0 e4m3, n % 8 == 0 bf16).
// block_m 64 or 128: tile_gid [ceil(m/block_m)] int32, tile_row_end the same
// or null (rows at or past it are written as zero: ensure_zero_padding);
// block_m 256, the dual-B form (NT, m % 256 == 0; 64 columns a tile):
// tile_gid [m/256][2], the group of each 128-row half. d [m, n] bf16. num_stages and num_sms from
// heuristics/configs.py:get_sm90_config. Returns the cudaError_t of the
// launches (0 = success).
extern "C" int dgt_contiguous_gemm(const void* a, const void* b, const void* sfa,
                                   const void* sfb, void* scratch, const void* tile_gid,
                                   const void* tile_row_end, void* d, int m, int n, int k,
                                   int num_groups, int sfa_ld, int sfb_ld, int sfb_shift,
                                   int is_fp8, int b_mn, int block_m, int num_stages,
                                   int num_sms, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool dual = block_m == 256;
    if (dual && b_mn) return static_cast<int>(cudaErrorInvalidValue);
    const int ksf = (k + kBK - 1) / kBK;
    const int nsf = ((n - 1) >> sfb_shift) + 1;
    const uint64_t elem = is_fp8 ? 1 : 2;
    Args p = {};
    if (is_fp8) {
        const cudaError_t err = launch_k_first(sfa, sfb, scratch, m, nsf, ksf, sfa_ld, sfb_ld,
                                               num_groups, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        p.sfa = static_cast<const float*>(scratch);
        p.sfb = p.sfa + static_cast<int64_t>(ksf) * sfa_ld;
        p.sfa_ld = sfa_ld;
        p.sfb_ld = sfb_ld;
        p.sfb_group_stride = static_cast<int64_t>(ksf) * sfb_ld;
    }
    const uint64_t k_bytes = static_cast<uint64_t>(k) * elem;
    const uint64_t n_bytes = static_cast<uint64_t>(n) * elem;
    CUtensorMap map_a, map_b, map_d = {};
    // B: [G, n, k] in boxes of block_n rows, or MN-major [G, k, n] in boxes of
    // one stage's k rows (128 e4m3, 64 bf16)
    const bool mapped =
        make_map(&map_a, a, k_bytes, m, k_bytes, dual ? 256 : block_m) &&
        (b_mn ? make_map_3d(&map_b, b, n_bytes, k, n_bytes, num_groups, is_fp8 ? 128 : 64)
              : make_map_3d(&map_b, b, k_bytes, n, k_bytes, num_groups, dual ? 64 : 128));
    if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
    p.tma_store = make_out_map(&map_d, d, n, m, 1, 0) ? 1 : 0;
    p.d = d;
    p.M = m;
    p.N = n;
    p.num_kb = static_cast<int>((k_bytes + kBK - 1) / kBK);
    p.sfb_shift = sfb_shift;
    p.num_groups = num_groups;
    p.num_stages = num_stages;
    p.tile_gid = static_cast<const int*>(tile_gid);
    p.tile_row_end = static_cast<const int*>(tile_row_end);
    cudaError_t err;
    if (dual) {
        constexpr Kind kD = Kind::kContiguousDual;
        err = !is_fp8 ? launch_contiguous<256, 64, kD, BForm::kUnscaled, false>(
                            map_a, map_b, map_d, p, num_sms, s)
            : sfb_shift >= 7 ? launch_contiguous<256, 64, kD, BForm::kBlockScaled, false>(
                                   map_a, map_b, map_d, p, num_sms, s)
                             : launch_contiguous<256, 64, kD, BForm::kChannelScaled, false>(
                                   map_a, map_b, map_d, p, num_sms, s);
    } else if (!is_fp8) {
        err = b_mn ? launch_rows<BForm::kUnscaled, true>(map_a, map_b, map_d, p, block_m, num_sms, s)
                   : launch_rows<BForm::kUnscaled, false>(map_a, map_b, map_d, p, block_m, num_sms,
                                                          s);
    } else if (sfb_shift >= 7) {
        err = b_mn ? launch_rows<BForm::kBlockScaled, true>(map_a, map_b, map_d, p, block_m,
                                                            num_sms, s)
                   : launch_rows<BForm::kBlockScaled, false>(map_a, map_b, map_d, p, block_m,
                                                             num_sms, s);
    } else {
        err = b_mn ? launch_rows<BForm::kChannelScaled, true>(map_a, map_b, map_d, p, block_m,
                                                              num_sms, s)
                   : launch_rows<BForm::kChannelScaled, false>(map_a, map_b, map_d, p, block_m,
                                                               num_sms, s);
    }
    return static_cast<int>(err);
}
