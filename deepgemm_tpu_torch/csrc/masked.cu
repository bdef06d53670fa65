// Masked m-grouped NT GEMM, bf16 or scaled FP8:
//   d[g, :masked_m[g]] = a[g] . b[g]^T   (fp8: the f32 promotion per 128-k block)
// Replaces deepgemm_tpu/kernels/grouped.py:_build_masked (pl.pallas_call at
// grouped.py:576). It runs the Hopper mainloop of gemm_sm90.cuh on bf16
// products as its masked items (widen_body, Items kMasked; its notes say
// how): (group, row tile, column tile) items on a persistent grid, an item
// whose first row is at or past masked_m[g] (read on the device) skipped
// before any load; a [G, M, K] and b [G, N, K] through 3-D tensor maps, so a
// tile past max_m or n reads zeros, never the next group; 64-row tiles where
// max_m <= 64, else 128. e4m3 operands are widened exactly to bf16 and each
// 128-deep block's f32 sum promoted as (p * sfb) * sfa, the arithmetic of
// the plain version. The fused dispatch + L1 (mega_ep.cu) runs the same
// body, so its output is bitwise this kernel's on the received rows.

#include "gemm_sm90.cuh"

using namespace dgt::sm90;

namespace {

using Bf16 = __nv_bfloat16;

template <Operand kAB, class OutT>
cudaError_t launch_rows(const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const CUtensorMap& map_d, const MaskedArgs& a, int block_m, int num_sms,
                        cudaStream_t s) {
    if (block_m == 128) return launch_masked<128, OutT, kAB>(map_a, map_b, map_d, a, num_sms, s);
    if (block_m == 64) return launch_masked<64, OutT, kAB>(map_a, map_b, map_d, a, num_sms, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// a [G, max_m, k], b [G, n, k] (both bf16, or both e4m3 with
// sfa [G, max_m, ceil(k/128)] f32 and sfb [G, ceil(n/gran_n), ceil(k/128)] f32,
// gran_n = 1 << sfb_shift, and scratch G ceil(k/128) (sfa_ld + sfb_ld) f32 for
// their k-first copies, sfa_ld and sfb_ld being max_m and ceil(n/gran_n)
// rounded up to 4), masked_m [G] int32 on the device, d [G, max_m, n] bf16,
// or f32 when out_f32 (e4m3 operands only: the promoted sum unrounded, for
// fp8_bmm's + c); k % 16 == 0, n even. block_m (64 or 128), num_stages and
// num_sms from heuristics/configs.py:get_sm90_config. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int dgt_masked_gemm_nt(const void* a, const void* b, const void* sfa,
                                  const void* sfb, void* scratch, const void* masked_m, void* d,
                                  int num_groups, int max_m, int n, int k, int sfa_ld,
                                  int sfb_ld, int is_fp8, int sfb_shift, int out_f32,
                                  int block_m, int num_stages, int num_sms, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_f32 && !is_fp8) return static_cast<int>(cudaErrorInvalidValue);
    const int ksf = (k + kBK - 1) / kBK;
    const int nsf = ((n - 1) >> sfb_shift) + 1;
    MaskedArgs ma = {};
    Args& p = ma.p;
    if (is_fp8) {
        // each group's scale rows k-first, a group's rows of A from a
        // 16-byte-aligned start (the bulk copies need it)
        float* sfa_k = static_cast<float*>(scratch);
        float* sfb_k = sfa_k + static_cast<int64_t>(num_groups) * ksf * sfa_ld;
        cudaError_t err = launch_k_first(nullptr, sfa, sfa_k, 0, max_m, ksf, 0, sfa_ld,
                                         num_groups, s);
        if (err == cudaSuccess)
            err = launch_k_first(nullptr, sfb, sfb_k, 0, nsf, ksf, 0, sfb_ld, num_groups, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        p.sfa = sfa_k;
        p.sfb = sfb_k;
        p.sfa_ld = sfa_ld;
        p.sfb_ld = sfb_ld;
        p.sfb_group_stride = static_cast<int64_t>(ksf) * sfb_ld;
    }
    const uint64_t k_bytes = static_cast<uint64_t>(k) * (is_fp8 ? 1 : 2);
    CUtensorMap map_a, map_b, map_d = {};
    if (!make_map_3d(&map_a, a, k_bytes, max_m, k_bytes, num_groups, block_m) ||
        !make_map_3d(&map_b, b, k_bytes, n, k_bytes, num_groups, kDenseBN))
        return static_cast<int>(cudaErrorInvalidValue);
    p.tma_store = make_out_map(&map_d, d, n, max_m, num_groups, out_f32) ? 1 : 0;
    p.d = d;
    p.M = max_m;
    p.N = n;
    p.num_kb = is_fp8 ? ksf : (2 * k + kBK - 1) / kBK;   // a stage: 128 values of e4m3, 64 of bf16
    p.sfb_shift = sfb_shift;
    p.num_groups = num_groups;
    p.num_stages = num_stages;
    ma.masked_m = static_cast<const int*>(masked_m);
    constexpr Operand kE4m3 = Operand::kE4m3, kBf16 = Operand::kBf16;
    cudaError_t err;
    if (!is_fp8)
        err = launch_rows<kBf16, Bf16>(map_a, map_b, map_d, ma, block_m, num_sms, s);
    else if (out_f32)
        err = launch_rows<kE4m3, float>(map_a, map_b, map_d, ma, block_m, num_sms, s);
    else
        err = launch_rows<kE4m3, Bf16>(map_a, map_b, map_d, ma, block_m, num_sms, s);
    return static_cast<int>(err);
}
