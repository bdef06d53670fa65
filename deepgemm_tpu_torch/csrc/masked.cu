// Masked m-grouped NT GEMM, bf16 or scaled FP8:
//   d[g, :masked_m[g]] = a[g] . b[g]^T   (fp8: the f32 promotion per 128-k block)
// Replaces deepgemm_tpu/kernels/grouped.py:_build_masked (pl.pallas_call at
// grouped.py:576). The mainloop and its notes are in gemm_mainloop.cuh; each
// block reads masked_m[g] on the device and skips m-tiles past it.

#include "gemm_mainloop.cuh"

// a [G, max_m, k], b [G, n, k] (both bf16, or both e4m3 with
// sfa [G, max_m, ceil(k/128)] f32 and sfb [G, ceil(n/gran_n), ceil(k/128)] f32
// with gran_n = 1 << sfb_shift), masked_m [G] int32 on the device,
// d [G, max_m, n] bf16, or f32 when out_f32 (e4m3 operands only: the promoted
// sum unrounded, for fp8_bmm's + c). Returns the cudaError_t of the launch
// (0 = success).
extern "C" int dgt_masked_gemm_nt(const void* a, const void* b, const void* sfa,
                                  const void* sfb, const void* masked_m, void* d,
                                  int num_groups, int max_m, int n, int k, int is_fp8,
                                  int sfb_shift, int block_n, int out_f32, void* stream) {
    dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, max_m, n, k, sfb_shift);
    p.masked_m = static_cast<const int*>(masked_m);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr auto kBatched = dgt::Layout::kBatched;
    if (out_f32 && !is_fp8) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        is_fp8 ? dgt::launch_gemm_out<dgt::FormE4m3, kBatched>(p, num_groups, block_n, out_f32, s)
               : dgt::launch_gemm_bn<dgt::FormBf16, kBatched, __nv_bfloat16>(
                     p, num_groups, block_n, s);
    return static_cast<int>(err);
}
