// Dense FP8 NT GEMM with f32 scales (the 'promote' strategy):
//   d[m, n] = sum over 128-deep k blocks s of (a_s . b_s^T)[m, n] * sfb[s, n] * sfa[m, s]
// Replaces deepgemm_tpu/kernels/dense.py:_build_dense_gemm (pl.pallas_call at
// dense.py:291) for the NT layout, with a bf16 or an f32 output (the JAX op's
// f32 `d` template, which the FP8 wgrad uses). The mainloop and its notes are
// in gemm_mainloop.cuh; this file is the C entry point, bound with ctypes.

#include "gemm_mainloop.cuh"

// a [m, k] e4m3, b [n, k] e4m3, sfa [m, ceil(k/128)] f32,
// sfb [ceil(n/gran_n), ceil(k/128)] f32 with gran_n = 1 << sfb_shift,
// d [m, n] f32 when out_f32 else bf16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_dense_fp8_gemm_nt(const void* a, const void* b, const void* sfa,
                                     const void* sfb, void* d, int m, int n, int k,
                                     int sfb_shift, int block_n, int out_f32, void* stream) {
    const dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, m, n, k, sfb_shift);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr auto kBatched = dgt::Layout::kBatched;
    const cudaError_t err =
        out_f32 ? dgt::launch_gemm_nt_bn<dgt::MmaE4m3, true, kBatched, float>(p, 1, block_n, s)
                : dgt::launch_gemm_nt_bn<dgt::MmaE4m3, true, kBatched, __nv_bfloat16>(
                      p, 1, block_n, s);
    return static_cast<int>(err);
}
