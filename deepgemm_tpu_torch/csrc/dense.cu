// Dense FP8 NT GEMM with f32 block scales (the 'promote' strategy):
//   d[m, n] = sum over 128-deep k blocks s of (a_s . b_s^T)[m, n] * sfb[s, n] * sfa[m, s]
// Replaces deepgemm_tpu/kernels/dense.py:_build_dense_gemm (pl.pallas_call at
// dense.py:291) for the NT layout. The mainloop and its notes are in
// gemm_mainloop.cuh; this file is the C entry point, bound with ctypes.

#include "gemm_mainloop.cuh"

// a [m, k] e4m3, b [n, k] e4m3, sfa [m, ceil(k/128)] f32,
// sfb [ceil(n/gran_n), ceil(k/128)] f32 with gran_n = 1 << sfb_shift, d [m, n] bf16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_dense_fp8_gemm_nt(const void* a, const void* b, const void* sfa,
                                     const void* sfb, void* d, int m, int n, int k,
                                     int sfb_shift, int block_n, void* stream) {
    dgt::GemmArgs p;
    p.a = static_cast<const uint8_t*>(a);
    p.b = static_cast<const uint8_t*>(b);
    p.sfa = static_cast<const float*>(sfa);
    p.sfb = static_cast<const float*>(sfb);
    p.masked_m = nullptr;
    p.d = static_cast<__nv_bfloat16*>(d);
    p.M = m;
    p.N = n;
    p.K = k;
    p.sfb_shift = sfb_shift;
    return static_cast<int>(dgt::launch_gemm_nt_bn<dgt::MmaE4m3, true>(
        p, 1, block_n, static_cast<cudaStream_t>(stream)));
}
