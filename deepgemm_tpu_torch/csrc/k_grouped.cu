// K-grouped GEMM (the MoE weight gradient), bf16 or FP8 with per-channel scales:
//   d[g] = c[g] + a[:, ks_g] . b[:, ks_g]^T   (f32 accumulation; fp8: the f32
//   promotion per 128-deep k block, 1 x 128 scales on both operands)
// Replaces deepgemm_tpu/kernels/k_grouped.py:_build_k_grouped (pl.pallas_call
// at k_grouped.py:237). The wrapper (kernels/k_grouped.py) turns the TN
// operands k-major with one copy, placing each group at a 16-element aligned
// column; the kernel then runs the NT mainloop of gemm_mainloop.cuh over each
// group's own k range, one grid z slice per group, and reads the group's
// k-first compacted scales from sf_start[g]. Output f32 (the op's contract)
// or bf16 (rounded once from the same f32 sum: the bits of f32-then-cast,
// without the f32 tensor).

#include "gemm_mainloop.cuh"

// a [m, ldk], b [n, ldk] k-major (bf16, or e4m3 with sfa [nsf_total, m] f32 and
// sfb [nsf_total, n] f32), group g covering columns [k_start[g], k_start[g] +
// k_size[g]) and scale rows from sf_start[g] (k_start, k_size, sf_start: [G]
// int32 on the device), c [G, m, n] f32 or null, d [G, m, n] f32 when out_f32
// else bf16. Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_k_grouped_gemm_nt(const void* a, const void* b, const void* sfa,
                                     const void* sfb, const void* c, const void* k_start,
                                     const void* k_size, const void* sf_start, void* d,
                                     int num_groups, int m, int n, long long ldk,
                                     int is_fp8, int out_f32, int block_n,
                                     void* stream) {
    dgt::GemmArgs p = {};
    p.a = static_cast<const uint8_t*>(a);
    p.b = static_cast<const uint8_t*>(b);
    p.sfa = static_cast<const float*>(sfa);
    p.sfb = static_cast<const float*>(sfb);
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.ldk = ldk;
    p.sfb_shift = 0;                  // one scale per channel of B
    p.k_start = static_cast<const int*>(k_start);
    p.k_size = static_cast<const int*>(k_size);
    p.sf_start = static_cast<const int*>(sf_start);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr auto kKGrouped = dgt::Layout::kKGrouped;
    using dgt::MmaBf16;
    using dgt::MmaE4m3;
    cudaError_t err;
    if (is_fp8) {
        err = out_f32 ? dgt::launch_gemm_nt_bn<MmaE4m3, true, kKGrouped, float>(p, num_groups, block_n, s)
                      : dgt::launch_gemm_nt_bn<MmaE4m3, true, kKGrouped, __nv_bfloat16>(
                            p, num_groups, block_n, s);
    } else {
        err = out_f32 ? dgt::launch_gemm_nt_bn<MmaBf16, false, kKGrouped, float>(p, num_groups, block_n, s)
                      : dgt::launch_gemm_nt_bn<MmaBf16, false, kKGrouped, __nv_bfloat16>(
                            p, num_groups, block_n, s);
    }
    return static_cast<int>(err);
}
