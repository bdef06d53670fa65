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
//
// The flat entry takes the NT form of the JAX op
// (deepgemm_tpu/ops/k_grouped.py:66-96): each group's A and B segments stored
// k-major and flattened, a [m x k_g] at element m * k_start[g] and b [n x k_g]
// at n * k_start[g], read in place (Layout::kKGroupedFlat: a per-group base
// and row stride), so no relayout copy precedes it. Every k_g is a multiple
// of 16 elements (the 16-byte cp.async rows); its stages hold the same bytes
// as the TN form's on the same data, so the two are bitwise equal.

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
    const cudaError_t err =
        is_fp8 ? dgt::launch_gemm_out<dgt::FormE4m3, kKGrouped>(p, num_groups, block_n, out_f32, s)
               : dgt::launch_gemm_out<dgt::FormBf16, kKGrouped>(p, num_groups, block_n, out_f32, s);
    return static_cast<int>(err);
}

// The flat NT form, e4m3: a, b flattened per group as above; k_start [G] the
// first k of each group (the running sum of the depths), k_size [G] the
// depths (each a multiple of 16), sf_start [G], sfa [nsf_total, m], sfb
// [nsf_total, n], c and d as dgt_k_grouped_gemm_nt. Returns the cudaError_t
// of the launch (0 = success).
extern "C" int dgt_k_grouped_gemm_nt_flat(const void* a, const void* b, const void* sfa,
                                          const void* sfb, const void* c, const void* k_start,
                                          const void* k_size, const void* sf_start, void* d,
                                          int num_groups, int m, int n, int out_f32,
                                          int block_n, void* stream) {
    dgt::GemmArgs p = {};
    p.a = static_cast<const uint8_t*>(a);
    p.b = static_cast<const uint8_t*>(b);
    p.sfa = static_cast<const float*>(sfa);
    p.sfb = static_cast<const float*>(sfb);
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.sfb_shift = 0;                  // one scale per channel of B
    p.k_start = static_cast<const int*>(k_start);
    p.k_size = static_cast<const int*>(k_size);
    p.sf_start = static_cast<const int*>(sf_start);
    const cudaError_t err = dgt::launch_gemm_out<dgt::FormE4m3, dgt::Layout::kKGroupedFlat>(
        p, num_groups, block_n, out_f32, static_cast<cudaStream_t>(stream));
    return static_cast<int>(err);
}
