// K-grouped GEMM (the MoE weight gradient), FP8 with per-channel scales or
// bf16:
//   d[g] = c[g] + a[:, ks_g] . b[:, ks_g]^T   (f32 accumulation; fp8: the f32
//   promotion per 128-deep k block, 1 x 128 scales on both operands)
// Replaces deepgemm_tpu/kernels/k_grouped.py:_build_k_grouped (pl.pallas_call
// at k_grouped.py:237). Output f32 (the op's contract) or bf16 (rounded once
// from the same f32 sum: the bits of f32-then-cast, without the f32 tensor).
//
// FP8 runs the Hopper mainloop of gemm_sm90.cuh (wgmma + TMA, persistent
// over (group, row tile, column tile) work items). The TN entry takes the
// operands k-major, group g's columns from 128 x sf_start[g], zero past its
// depth, so no 128-column box crosses a group: dgt_k_major_relayout
// (relayout.cuh) makes them from the TN operands in one transposing gather
// (each byte read once and written once; JAX's wrapper transposes its
// operands too, deepgemm_tpu/kernels/k_grouped.py:438-440). The flat entry
// takes the NT form of the JAX op (deepgemm_tpu/ops/k_grouped.py:66-96):
// each group's A and B segments stored k-major and flattened, a [m x k_g] at element m * k_start[g] and b [n x
// k_g] at n * k_start[g], read in place through a tensor map per group
// (built here from the host's depths and copied to device memory: 2 G maps
// exceed a launch's parameter space). TMA zero-fills a box past the depth,
// so both entries put the same bytes in every stage: bitwise equal.
//
// bf16 runs the mma.sync mainloop of gemm_mainloop.cuh over the wrapper's
// k-major copy (each group at a 16-element aligned column), one grid slice
// per group.

#include <vector>

#include "gemm_mainloop.cuh"
#include "gemm_sm90.cuh"
#include "relayout.cuh"

// x [rows, dim] bytes (one-byte elements), src [ldk] int32 (the source row
// of each output column, -1 for a zero column), dst [dim, ldk] bytes; ldk %
// 16 == 0. Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_k_major_relayout(const void* x, const void* src, void* dst, int dim,
                                    long long ldk, void* stream) {
    return dgt::launch_k_major_relayout(x, src, dst, dim, ldk, stream);
}

// a [m, ldk], b [n, ldk] k-major e4m3 (ldk = 128 nsf, group g at column
// 128 sf_start[g]), sfa [nsf, sfa_ld] f32 and sfb [nsf, sfb_ld] f32 k-first
// (sfa_ld = m and sfb_ld = n rounded up to 4; the pad is never used),
// compacted per group, k_size and sf_start [G] int32 on the device, c [G, m, n] f32 or
// null, d [G, m, n] f32 when out_f32 else bf16; n even. block_m, num_stages
// and num_sms from heuristics/configs.py:get_sm90_config. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int dgt_k_grouped_fp8_gemm(const void* a, const void* b, const void* sfa,
                                      const void* sfb, const void* c, const void* k_size,
                                      const void* sf_start, void* d, int num_groups, int m, int n,
                                      long long ldk, int sfa_ld, int sfb_ld, int block_m,
                                      int num_stages, int num_sms, int out_f32, void* stream) {
    using namespace dgt::sm90;
    CUtensorMap map_a, map_b;
    if (!make_map(&map_a, a, ldk, m, ldk, block_m) || !make_map(&map_b, b, ldk, n, ldk, kDenseBN))
        return static_cast<int>(cudaErrorInvalidValue);
    Args p = {};
    p.sfa = static_cast<const float*>(sfa);
    p.sfb = static_cast<const float*>(sfb);
    p.sfa_ld = sfa_ld;
    p.sfb_ld = sfb_ld;
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.num_groups = num_groups;
    p.num_stages = num_stages;
    p.k_size = static_cast<const int*>(k_size);
    p.sf_start = static_cast<const int*>(sf_start);
    return static_cast<int>(launch_any<Kind::kKGrouped, BForm::kChannelScaled>(
        map_a, map_b, p, block_m, out_f32, num_sms, static_cast<cudaStream_t>(stream)));
}

// The flat NT form, e4m3: a, b flattened per group as above; ks [G] the
// depths on the host (each a multiple of 16), k_size and sf_start [G] int32
// on the device, maps 2 G x 128 bytes of device memory (64-byte aligned) for
// the groups' tensor maps; sfa [nsf, sfa_ld], sfb [nsf, sfb_ld], c and d as
// dgt_k_grouped_fp8_gemm. Returns the cudaError_t (0 = success).
extern "C" int dgt_k_grouped_fp8_gemm_flat(const void* a, const void* b, const void* sfa,
                                           const void* sfb, const void* c, const int* ks,
                                           const void* k_size, const void* sf_start, void* maps,
                                           void* d, int num_groups, int m, int n, int sfa_ld,
                                           int sfb_ld, int block_m, int num_stages, int num_sms,
                                           int out_f32, void* stream) {
    using namespace dgt::sm90;
    std::vector<CUtensorMap> host(2 * static_cast<size_t>(num_groups));
    const uint8_t* a8 = static_cast<const uint8_t*>(a);
    const uint8_t* b8 = static_cast<const uint8_t*>(b);
    long long k0 = 0;
    for (int g = 0; g < num_groups; ++g) {
        const long long kg = ks[g];
        if (kg > 0 && (!make_map(&host[2 * g], a8 + k0 * m, kg, m, kg, block_m) ||
                       !make_map(&host[2 * g + 1], b8 + k0 * n, kg, n, kg, kDenseBN)))
            return static_cast<int>(cudaErrorInvalidValue);
        k0 += kg;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemcpyAsync(maps, host.data(), host.size() * sizeof(CUtensorMap),
                                      cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    Args p = {};
    p.sfa = static_cast<const float*>(sfa);
    p.sfb = static_cast<const float*>(sfb);
    p.sfa_ld = sfa_ld;
    p.sfb_ld = sfb_ld;
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.num_groups = num_groups;
    p.num_stages = num_stages;
    p.k_size = static_cast<const int*>(k_size);
    p.sf_start = static_cast<const int*>(sf_start);
    p.group_maps = static_cast<const CUtensorMap*>(maps);
    const CUtensorMap unused = {};
    return static_cast<int>(launch_any<Kind::kKGroupedFlat, BForm::kChannelScaled>(
        unused, unused, p, block_m, out_f32, num_sms, s));
}

// bf16: a [m, ldk], b [n, ldk] k-major, group g covering columns
// [k_start[g], k_start[g] + k_size[g]) (16-element aligned; k_start, k_size
// [G] int32 on the device), c [G, m, n] f32 or null, d [G, m, n] f32 when
// out_f32 else bf16. Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_k_grouped_bf16_gemm(const void* a, const void* b, const void* c,
                                       const void* k_start, const void* k_size, void* d,
                                       int num_groups, int m, int n, long long ldk, int out_f32,
                                       int block_n, void* stream) {
    dgt::GemmArgs p = {};
    p.a = static_cast<const uint8_t*>(a);
    p.b = static_cast<const uint8_t*>(b);
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.ldk = ldk;
    p.k_start = static_cast<const int*>(k_start);
    p.k_size = static_cast<const int*>(k_size);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        out_f32 ? dgt::launch_gemm_bn<float>(p, num_groups, block_n, s)
                : dgt::launch_gemm_bn<__nv_bfloat16>(p, num_groups, block_n, s);
    return static_cast<int>(err);
}
