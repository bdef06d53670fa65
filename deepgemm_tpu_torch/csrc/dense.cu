// Dense FP8 GEMM with f32 scales (the 'promote' strategy):
//   d[m, n] = sum over 128-deep k blocks s of (a_s . b_s^T)[m, n] * sfa[m, s] * sfb[s, n]  (+ c[m, n])
// Replaces deepgemm_tpu/kernels/dense.py:_build_dense_gemm (pl.pallas_call at
// dense.py:291) for e4m3 operands under 'promote', NT: C added once to the
// finished f32 sum (dense.py:267-276), a bf16 or an f32 output, B's scales
// per 128 rows or per row, and planar FP4 B decoded to e4m3 in the kernel
// (decode_fp4_planar_block, dense.py:142-163; bitwise the e4m3 kernel on the
// decoded codes with per-row scales). The MN-major layouts run this kernel
// on a k-major copy (dgt_k_major_relayout, relayout.cuh), so each is
// bitwise NT. The
// 'dequant' strategy and the folded FP4 operands are in dense_dequant.cu.
// The mainloop and its notes are in gemm_sm90.cuh; this file is the C entry
// point, bound with ctypes.

#include "gemm_sm90.cuh"
#include "relayout.cuh"

// The MN-major operand's k-major copy: x [k, rows] e4m3 bytes, src [rows]
// int32 (the identity), dst [rows, k]; rows % 16 == 0 (see relayout.cuh).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_k_major_relayout(const void* x, const void* src, void* dst, int dim,
                                    long long ldk, void* stream) {
    return dgt::launch_k_major_relayout(x, src, dst, dim, ldk, stream);
}

// a [m, k] e4m3, b [n, k] e4m3 (planar FP4 int8 [n, k/2] when fp4_b, k % 256
// == 0), sfa [m, ksf] f32 and sfb [nsf, ksf] f32 (ksf = ceil(k/128), nsf =
// ceil(n / gran_n), gran_n = 1 << sfb_shift), scratch ksf * (sfa_ld + sfb_ld)
// f32 for their k-first copies (sfa_ld and sfb_ld: m and nsf rounded up to
// 4), c [m, n] f32 or null, d [m, n] f32 when out_f32 else bf16; k % 16 ==
// 0, n even. block_m (64 or 128), num_stages and num_sms (the persistent
// grid's size) from the tile chooser (heuristics/configs.py:
// get_sm90_config). Returns the cudaError_t of the launches (0 = success).
extern "C" int dgt_dense_fp8_gemm(const void* a, const void* b, const void* sfa,
                                  const void* sfb, void* scratch, const void* c, void* d, int m,
                                  int n, int k, int sfa_ld, int sfb_ld, int sfb_shift,
                                  int block_m, int num_stages, int num_sms, int out_f32,
                                  int fp4_b, void* stream) {
    using namespace dgt::sm90;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ksf = (k + kBK - 1) / kBK;
    const int nsf = ((n - 1) >> sfb_shift) + 1;
    cudaError_t err = launch_k_first(sfa, sfb, scratch, m, nsf, ksf, sfa_ld, sfb_ld, 1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* sfa_k = static_cast<const float*>(scratch);
    const float* sfb_k = sfa_k + static_cast<int64_t>(ksf) * sfa_ld;
    const uint64_t b_row = fp4_b ? static_cast<uint64_t>(k) / 2 : static_cast<uint64_t>(k);
    CUtensorMap map_a, map_b;
    if (!make_map(&map_a, a, k, m, k, block_m) || !make_map(&map_b, b, b_row, n, b_row, kDenseBN))
        return static_cast<int>(cudaErrorInvalidValue);
    Args p = {};
    p.sfa = sfa_k;
    p.sfb = sfb_k;
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.sfa_ld = sfa_ld;
    p.sfb_ld = sfb_ld;
    p.num_kb = (k + kBK - 1) / kBK;
    p.sfb_shift = sfb_shift;
    p.num_groups = 1;
    p.num_stages = num_stages;
    constexpr Kind kDense = Kind::kDense;
    if (fp4_b) {
        if (sfb_shift != 0) return static_cast<int>(cudaErrorInvalidValue);
        err = launch_any<kDense, BForm::kPlanarFp4>(map_a, map_b, p, block_m, out_f32, num_sms, s);
    } else if (sfb_shift >= 7) {
        err = launch_any<kDense, BForm::kBlockScaled>(map_a, map_b, p, block_m, out_f32, num_sms, s);
    } else {
        err = launch_any<kDense, BForm::kChannelScaled>(map_a, map_b, p, block_m, out_f32, num_sms,
                                                        s);
    }
    return static_cast<int>(err);
}
